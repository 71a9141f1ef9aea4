"""The ground scan's CUDA graph (ground/patchwork.py ``_StepGraph``) on the
card against the eager scan, the same step called from Python frame by
frame (``_eager_steps``): masks and final state equal bit for bit at 24
frames, at ``waymo.urban``'s 200 frames of 155648 points and with 3
chains; the masks equal the CPU scan's; a second scan through the same graph starts from the initial
state; ``ground.scan`` counts one capture for a new shape and none after,
a replay a step and no host sync.

The graph exists only on a CUDA device, so every test here needs a card
and skips without one. On the card, without the JAX package (this file
imports none of it):

    python3 -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_ground_card.py
"""
import pytest
import torch

from vilgod_tpu_torch.config import waymo_config
from vilgod_tpu_torch.ground import patchwork as tpw
from vilgod_tpu_torch.tools.scenes import ground_cloud
from vilgod_tpu_torch.utils import trace

pytestmark = pytest.mark.card

N = 155648              # waymo.urban's points bucket
N_VALID = 153172        # its most points in a frame


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA graph has no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def cfg():
    return tpw.ground_config_from_cfg(waymo_config(), min_range=1.5)


def _frames(f: int, seed: int, dev):
    """f sensor-frame clouds of N slots, the valid count varying."""
    pts, mask = zip(*(ground_cloud(N, N_VALID - 997 * (i % 5), seed=seed + i)
                      for i in range(f)))
    return torch.stack(pts).to(dev), torch.stack(mask).to(dev)


def _eager(points, mask, presorted, cfg, chains):
    """``_scan_presorted`` with its steps called from Python."""
    f, n = mask.shape
    steps = f // chains
    pre = [x.reshape(chains, steps, *x.shape[1:])
           for x in (points, mask, *presorted)]
    ground = torch.empty((chains, steps, n), dtype=torch.bool,
                         device=points.device)
    state = tpw._eager_steps(pre, ground, cfg,
                             tpw._step_consts(cfg, points.device, chains))
    return ground.reshape(f, n), state


def _same(a, b):
    (ga, sa), (gb, sb) = a, b
    rows = (ga != gb).any(dim=1)
    assert not rows.any(), f"frames {rows.nonzero().flatten()[:8].tolist()} differ"
    for name, x, y in zip(tpw.GroundState._fields, sa, sb):
        assert x.device == y.device and torch.equal(x, y), name


@pytest.mark.parametrize("frames,chains", [(24, 1), (200, 1), (24, 3)])
def test_graph_scan_equals_eager_scan(card, cfg, frames, chains):
    points, mask = _frames(frames, 2000, card)
    pre = tpw._presort_frames(points, mask, cfg)
    graph = tpw._scan_presorted(points, mask, pre, cfg, chains)
    eager = _eager(points, mask, pre, cfg, chains)
    _same(graph, eager)
    assert graph[0].sum() > 0.5 * mask.sum()     # ground was found


def test_graph_scan_equals_cpu_scan(card, cfg):
    """The card's replays against the CPU's eager scan: masks, counts,
    sensor height and elevations equal; the flatness values and their
    thresholds within 1e-2 relative (1.1e-3 and 2.4e-5 the most seen):
    flatness is the covariance's smallest eigenvalue, a difference of
    near-equal terms of ``acos`` and ``cos``, whose last bits differ
    between CUDA and the CPU."""
    points, mask = _frames(24, 3000, card)
    ground, state = tpw._scan_presorted(
        points, mask, tpw._presort_frames(points, mask, cfg), cfg, 1)
    p, m = points.cpu(), mask.cpu()
    g_cpu, s_cpu = tpw._scan_presorted(p, m, tpw._presort_frames(p, m, cfg),
                                       cfg, 1)
    assert torch.equal(ground.cpu(), g_cpu)
    for name, x, y in zip(tpw.GroundState._fields, state, s_cpu):
        if name in ("flat_buf", "flatness_thr"):
            torch.testing.assert_close(x.cpu(), y, rtol=1e-2, atol=0,
                                       msg=name)
        else:
            assert torch.equal(x.cpu(), y), name


def test_second_scan_starts_from_initial_state(card, cfg):
    """Two sequences through one graph: the second's masks and state equal
    its eager scan's (a fresh process's), and the first's returned state
    is its own copy, untouched by the second scan."""
    first, second = _frames(24, 4000, card), _frames(24, 5000, card)
    pre1 = tpw._presort_frames(*first, cfg)
    pre2 = tpw._presort_frames(*second, cfg)
    g1 = tpw._scan_presorted(*first, pre1, cfg, 1)
    g2 = tpw._scan_presorted(*second, pre2, cfg, 1)
    _same(g2, _eager(*second, pre2, cfg, 1))
    _same(g1, _eager(*first, pre1, cfg, 1))


def test_scan_counters(card, cfg):
    """Under the span recorder: ``ground.scan`` counts one graph capture
    at the first scan of a shape and none at the next, a replay a step,
    and no host sync (a sync outside the scan is counted, so the
    recorder sees them)."""
    points, mask = _frames(16, 6000, card)
    points, mask = points[:, :N - 8192], mask[:, :N - 8192]   # a new shape
    pre = tpw._presort_frames(points, mask, cfg)
    with trace.recording(device=card) as t:
        for name in ("first", "second"):
            with trace.span(name):
                tpw._scan_presorted(points, mask, pre, cfg, 1)
        with trace.span("control"):
            mask.sum().item()
    scans = [s for s in t.spans if s.name == "ground.scan"]
    assert [s.counters for s in scans] == [
        {"graph_captures": 1, "graph_replays": 16, "steps": 16},
        {"graph_captures": 0, "graph_replays": 16, "steps": 16}]
    control = [s for s in t.spans if s.name == "control"][0]
    assert control.counters.get("syncs", 0) >= 1
