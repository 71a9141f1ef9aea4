"""The port's ``ops/banded.banded_scan`` and its debug tools
``tools/debug_ground_scale`` and ``tools/debug_cluster_stepwise`` at a
small size on the CPU, held against the JAX package's library functions
on the same numpy inputs; each tool's ``main`` with ``--device cpu``.
(``debug_band_width``, ``debug_soak_cluster`` and ``debug_cluster_crash``
are in the test_torch_debug_*.py files beside this one.)"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from vilgod_tpu.ground.patchwork import GroundConfig as JaxGroundConfig
from vilgod_tpu.ground.patchwork import segment_sequence as jax_segment_sequence
from vilgod_tpu.ops import banded as jb
from vilgod_tpu.pipeline import stages_geometry as jsg
from vilgod_tpu_torch.ops import banded as tb
from vilgod_tpu_torch.ops import kernels as tk
from vilgod_tpu_torch.tools import debug_cluster_stepwise, debug_ground_scale

# a few thousand points a frame of a small scene
SMALL_SCENE = dict(n_ground=3000, n_vehicles=2, n_pedestrians=1,
                   n_moving=1, area=50.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per pytest worker (see test_torch_slice.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_banded_scan_matches_jax():
    """A tuple-valued ``inner`` (each block's nearest window point and its
    global rank, and a count) over blocks whose window starts include 0
    and the last legal start: equal to JAX's ``banded_scan``. The points
    are integers, so every squared distance is exact on both sides."""
    rng = np.random.default_rng(3)
    q = rng.integers(-40, 40, (8, 2048)).astype(np.float32)
    d = rng.integers(-40, 40, (8, 3000)).astype(np.float32)
    starts = np.array([0, 500, 952, 137], np.int32)

    def inner_j(qb, db, start):
        d2 = jb._dist2_t8(qb, db, 3)
        return (jnp.min(d2, axis=1),
                (jnp.argmin(d2, axis=1) + start).astype(jnp.int32),
                jnp.sum(d2 <= 50.0, axis=1).astype(jnp.int32))

    def inner_t(qb, db, start):
        d2 = tk._dist2_t8(qb, db, 3)
        best, arg = d2.min(dim=1)
        return (best, (arg + start).to(torch.int32),
                (d2 <= 50.0).sum(dim=1, dtype=torch.int32))

    want = jb.banded_scan(jnp.asarray(q), jnp.asarray(d), jnp.asarray(starts),
                          512, 2048, inner_j)
    got = tb.banded_scan(torch.from_numpy(q), torch.from_numpy(d),
                         torch.from_numpy(starts), 512, 2048, inner_t)
    assert isinstance(got, tuple) and len(got) == 3
    for g, w in zip(got, want):
        assert g.shape == (2048,)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_banded_scan_walks_the_plain_versions_blocks():
    """``banded_scan`` and the plain versions walk the same windows: a count
    through ``banded_scan`` equals ``count_plain`` without ends."""
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.integers(-20, 20, (8, 1024)).astype(np.float32))
    d = torch.from_numpy(rng.integers(-20, 20, (8, 4096)).astype(np.float32))
    starts = torch.tensor([0, 4000], dtype=torch.int32)  # 4000 clamps
    got = tb.banded_scan(q, d, starts, 512, 1024, lambda qb, db, _: {
        "n": (tk._dist2_t8(qb, db, 3) <= 30.0).sum(dim=1,
                                                   dtype=torch.int32)})
    np.testing.assert_array_equal(
        got["n"].numpy(),
        tk.count_plain(q, d, starts, 30.0, 512, 1024, 3).numpy())


def test_debug_ground_scale_matches_jax_segment_sequence():
    """The fused run's masks at f_pad 4 and 8 equal JAX's
    ``segment_sequence`` on the same frames (the tool also holds its
    scan-alone masks to them), and the 4-frame run's the first 4 frames
    of the 8-frame run's."""
    pts, msk = debug_ground_scale.scene_frames(8, 4096, SMALL_SCENE)
    assert msk.all(axis=1).all()            # every frame fills its bucket
    rows, masks = debug_ground_scale.run((4, 8), 4096, "cpu", SMALL_SCENE)
    assert [r["f_pad"] for r in rows] == [4, 8]
    for fp in (4, 8):
        want, _ = jax_segment_sequence(jnp.asarray(pts[:fp]),
                                       jnp.asarray(msk[:fp]),
                                       JaxGroundConfig(), 1.723)
        got = masks[fp].numpy()
        np.testing.assert_array_equal(got, np.asarray(want))
        assert got.sum() > 1000
    np.testing.assert_array_equal(masks[4].numpy(), masks[8][:4].numpy())
    assert all(r[k] > 0 for r in rows for k in r if k.endswith("_s"))


@pytest.mark.parametrize("n_ng", [2048, 4096])
def test_debug_cluster_stepwise_matches_jax(n_ng):
    """det_n of each chunk equals JAX's ``cluster_frames_chunk`` on the
    tool's own buffers (8 frames; at 4096 points a frame the blobs
    cluster)."""
    out = debug_cluster_stepwise.run(8, n_ng, device="cpu")
    assert [s[0] for s in out["steps"]] == [
        "upload", "frame_select_stats_all", "cluster_frames_chunk f0=0",
        "concat 6 outputs", "pack + download"]
    args = tuple(map(jnp.asarray, debug_cluster_stepwise.make_buffers(8,
                                                                      n_ng)))
    stats = jsg.frame_select_stats_all(*args)
    want = jsg.cluster_frames_chunk(*args, stats, 0, 666, chunk=8,
                                    cap_in=n_ng,
                                    **debug_cluster_stepwise.CHUNK_KW)[2]
    assert len(out["det_n"]) == 1
    np.testing.assert_array_equal(out["det_n"][0].numpy(), np.asarray(want))
    assert out["det_n_total"] == int(np.asarray(want).sum())
    if n_ng == 4096:
        assert out["det_n_total"] > 0


@pytest.mark.parametrize("tool, argv", [
    (debug_ground_scale, ["--fpads", "2", "--points", "4096"]),
    (debug_cluster_stepwise, ["--frames", "8", "--n-ng", "2048", "--async",
                              "--ballast", "0.001"]),
])
def test_main_on_the_cpu(tool, argv, capsys):
    assert tool.main(argv + ["--device", "cpu"]) == 0
    assert capsys.readouterr().out.splitlines()[0] == "cpu"
