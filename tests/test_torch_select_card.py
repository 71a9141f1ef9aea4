"""The clustering's input-selection kernel (csrc/select.cu,
``select_keep``, kernel 14) on the card against its plain version
(ops/select_kernels.keep_plain, the same torch ops on the card and on the
CPU): the same keep mask, bit for bit, over every chunk at both benchmark
cells' shapes, at ragged point counts, for one to nine window frames
(past 256 keys a chunk takes two launches); the chunk selection's four
outputs on the card equal to the CPU's; and, through
``spatial_clustering``, one launch and no host sync a chunk in
``cluster.select``.

The kernel has no CPU mode, so every test here needs a card and skips
without one. On the card, without the JAX package (this file imports none
of it):

    python3 -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_select_card.py
"""
import pytest
import torch

from vilgod_tpu_torch.ops import select_kernels as SK
from vilgod_tpu_torch.pipeline import stages_geometry as TS
from vilgod_tpu_torch.tools.scenes import SELECT_SHAPES, select_masks

pytestmark = pytest.mark.card


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _same(masks, seed, f0, chunk, nfw, f_real, cpu=False):
    """Kernel and plain version on the card (and with ``cpu`` the plain
    version on the CPU): equal keep masks; returns the kernel's."""
    keys = SK.page_keys(seed, f0, chunk, nfw)
    got = SK.select_keep(keys, *masks, f0, nfw, f_real)
    plain = SK.keep_plain(keys, *masks, f0, nfw, f_real)
    torch.cuda.synchronize()
    bad = (got != plain).sum(dim=1)
    assert not bad.any(), (f"pages {bad.nonzero().flatten().tolist()} "
                           f"differ (f0 {f0}, nfw {nfw})")
    if cpu:
        assert torch.equal(got.cpu(), SK.keep_plain(
            keys, *(m.cpu() for m in masks), f0, nfw, f_real))
    return got


@pytest.mark.parametrize("cell", sorted(SELECT_SHAPES))
def test_kernel_equals_plain_at_the_cells_shapes(card, cell):
    """Every chunk of a sequence at the cell's shapes (the last anchored
    at the bucket's end, its windows clamped at the real frames), one
    launch a chunk; the first chunk also against the CPU."""
    f_pad, f_real, n = SELECT_SHAPES[cell]
    masks = [m.to(card) for m in select_masks(f_pad, n, seed=n)]
    SK.reset_launches()
    starts = TS.chunk_starts(f_pad, TS.CHUNK_PAGES)
    for f0 in starts:
        keep = _same(masks, 3300000031, f0, TS.CHUNK_PAGES, 2, f_real,
                     cpu=f0 == 0)
        assert keep.any(dim=1).all()
    assert SK.LAUNCHES["select_keep"] == len(starts)


@pytest.mark.parametrize("n", [1, 255, 257, 4097, 40961])
@pytest.mark.parametrize("nfw", [1, 2, 3, 9])
def test_kernel_ragged_counts_and_windows(card, n, nfw):
    """Point counts no block divides, windows of one to nine frames over a
    short sequence (windows clamped at its end, pages past it), and 32
    pages of nine frames: 288 keys, two launches."""
    frames = 40
    masks = [m.to(card) for m in select_masks(frames, n, seed=nfw)]
    SK.reset_launches()
    _same(masks, 17, 8, 32, nfw, 37, cpu=n * nfw <= 40961)
    assert SK.LAUNCHES["select_keep"] == (2 if nfw == 9 else 1)


def test_chunk_selection_card_equals_cpu(card):
    """select_cluster_input's four outputs for a chunk of 32 pages from
    frame 8 of 40 (37 real: the last windows clamp), on the card and on
    the CPU, equal in every slot, over synthetic statistics."""
    f_pad, f_real, n = 40, 37, 8192
    g = torch.Generator().manual_seed(3)
    xyz = (torch.rand((f_pad, n, 3), generator=g) * 40 - 20)
    xyz = torch.round(xyz / 0.005) * 0.005
    ent = torch.rand((f_pad, n), generator=g)
    mask, has_nbr, dense, moving = select_masks(f_pad, n, seed=4)
    stats = (has_nbr, dense, moving)
    args = (xyz, mask, ent, f_real, 8, 32, 666)
    cpu = TS.select_cluster_input(*args, stats, 2, n)
    on_card = TS.select_cluster_input(
        *(a.to(card) if torch.is_tensor(a) else a for a in args),
        tuple(s.to(card) for s in stats), 2, n)
    for a, b in zip(cpu, on_card):
        assert torch.equal(a, b.cpu())


def test_one_launch_and_no_sync_a_chunk_in_spatial_clustering(card):
    """Stages 1-3 over 40 frames on the card (two chunks of 32 pages):
    ``select_keep`` launched once a chunk, the counter ``select_draws``
    one a chunk, no host sync in ``cluster.select``, and in
    ``cluster.stats`` at most one overflow read a tier, count and group."""
    from vilgod_tpu_torch.config import waymo_config
    from vilgod_tpu_torch.data import SyntheticDataset
    from vilgod_tpu_torch.pipeline.runner import ZeroShotDetector
    from vilgod_tpu_torch.utils import trace

    caps = {"max_points": 16384, "max_ng_points": 8192, "max_clusters": 64,
            "max_cluster_points": 1024, "max_tracks": 64,
            "max_cluster_input": 8192, "clip_batch": 8}
    cfg = waymo_config(capacity=caps, pipeline_active=[
        "mask_ground_points", "calculate_entropy_scores"])
    seq = SyntheticDataset(n_sequences=1, n_frames=40, seed=12,
                           n_ground=3000, n_vehicles=3, n_pedestrians=2,
                           n_moving=2).sequence("synth_0")
    zsd = ZeroShotDetector(seq, "synth_0", cfg, device=card)
    zsd.process()
    SK.reset_launches()
    with trace.recording(device=card) as t:
        TS.spatial_clustering(zsd.state, cfg)
    chunks = len(TS.chunk_starts(40, TS.CHUNK_PAGES))
    by_span = t.counters_by_span()
    assert SK.LAUNCHES["select_keep"] == chunks == 2
    assert by_span["cluster.select"]["select_draws"] == chunks
    assert by_span["cluster.select"].get("syncs", 0) == 0
    assert by_span.get("cluster.stats", {}).get("syncs", 0) <= 2 * 2 * 2
