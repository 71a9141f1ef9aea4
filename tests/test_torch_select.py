"""The clustering stage's batched input selection on the CPU: the chunk
selection (``stages_geometry.select_cluster_input``, its keep mask from
``ops/select_kernels.keep_plain``) against the JAX package's per-frame
``select_cluster_input`` under ``vmap``, bit for bit in every slot; the
host-integer ``fold_in`` chain against ``jax.random.fold_in``; the paged
selection statistics against per-frame ``radius_count_self`` counts."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vilgod_tpu.pipeline import stages_geometry as JS
from vilgod_tpu_torch.ops import random as R
from vilgod_tpu_torch.ops import select_kernels as SK
from vilgod_tpu_torch.ops.neighbors import (radius_count_self,
                                            radius_count_self_paged)
from vilgod_tpu_torch.pipeline import stages_geometry as TS


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per pytest worker (see test_torch_random.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(frames, n, occupied, seed=3, blobs=6, spread=12.0):
    """Non-ground buffers: per frame ``blobs`` blobs (5 cm noise, so most
    points have neighbours) plus uniform clutter, on the 5 mm lattice,
    ``occupied`` rows of ``n``; entropy uniform on [0, 1) (60 % moving)."""
    rng = np.random.default_rng(seed)
    xyz = np.zeros((frames, n, 3), np.float32)
    m = np.zeros((frames, n), bool)
    per = occupied // (2 * blobs)
    for f in range(frames):
        pts = [rng.uniform(-spread, spread, 3) * (1, 1, 0.1)
               + rng.normal(0, 0.05, (per, 3)) for _ in range(blobs)]
        pts.append(rng.uniform(-spread, spread, (occupied - blobs * per, 3)))
        pts = np.concatenate(pts)
        xyz[f, :occupied] = np.round(pts / 0.005) * 0.005
        m[f, :occupied] = True
    ent = rng.uniform(0, 1, (frames, n)).astype(np.float32)
    return xyz, m, ent


# ---------------------------------------------------------------------------
# the keys
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 666, 2 ** 31 - 1])
def test_fold_in_chain_on_host_integers_equals_jax(seed):
    """PRNGKey, fold_in(fnr) once a page, fold_in(rel): Python integers,
    each key equal to jax's; ``page_keys`` lays them out page-major."""
    kt = R.PRNGKey(seed)
    assert all(type(w) is int for w in kt)
    keys = SK.page_keys(seed, 196, 4, 3)
    for i, fnr in enumerate((196, 197, 198, 199)):
        kj_page = jax.random.fold_in(jax.random.PRNGKey(seed), fnr)
        kt_page = R.fold_in(kt, fnr)
        assert tuple(np.asarray(kj_page).tolist()) == kt_page
        for rel in range(3):
            want = tuple(np.asarray(jax.random.fold_in(kj_page, rel)).tolist())
            got = R.fold_in(kt_page, rel)
            assert all(type(w) is int for w in got)
            assert got == want == keys[3 * i + rel]


# ---------------------------------------------------------------------------
# the chunk selection against JAX
# ---------------------------------------------------------------------------

FRAMES, N = 8, 4096
CASES = {
    # nfw, f_real, f0, chunk, cap_in
    "nfw1-cap-cut": (1, 8, 0, 4, 1024),   # more kept points than cap_in
    "nfw2": (2, 8, 2, 4, 4096),
    "nfw3": (3, 8, 0, 8, 4096),
    "padded-tail": (2, 6, 4, 4, 4096),    # pages 6, 7 past f_real
    "clamped-nfw3": (3, 6, 2, 6, 8192),   # windows clamp at f_real - 3
}


@pytest.fixture(scope="module")
def scene():
    return _scene(FRAMES, N, 3600)


@pytest.mark.parametrize("case", sorted(CASES))
def test_chunk_selection_equals_jax_vmap(scene, case):
    """All four outputs equal JAX's per-frame selection under vmap in every
    slot, kept, filler and past-the-kept slots alike."""
    nfw, f_real, f0, chunk, cap_in = CASES[case]
    xyz, m, ent = scene
    fv = np.arange(FRAMES) < f_real
    jargs = tuple(map(jnp.asarray, (xyz, m, ent, fv)))
    jstats = JS.frame_select_stats_all(*jargs)
    want = jax.vmap(lambda i: JS.select_cluster_input(
        *jargs, f0 + i, 666, jstats, nfw, cap_in))(jnp.arange(chunk))
    targs = tuple(map(torch.from_numpy, (xyz, m, ent)))
    stats = TS.frame_select_stats_all(*targs, f_real)
    for a, b in zip(jstats, stats):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    got = TS.select_cluster_input(*targs, f_real, f0, chunk, 666, stats, nfw,
                                  cap_in)
    names = ("features", "mask", "src_frame", "src_index")
    for a, b, name in zip(want, got, names):
        a = np.asarray(a)
        assert a.shape == tuple(b.shape) and a.dtype == b.numpy().dtype, name
        if name == "features":
            np.testing.assert_array_equal(a.view(np.uint32),
                                          b.numpy().view(np.uint32), name)
        else:
            np.testing.assert_array_equal(a, b.numpy(), name)
    kept = got[1].sum(dim=1)
    assert (kept > 0).any()
    if case == "nfw1-cap-cut":
        keep = SK.keep_plain(SK.page_keys(666, f0, chunk, nfw),
                             targs[1], *stats, f0, nfw, f_real)
        assert (keep.sum(dim=1) > cap_in).all()


def test_keep_rule_reads_the_draw_only_where_it_decides(scene):
    """The draw decides only points with a neighbour that are not moving:
    the moving ones keep exactly the dense ones, the others none."""
    xyz, m, ent = scene
    targs = tuple(map(torch.from_numpy, (xyz, m, ent)))
    has_nbr, dense, em = TS.frame_select_stats_all(*targs, FRAMES)
    keep = SK.keep_plain(SK.page_keys(9, 0, 2, 1), targs[1], has_nbr, dense,
                         em, 0, 1, FRAMES).reshape(2, N)
    mask = targs[1][:2]
    assert torch.equal(keep & em[:2], dense[:2] & em[:2])
    assert not (keep & ~mask).any()
    assert not (keep & ~em[:2] & ~has_nbr[:2]).any()
    assert torch.equal(keep & ~em[:2] & has_nbr[:2], mask & ~em[:2]
                       & has_nbr[:2])         # nfw 1: the draw keeps all


# ---------------------------------------------------------------------------
# the paged statistics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2048, 3000, 8192])
@pytest.mark.parametrize("radius,max_count", [(0.2, 100), (0.1 ** 0.5, 4)])
def test_paged_self_count_equals_each_page_alone(n, radius, max_count):
    """Pages of the same cloud (isolation: a count across pages would
    double), a cloud whose extent passes the 1024 m grid, an empty page
    and ragged page sizes (3000 pads to whole tiles)."""
    xyz, m, _ = _scene(2, n, n * 7 // 8, seed=n, spread=8.0)
    far = xyz[1] * np.float32(300.0)
    pts = torch.from_numpy(np.stack([xyz[0], xyz[0], far, xyz[1], xyz[1]]))
    mask = torch.from_numpy(np.stack([m[0], m[0], m[1], np.zeros_like(m[1]),
                                      m[1]]))
    got = radius_count_self_paged(pts, mask, radius, max_count=max_count)
    assert got.shape == mask.shape and got.dtype == torch.int32
    for p in range(pts.shape[0]):
        want = radius_count_self(pts[p], mask[p], radius, max_count=max_count)
        assert torch.equal(got[p], want), p
    assert (got[0] > 0).any() and not got[3].any()


def test_paged_stats_equal_per_frame_counts():
    """frame_select_stats_all over 35 real frames of 37 (a group of 32 and
    a last one of 3) against each frame's own counts; the padded frames
    all False."""
    frames, f_real, n = 37, 35, 2048
    xyz, m, ent = map(torch.from_numpy, _scene(frames, n, 1800, seed=35))
    got = TS.frame_select_stats_all(xyz, m, ent, f_real)
    for f in range(frames):
        mf = m[f] & (f < f_real)
        em = mf & (ent[f] < 0.6)
        want = (radius_count_self(xyz[f], mf, 0.2, max_count=100) >= 1,
                radius_count_self(xyz[f], em, float(np.sqrt(0.1)),
                                  max_count=4) >= 2, em)
        for a, b in zip(got, want):
            assert torch.equal(a[f], b), f
    assert got[0][:f_real].any() and got[1][:f_real].any()
    assert not any(s[f_real:].any() for s in got)


def test_window_origins_equal_each_page_alone(scene):
    """The batched window corners equal each page's per-frame minima."""
    xyz, m, _ = map(torch.from_numpy, scene)
    f_real, f0, chunk, nfw = 6, 2, 6, 3
    got = TS.window_origins(xyz, m, f_real, f0, chunk, nfw)
    for i in range(chunk):
        lo = min(max(f0 + i, 0), max(f_real - nfw, 0))
        pts = torch.cat([xyz[f][m[f]] for f in range(lo, lo + nfw)])
        mn = pts[:, :2].amin(dim=0)
        want = (torch.floor(mn / TS.CELL) - 1.0) * TS.CELL
        assert torch.equal(got[i], want), i
