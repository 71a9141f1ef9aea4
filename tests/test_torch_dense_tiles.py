"""The tile decisions of the redesigned dense kernels 6-9
(``tile_radius_count``, ``tile_radius_count3``, ``tile_min_label``,
``tile_nearest``): the torch mirror of their box pre-pass
(``dense_kernels.tile_decisions``, the one ``chip_smoke.py`` phase 4
reads), the core-first order of ``_dbscan_full``'s min-label rounds, the
lane padding of their CUDA wrappers, the routing of plain DBSCAN's counts
through kernel 6, and the build's hash of included headers.

A skipped tile must hold no pair within its threshold (the nearest: none
as near as its query's nearest), a whole tile only pairs within the
levels it takes, and the counts, labels and nearest rebuilt from the
decisions plus the pairs of the other tiles must equal the plain
versions bit for bit, on random clouds, on 5 mm lattice points at and
one ulp off the levels, with sentinel lanes, ties, NaN pad lanes and
ragged sizes."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.experimental import pallas as pl

from vilgod_tpu.ops import cluster as JC
from vilgod_tpu.ops import neighbors as JN
from vilgod_tpu_torch.ops import cluster as TC
from vilgod_tpu_torch.ops import dense_kernels as TK
from vilgod_tpu_torch.ops.kernels import _dist2_t8, prep_t8
from vilgod_tpu_torch.utils.cuda_build import CudaLibrary, source_files

BIG = 2 ** 30
SENT = np.float32(1.0e6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per pytest worker (see test_torch_cluster.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jax_dense(monkeypatch):
    """The JAX package on its dense Pallas branches, interpreted on the
    CPU (as in test_torch_dense.py); its banded branches stay on the XLA
    fallback."""
    from vilgod_tpu.ops import banded as JB

    pallas_call = pl.pallas_call

    def interpreted(*args, **kwargs):
        kwargs["interpret"] = True
        return pallas_call(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", interpreted)
    monkeypatch.setattr(JN, "_use_pallas", lambda: True)
    monkeypatch.setattr(JC, "_use_pallas", lambda: True)
    monkeypatch.setattr(JB, "_use_pallas", lambda: False)
    jax.clear_caches()
    yield
    jax.clear_caches()


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _lattice(x):
    return (np.round(x / 0.005) * 0.005).astype(np.float32)


def _objects(rng, n_obj, per, ndim, spread=20.0, size=(2.0, 1.0, 0.8)):
    """Points in object order: ``n_obj`` boxes of ``per`` points each,
    scattered over ``spread`` m, later coordinates small features."""
    pts = []
    for _ in range(n_obj):
        c = rng.uniform(-spread, spread, ndim)
        ext = np.array(list(size) + [0.2] * (ndim - 3))[:ndim]
        pts.append(c + rng.uniform(-0.5, 0.5, (per, ndim)) * ext)
    return np.concatenate(pts).astype(np.float32)


def _t8(pts, valid=None, pad_to=None, nan_pad=0):
    """(8, N) from points: invalid lanes at the sentinel, ``pad_to`` lanes
    with sentinel lanes after them, then ``nan_pad`` NaN lanes."""
    n = len(pts)
    valid = np.ones(n, bool) if valid is None else valid
    t8 = prep_t8(_t(pts), _t(valid), 1)
    if pad_to is not None and pad_to > n:
        t8 = TK.pad_lanes(t8, pad_to, float(SENT))
        t8[pts.shape[1]:] = 0.0
    if nan_pad:
        t8 = TK.pad_lanes(t8, t8.shape[1] + nan_pad, float("nan"))
    return t8.contiguous()


def _count_cloud(kind, rng):
    """(q_t8, d_t8, ndim, r2) of one kernel-6 call."""
    r2 = np.float32(0.25001)
    if kind == "random-3d":
        q, d = (rng.uniform(-3, 3, (n, 3)).astype(np.float32)
                for n in (1300, 1100))
        q[:600] = rng.normal(0, 0.3, (600, 3))
        return _t8(q), _t8(d), 3, float(r2)
    if kind == "objects-sentinel":
        # the dense entropy layout: objects first, then sentinel lanes
        q = _objects(rng, 6, 300, 3)
        d = q + rng.normal(0, 0.05, q.shape).astype(np.float32)
        return _t8(q, pad_to=2560), _t8(d, pad_to=2560), 3, float(r2)
    if kind == "lattice":
        # tight lattice clumps of side 6 cm (their corner pairs sit
        # exactly on r2) and 6.5 cm (just past it)
        clumps = []
        for k, c in enumerate(_lattice(rng.uniform(-3, 3, (6, 3)))):
            side = np.float32(0.06 if k % 2 == 0 else 0.065)
            corner = np.array([[0, 0, 0], [side] * 3], np.float32)
            clumps.append(c + np.concatenate([corner, _lattice(rng.uniform(
                0, side, (254, 3)))]))
        q = np.concatenate(clumps).astype(np.float32)
        d = np.concatenate([q, _lattice(rng.uniform(-3, 3, (700, 3)))])
        # r2: the largest rounded corner dist2 of the 6 cm clumps
        q_t8 = _t8(q)
        corners = q_t8[:, ::512], q_t8[:, 1::512]
        r2 = float(torch.diagonal(_dist2_t8(*corners, 3)).max())
        return q_t8, _t8(d), 3, r2
    if kind == "nan-pad-ragged":
        q = _objects(rng, 4, 333, 4)
        d = (q[::-1][:1203]
             + rng.normal(0, 0.05, (1203, 4))).astype(np.float32)
        return (_t8(q, nan_pad=7), _t8(d, rng.uniform(size=len(d)) > 0.1,
                                       nan_pad=3), 4, float(r2))
    if kind == "features-6d":
        q = _objects(rng, 5, 270, 6, spread=4.0)
        return _t8(q), _t8(q[::-1]), 6, 0.3
    raise ValueError(kind)


def _min_label_cloud(kind, rng):
    """(pts_t8, radius2, labels, ndim) of one kernel-8 call."""
    ndim = {"core-first-5d": 5, "interleaved-5d": 5, "lattice": 3,
            "nan-pad-ragged": 4, "features-6d": 6}[kind]
    n = {"lattice": 1500, "nan-pad-ragged": 1001}.get(kind, 2300)
    pts = _objects(rng, 8, n // 8 + 1, ndim, spread=3.0)[:n]
    core = rng.uniform(size=n) > 0.15
    r2 = rng.uniform(0.01, 0.09, n).astype(np.float32)
    if kind == "lattice":
        pts = _lattice(pts)
        # the unnudged DBSCAN levels eps, eps*sqrt(2), 2 eps squared
        levels = np.float32([0.15, 0.15 * np.sqrt(2), 0.3])
        r2 = (levels * levels)[rng.integers(0, 3, n)]
    if kind != "interleaved-5d":
        order = np.argsort(~core, kind="stable")
        pts, core, r2 = pts[order], core[order], r2[order]
    t8 = _t8(pts, core, pad_to=2048 if kind == "features-6d" else None)
    m = t8.shape[1]
    r2_t = np.zeros(m, np.float32)
    r2_t[:n] = np.where(core, r2, 0)
    lab = np.full(m, BIG, np.int32)
    lab[:n] = np.where(core, rng.permutation(n) + 5, BIG + rng.integers(0, 3, n))
    r2_t, lab = _t(r2_t), _t(lab)
    if kind == "nan-pad-ragged":
        m4 = -(-m // 4) * 4 + 4
        t8 = TK.pad_lanes(t8, m4, float("nan"))
        r2_t, lab = TK.pad_lanes(r2_t, m4, 0.0), TK.pad_lanes(lab, m4, BIG)
    return t8.contiguous(), r2_t, lab, ndim


def _lane_tiles(plan, n_q, n_d):
    """Each query lane's group and each data lane's chunk."""
    g_of = torch.empty(n_q, dtype=torch.long)
    lanes = plan["q_lanes"]
    rows = torch.arange(lanes.shape[0])[:, None].expand_as(lanes)
    g_of[lanes[lanes >= 0]] = rows[lanes >= 0]
    return g_of, torch.arange(n_d) // TK.BLOCK


def _count3_cloud(kind, rng):
    """(q_t8, d_t8, ndim, levels2) of one kernel-7 call; the levels out of
    order, as nothing in the kernel may assume them sorted."""
    # the unnudged DBSCAN levels 2 eps, eps, eps*sqrt(2) (eps 0.15) squared
    dbscan = np.float32([0.3, 0.15, 0.15 * np.sqrt(2)]) ** 2
    if kind == "lattice":
        # 5 mm lattice clumps of side 6 cm (corner pairs exactly on level
        # 1) and 6.5 cm (corner pairs one ulp past level 2), each with a
        # twin 22 cm along x: a clump and its twin are farther apart than
        # levels 1 and 2; level 0 lies one ulp below the farthest corner
        # pair of the 6.5 cm twins, so their tiles run the pair loop and
        # the 6 cm twins' tiles are whole at level 0 only
        clumps = []
        for k, c in enumerate(_lattice(rng.uniform(-3, 3, (4, 3)))):
            side = np.float32(0.06 if k % 2 == 0 else 0.065)
            corner = np.array([[0, 0, 0], [side] * 3], np.float32)
            pts = np.concatenate([corner, _lattice(rng.uniform(
                0, side, (254, 3)))])
            for off in (0.0, 0.22):
                clumps.append(c + np.float32([off, 0, 0]) + pts)
        q = np.concatenate(clumps).astype(np.float32)
        d = np.concatenate([q, _lattice(rng.uniform(-3, 3, (700, 3)))])
        q_t8 = _t8(q)
        def dist2(i, j):
            return float(_dist2_t8(q_t8[:, i:i + 1], q_t8[:, j:j + 1], 3))

        corners = [dist2(256 * j, 256 * j + 1) for j in range(len(clumps))]
        six = max(c for j, c in enumerate(corners) if (j // 2) % 2 == 0)
        past = min(c for j, c in enumerate(corners) if (j // 2) % 2 == 1)
        twins = min(dist2(512 * k, 512 * k + 257) for k in (1, 3))
        below = np.nextafter(np.float32([twins, past]), np.float32(0))
        levels = np.float32([below[0], six, below[1]])
        return q_t8, _t8(d), 3, _t(levels)
    if kind in ("features-5d", "features-6d"):
        ndim = int(kind[-2])
        q = _objects(rng, 6, 260, ndim, spread=4.0)
        return _t8(q, pad_to=1792), _t8(q[::-1]), ndim, _t(dbscan)
    q_t8, d_t8, ndim, r2 = _count_cloud(kind, rng)
    return q_t8, d_t8, ndim, _t(np.float32([r2, 0.0225, 0.09]))


def _nearest_cloud(kind, rng):
    """(q_t8, d_t8, ndim, d_plain) of one kernel-9 call: ``d_plain`` is the
    caller's data cloud, ``d_t8`` the one the kernel sees (the wrapper pads
    a cloud of 4k + 3 lanes with NaN lanes)."""
    if kind == "objects":
        q = _objects(rng, 6, 300, 3)
        d = q[rng.permutation(len(q))[:1100]] + rng.normal(
            0, 0.05, (1100, 3)).astype(np.float32)
        d = d[np.argsort(d[:, 0], kind="stable")]
        d_t8 = _t8(d, pad_to=1280)
        return _t8(q, pad_to=2048), d_t8, 3, d_t8
    if kind == "border-attach":
        # _dbscan_full's border attach: all points against the core points,
        # non-core lanes at the sentinel, interleaved in the original order
        # (valid points first, as the DBSCAN input holds them)
        pts = _objects(rng, 8, 280, 5, spread=3.0)
        valid = np.arange(len(pts)) < len(pts) - 100
        core = valid & (rng.uniform(size=len(pts)) > 0.3)
        d_t8 = _t8(pts, core, pad_to=2304)
        return _t8(pts, valid, pad_to=2304), d_t8, 5, d_t8
    if kind == "ties":
        # chunk 3 repeats chunk 0: every query near it is as near to a lane
        # of each, and the lower index must win. Chunks 5 and 6 hold one
        # point P 256 times each, and the last query block one point Q
        # whose nearest is P: that group's bound is its nearest dist2
        # exactly, and so is L of its tiles with chunks 5 and 6, which
        # must run (the skip rule is strict)
        a = _lattice(rng.uniform(-1, 1, (256, 3)))
        far = _lattice(rng.uniform(5, 9, (512, 3)))
        p = np.full((256, 3), 3.0, np.float32)
        d = np.concatenate([a, far, a, far[:256], p, p])
        q = np.concatenate([a + _lattice(rng.uniform(-0.05, 0.05, (256, 3))),
                            far, p + np.float32([0.3, 0.0, 0.0])])
        d_t8 = _t8(d)
        return _t8(q), d_t8, 3, d_t8
    if kind == "sentinel-group":
        # four whole query groups at the sentinel (an invalid block), the
        # data with sentinel lanes of its own
        q = _objects(rng, 4, 260, 4, spread=3.0)
        valid = np.ones(len(q), bool)
        valid[256:512] = False
        d_valid = rng.uniform(size=len(q)) > 0.2
        d_t8 = _t8(q[::-1].copy(), d_valid)
        return _t8(q, valid), d_t8, 4, d_t8
    if kind == "nan-pad-ragged":
        pts = _objects(rng, 5, 250, 3)
        q = pts[:1001]
        d = (pts[::-1][:1203]
             + rng.normal(0, 0.03, (1203, 3))).astype(np.float32)
        d_plain = _t8(d, rng.uniform(size=len(d)) > 0.1)
        d_t8 = TK.pad_lanes(d_plain, -(-d_plain.shape[1] // 4) * 4,
                            float("nan"))
        return _t8(q, nan_pad=5), d_t8, 3, d_plain
    raise ValueError(kind)


COUNT_KINDS = ["random-3d", "objects-sentinel", "lattice", "nan-pad-ragged",
               "features-6d"]
COUNT3_KINDS = ["random-3d", "objects-sentinel", "lattice", "nan-pad-ragged",
                "features-5d", "features-6d"]
NEAREST_KINDS = ["objects", "border-attach", "ties", "sentinel-group",
                 "nan-pad-ragged"]
MIN_LABEL_KINDS = ["core-first-5d", "interleaved-5d", "lattice",
                   "nan-pad-ragged", "features-6d"]


@pytest.mark.parametrize("kind", COUNT_KINDS)
def test_count_tiles_are_exact(kind):
    """Kernel 6: no pair of a skipped tile counts, every pair of a whole
    tile counts, and the whole tiles' lane counts plus the pair-loop
    tiles' hits give ``count_plain`` bit for bit."""
    rng = np.random.default_rng(COUNT_KINDS.index(kind) + 70)
    q_t8, d_t8, ndim, r2 = _count_cloud(kind, rng)
    n_q, n_d = q_t8.shape[1], d_t8.shape[1]
    plan = TK.tile_decisions(q_t8, d_t8, ndim, r2=r2)
    dist2 = _dist2_t8(q_t8, d_t8, ndim)
    g_of, c_of = _lane_tiles(plan, n_q, n_d)
    skip = plan["skip"][g_of][:, c_of]
    whole = plan["whole"][g_of][:, c_of]
    hit = dist2 <= np.float32(r2)
    assert not (hit & skip).any()
    q_ok, d_ok = TK.lanes_ok(q_t8, ndim), TK.lanes_ok(d_t8, ndim)
    assert (hit | ~whole | ~q_ok[:, None] | ~d_ok[None, :]).all()
    rebuilt = ((hit & plan["pairs"][g_of][:, c_of]).sum(dim=1)
               + q_ok * (plan["whole"][g_of].long()
                         * plan["d_count"][None, :]).sum(dim=1))
    want = TK.count_plain(q_t8, d_t8, r2, ndim)
    np.testing.assert_array_equal(rebuilt.to(torch.int32).numpy(),
                                  want.numpy())
    # the codes the kernel's tiles= record is held to: (G, C), one each
    assert plan["codes"].shape == (4 * -(-n_q // 256), -(-n_d // 256))
    assert torch.equal(plan["codes"].long(),
                       plan["whole"].long() + 2 * plan["pairs"].long())
    # the decisions have teeth: tiles skipped and left to the pair loop
    # (a uniform random cloud has no tile to decide)
    assert plan["pairs"].any() and (hit.sum(dim=1) > 3).any()
    if kind != "random-3d":
        assert plan["skip"].any() and plan["needed_pairs"] < n_q * n_d
    if kind in ("objects-sentinel", "lattice"):
        assert plan["whole"].any()
    if kind == "lattice":
        # pairs sit exactly on r2 inside whole tiles
        assert (whole & (dist2 == np.float32(r2))).any()


@pytest.mark.parametrize("kind", MIN_LABEL_KINDS)
def test_min_label_tiles_are_exact(kind):
    """Kernel 8: no data lane with label < big in a skipped tile lies
    within max(radius2_q, radius2_d) of its query, and the minimum over
    the pair-loop tiles alone is ``min_label_plain`` bit for bit."""
    rng = np.random.default_rng(MIN_LABEL_KINDS.index(kind) + 80)
    pts_t8, r2, lab, ndim = _min_label_cloud(kind, rng)
    n = pts_t8.shape[1]
    plan = TK.tile_decisions(pts_t8, pts_t8, ndim, radius2=r2, labels=lab,
                             big=BIG)
    dist2 = _dist2_t8(pts_t8, pts_t8, ndim)
    g_of, c_of = _lane_tiles(plan, n, n)
    joint = torch.maximum(r2[:, None], r2[None, :])
    hit = (dist2 <= joint) & (lab < BIG)[None, :]
    assert not (hit & plan["skip"][g_of][:, c_of]).any()
    assert not plan["whole"].any()
    rebuilt = torch.where(hit & plan["pairs"][g_of][:, c_of], lab[None, :],
                          torch.tensor(BIG, dtype=torch.int32)).amin(dim=1)
    want = TK.min_label_plain(pts_t8, r2, lab, ndim, BIG)
    np.testing.assert_array_equal(rebuilt.numpy(), want.numpy())
    assert plan["skip"].any() and (want < BIG).sum() > n // 2


@pytest.mark.parametrize("kind", COUNT3_KINDS)
def test_count3_tiles_are_exact(kind):
    """Kernel 7: no pair of a skipped tile hits any level, every pair of a
    level a whole tile takes hits that level, and the whole tiles' lane
    counts plus the pair-loop tiles' hits give ``count3_plain`` bit for
    bit."""
    rng = np.random.default_rng(COUNT3_KINDS.index(kind) + 100)
    q_t8, d_t8, ndim, levels2 = _count3_cloud(kind, rng)
    n_q, n_d = q_t8.shape[1], d_t8.shape[1]
    plan = TK.tile_decisions(q_t8, d_t8, ndim, levels2=levels2)
    dist2 = _dist2_t8(q_t8, d_t8, ndim)
    g_of, c_of = _lane_tiles(plan, n_q, n_d)
    hit = dist2[..., None] <= levels2
    skip = plan["skip"][g_of][:, c_of]
    assert not (hit.any(dim=-1) & skip).any()
    q_ok, d_ok = TK.lanes_ok(q_t8, ndim), TK.lanes_ok(d_t8, ndim)
    ok = q_ok[:, None] & d_ok[None, :]
    taken = plan["whole_levels"][g_of][:, c_of]
    assert (hit | ~taken | ~ok[..., None]).all()
    pairs = plan["pairs"][g_of][:, c_of]
    rebuilt = ((hit & pairs[..., None]).sum(dim=1)
               + q_ok[:, None] * (plan["whole_levels"][g_of].long()
                                  * plan["d_count"][None, :, None]).sum(dim=1))
    want = TK.count3_plain(q_t8, d_t8, levels2, ndim)
    np.testing.assert_array_equal(rebuilt.to(torch.int32).numpy(),
                                  want.numpy())
    assert plan["codes"].shape == (4 * -(-n_q // 256), -(-n_d // 256))
    assert torch.equal(plan["codes"].long(),
                       plan["whole"].long() + 2 * plan["pairs"].long())
    # the decisions have teeth
    assert plan["pairs"].any() and (want > 3).any()
    if kind != "random-3d":
        assert plan["skip"].any() and plan["needed_pairs"] < n_q * n_d
    if kind in ("objects-sentinel", "lattice"):
        assert plan["whole"].any()
    if kind == "lattice":
        # pairs sit exactly on level 1 inside tiles that take it whole, and
        # some whole tiles add at one level only
        assert (taken[..., 1] & (dist2 == levels2[1])).any()
        assert (plan["whole_levels"].sum(dim=-1) == 1).any()


@pytest.mark.parametrize("kind", NEAREST_KINDS)
def test_nearest_tiles_are_exact(kind):
    """Kernel 9: every pair of a skipped tile is strictly farther than its
    query's true nearest, and the nearest rebuilt from the kept tiles
    alone is ``nearest_plain``'s on the caller's cloud, bit for bit (dist2
    bits and index)."""
    rng = np.random.default_rng(NEAREST_KINDS.index(kind) + 110)
    q_t8, d_t8, ndim, d_plain = _nearest_cloud(kind, rng)
    n_q, n_d = q_t8.shape[1], d_t8.shape[1]
    plan = TK.tile_decisions(q_t8, d_t8, ndim, nearest=True)
    dist2 = _dist2_t8(q_t8, d_t8, ndim)
    g_of, c_of = _lane_tiles(plan, n_q, n_d)
    skip = plan["skip"][g_of][:, c_of]
    want_d, want_i = TK.nearest_plain(q_t8, d_plain, ndim)
    found = torch.isfinite(want_d)
    d_ok = TK.lanes_ok(d_t8, ndim)
    assert ((dist2 > want_d[:, None]) | ~skip | ~found[:, None]
            | ~d_ok[None, :]).all()
    inf = torch.tensor(float("inf"))
    kept = torch.where(skip | dist2.isnan(), inf, dist2)
    best, arg = kept.min(dim=1)
    idx = torch.where(best < inf, arg.to(torch.int32), 0)
    np.testing.assert_array_equal(best.view(torch.int32).numpy(),
                                  want_d.view(torch.int32).numpy())
    np.testing.assert_array_equal(idx.numpy(), want_i.numpy())
    # each group's bound holds its lanes' nearest distances
    assert not plan["whole"].any()
    assert (want_d[found] <= plan["t"][g_of][found]).all()
    # the decisions have teeth
    assert plan["skip"].any() and plan["pairs"].any()
    assert plan["needed_pairs"] < n_q * n_d
    sent = plan["d_sent"] > 0
    if kind in ("border-attach", "sentinel-group"):
        # chunks holding sentinel lanes are skipped too
        assert (plan["skip"] & sent[None, :]).any()
    if kind == "sentinel-group":
        # a group all at the sentinel takes a sentinel lane at dist2 0
        s_lanes = TK.at_sentinel(q_t8, ndim)
        assert s_lanes[256:512].all() and (want_d[256:512] == 0).all()
    if kind == "ties":
        # the nearest is reached in two chunks, and the first one wins
        at = dist2 == want_d[:, None]
        twice = (at.sum(dim=1) >= 2) & found
        first = at.to(torch.uint8).argmax(dim=1).to(torch.int32)
        assert twice.sum() > 100 and torch.equal(want_i[twice], first[twice])
        assert (want_i[:256] < 256).all() and (want_i[768:] == 1280).all()
        tight = plan["t"][-4:]
        assert torch.equal(tight, want_d[768:].max().expand(4))
    if kind == "nan-pad-ragged":
        assert d_t8[:, d_plain.shape[1]:].isnan().all()
        assert (~TK.lanes_ok(q_t8, ndim)).sum() == 5


def test_core_first_order_leaves_fewer_pairs():
    """The same cloud core-first needs fewer pairs than interleaved: its
    query groups and chunks mix fewer sentinel lanes with core points."""
    rng = np.random.default_rng(90)
    pts = _objects(rng, 10, 400, 5, spread=3.0)
    core = rng.uniform(size=len(pts)) > 0.1
    r2 = np.where(core, 0.04, 0.0).astype(np.float32)
    lab = np.where(core, np.arange(len(pts)), BIG).astype(np.int32)
    needed = []
    for order in (np.arange(len(pts)), np.argsort(~core, kind="stable")):
        t8 = _t8(pts[order], core[order])
        needed.append(TK.tile_decisions(t8, t8, 5, radius2=_t(r2[order]),
                                        labels=_t(lab[order]),
                                        big=BIG)["needed_pairs"])
    assert needed[1] < 0.7 * needed[0]


def _features(rng, n, spread=8.0):
    pts = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    for b in range(6):
        c = rng.uniform(-7, 7, 3)
        pts[b * 250:(b + 1) * 250] = c + rng.normal(0, 0.08, (250, 3))
    feats = np.zeros((n, 5), np.float32)
    feats[:, :3] = pts
    feats[:, 3] = rng.uniform(0.3, 0.7, n)
    feats[:, 4] = np.float32(0.1) * rng.integers(0, 2, n)
    mask = np.ones(n, bool)
    mask[rng.choice(n, 50, replace=False)] = False
    return feats, mask


@pytest.mark.parametrize("adaptive", [True, False], ids=["adaptive", "plain"])
def test_dbscan_interleaved_core_equals_jax(jax_dense, monkeypatch,
                                            adaptive):
    """Clumps shuffled through the cloud, so core and non-core points
    interleave: ``_dbscan_full`` hands every min-label round its cloud
    core-first (all label < big lanes before the rest) and its labels
    still equal JAX's."""
    rng = np.random.default_rng(91)
    feats, mask = _features(rng, 3000)
    order = rng.permutation(len(feats))
    feats, mask = feats[order], mask[order]
    rounds = []
    min_label = TK.tile_min_label

    def spy(pts_t8, radius2, labels, ndim, big=BIG):
        core = (labels < big).numpy()
        rounds.append(core)
        return min_label(pts_t8, radius2, labels, ndim, big)

    monkeypatch.setattr(TK, "tile_min_label", spy)
    lj, pj = JC.dbscan_labels(jnp.asarray(feats), jnp.asarray(mask),
                              eps=0.15, min_samples=5, min_cluster_size=15,
                              adaptive=adaptive)
    lt, pt = TC.dbscan_labels(_t(feats), _t(mask), eps=0.15, min_samples=5,
                              min_cluster_size=15, adaptive=adaptive)
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-6, rtol=0)
    assert len(np.unique(lt.numpy()[lt.numpy() >= 0])) >= 5
    assert rounds
    for core in rounds:
        k = int(core.sum())
        assert 0 < k < len(core) and core[:k].all() and not core[k:].any()


@pytest.mark.parametrize("ndim,kernel", [(5, True), (3, True), (2, False)],
                         ids=["5d", "3d", "2d-plain"])
def test_plain_dbscan_counts_take_kernel_6(monkeypatch, ndim, kernel):
    """``_radius_count_full`` (plain DBSCAN's core counts) calls
    ``tile_radius_count`` for 3-6 feature columns and the plain count
    otherwise; the counts exclude self and invalid points count 0."""
    rng = np.random.default_rng(92 + ndim)
    pts = _objects(rng, 4, 150, ndim, spread=2.0, size=(0.5, 0.5, 0.5))
    mask = rng.uniform(size=len(pts)) > 0.1
    calls = []
    count = TK.tile_radius_count

    def spy(*args, **kwargs):
        calls.append(args[0].shape)
        return count(*args, **kwargs)

    monkeypatch.setattr(TK, "tile_radius_count", spy)
    r2 = torch.tensor(0.01, dtype=torch.float32)
    got = TC._radius_count_full(_t(pts), _t(mask), r2).numpy()
    sent = np.where(mask[:, None], pts, SENT).astype(np.float32)
    acc = None
    for c in range(ndim):
        diff = (sent[:, c][:, None] - sent[:, c][None, :]).astype(np.float32)
        sq = (diff * diff).astype(np.float32)
        acc = sq if acc is None else (acc + sq).astype(np.float32)
    want = np.where(mask, (acc <= np.float32(0.01)).sum(axis=1) - 1, 0)
    np.testing.assert_array_equal(got, want)
    assert len(calls) == (1 if kernel else 0) and want.max() > 3


def test_pad_lanes_change_no_result():
    """The wrappers' 16-byte padding: NaN data lanes (radius 0, label big
    for kernel 8) change no count and no label of the real lanes."""
    rng = np.random.default_rng(93)
    q_t8, d_t8, ndim, r2 = _count_cloud("random-3d", rng)
    n_d = d_t8.shape[1]
    padded = TK.pad_lanes(d_t8, (n_d // 4 + 1) * 4, float("nan"))
    assert padded.shape[1] % 4 == 0 and padded[:, n_d:].isnan().all()
    np.testing.assert_array_equal(
        TK.count_plain(q_t8, padded, r2, ndim).numpy(),
        TK.count_plain(q_t8, d_t8, r2, ndim).numpy())
    pts_t8, r2v, lab, ndim = _min_label_cloud("core-first-5d", rng)
    n = pts_t8.shape[1] - 2
    pts_t8, r2v, lab = pts_t8[:, :n].contiguous(), r2v[:n], lab[:n]
    n4 = -(-n // 4) * 4
    got = TK.min_label_plain(TK.pad_lanes(pts_t8, n4, float("nan")),
                             TK.pad_lanes(r2v, n4, 0.0),
                             TK.pad_lanes(lab, n4, BIG), ndim, BIG)
    np.testing.assert_array_equal(
        got[:n].numpy(), TK.min_label_plain(pts_t8, r2v, lab, ndim,
                                            BIG).numpy())
    assert (got[n:] == BIG).all()
    # kernels 7 and 9: a NaN data lane changes no count and takes no
    # nearest, nor any other lane of its column chunk with it
    q_t8, d_t8, ndim, levels2 = _count3_cloud("random-3d", rng)
    n_d = d_t8.shape[1]
    padded = TK.pad_lanes(d_t8, (n_d // 4 + 1) * 4, float("nan"))
    np.testing.assert_array_equal(
        TK.count3_plain(q_t8, padded, levels2, ndim).numpy(),
        TK.count3_plain(q_t8, d_t8, levels2, ndim).numpy())
    got, want = (TK.nearest_plain(q_t8, d, ndim) for d in (padded, d_t8))
    assert (want[1] >= 1024).any()      # nearest lanes in the NaN chunk
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


@pytest.mark.parametrize("name", ["tile_radius_count", "tile_radius_count3",
                                  "tile_min_label", "tile_nearest"])
def test_tiles_record_needs_the_card(name):
    """The kernels' tile record (``tiles=``) is written only on the card:
    given with a CPU cloud, the wrapper raises rather than leave it unset;
    without it the CPU call is the plain version."""
    rng = np.random.default_rng(94)
    if name in ("tile_radius_count", "tile_radius_count3", "tile_nearest"):
        q_t8, d_t8, ndim, r2 = _count_cloud("random-3d", rng)
        args, plain = {
            "tile_radius_count": ((q_t8, d_t8, r2, ndim), TK.count_plain),
            "tile_radius_count3": ((q_t8, d_t8, _t(np.float32([r2, 0.04,
                                                               1.0])),
                                    ndim), TK.count3_plain),
            "tile_nearest": ((q_t8, d_t8, ndim), TK.nearest_plain)}[name]
        shape = (4 * -(-q_t8.shape[1] // 256), -(-d_t8.shape[1] // 256))
    else:
        pts_t8, r2v, lab, ndim = _min_label_cloud("core-first-5d", rng)
        args, plain = (pts_t8, r2v, lab, ndim, BIG), TK.min_label_plain
        n = pts_t8.shape[1]
        shape = (4 * -(-n // 256), -(-n // 256))
    fn = getattr(TK, name)
    with pytest.raises(ValueError, match="tiles must be"):
        fn(*args, tiles=torch.zeros(shape, dtype=torch.uint8))
    got, want = fn(*args), plain(*args)
    for g, w in zip(*((x,) if torch.is_tensor(x) else x for x in (got, want))):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


def test_library_name_hashes_included_headers(tmp_path):
    """A library is named by a hash of its source and of every header it
    includes (quoted, beside it, nested): an edited header names a new
    library, an edited file it does not include does not."""
    (tmp_path / "k.cu").write_text('#include "engine.cuh"\nint k;\n')
    (tmp_path / "engine.cuh").write_text('#pragma once\n#include "inner.cuh"\n')
    (tmp_path / "inner.cuh").write_text("// v1\n")
    (tmp_path / "other.cuh").write_text("// v1\n")
    lib = CudaLibrary(str(tmp_path / "k.cu"), {})
    assert [f.name for f in source_files(lib.source)] == [
        "k.cu", "engine.cuh", "inner.cuh"]
    first = lib.path
    (tmp_path / "other.cuh").write_text("// v2\n")
    assert lib.path == first
    (tmp_path / "inner.cuh").write_text("// v2\n")
    second = lib.path
    assert second != first and second.name.startswith("libk_")
    (tmp_path / "engine.cuh").write_text('#pragma once\n#include "inner.cuh"\n'
                                         "// edited\n")
    assert lib.path not in (first, second)


def test_port_libraries_hash_the_span_engine():
    """banded.cu and dense.cu both include csrc/span_engine.cuh."""
    from vilgod_tpu_torch.ops import kernels

    for lib in (kernels.LIBRARY, TK.LIBRARY):
        names = [f.name for f in source_files(lib.source)]
        assert names[1:] == ["span_engine.cuh"]
