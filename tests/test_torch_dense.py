"""The dense (all-pairs) neighbour path of the port (ops/dense_kernels.py
and its callers in ops/neighbors.py, ops/cluster.py, ops/entropy.py)
against the JAX package's own Pallas kernels run in interpret mode.

A fixture runs ``pallas_call`` with ``interpret=True`` and switches the
dense Pallas branches of ``vilgod_tpu.ops.neighbors`` and
``vilgod_tpu.ops.cluster`` on (the banded ones stay on their XLA
fallback), clearing JAX's caches around each test so no trace of another
test is reused. Nothing in the JAX package changes.

Counts, labels and indices must be equal. Squared distances are held bit
for bit to a numpy difference-form oracle (each product and sum rounded
on its own, as the port's kernels do) and within 2 ulp of JAX's: XLA's
CPU build contracts some of the interpreted kernel's ``acc + diff * diff``
into fused multiply-adds (ROADMAP, faults), which also flips pairs that
sit exactly on an un-nudged threshold of the 5 mm lattice. So the
comparisons with JAX run on off-lattice points, and on lattice points the
port is held to the numpy oracle alone."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.experimental import pallas as pl

from vilgod_tpu.config.presets import waymo_config as jax_waymo_config
from vilgod_tpu.data import SyntheticDataset as JaxSyntheticDataset
from vilgod_tpu.ops import cluster as JC
from vilgod_tpu.ops import neighbors as JN
from vilgod_tpu.ops import pallas_kernels as JK
from vilgod_tpu.pipeline.runner import ZeroShotDetector as JaxDetector
from vilgod_tpu_torch.config import waymo_config
from vilgod_tpu_torch.data import SyntheticDataset
from vilgod_tpu_torch.ops import cluster as TC
from vilgod_tpu_torch.ops import dense_kernels as TK
from vilgod_tpu_torch.ops import entropy as TE
from vilgod_tpu_torch.ops import neighbors as TN
from vilgod_tpu_torch.ops.kernels import prep_t8
from vilgod_tpu_torch.pipeline.runner import ZeroShotDetector
from vilgod_tpu_torch.pipeline.stages_geometry import rebuild_ng_buffers


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
    CPU; its banded branches stay on the XLA fallback."""
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


@pytest.fixture
def dense_calls(monkeypatch):
    """Calls of each dense wrapper, by name."""
    calls = {name: 0 for name in TK.KERNEL_NAMES}
    for name in TK.KERNEL_NAMES:
        def counted(*args, _name=name, _fn=getattr(TK, name), **kwargs):
            calls[_name] += 1
            return _fn(*args, **kwargs)
        monkeypatch.setattr(TK, name, counted)
    return calls


def _t(a):
    return torch.from_numpy(np.array(a))


def _cloud(rng, n, invalid=50, lattice=False, spread=6.0):
    pts = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    pts[: n // 2] = (rng.uniform(-spread, spread, (1, 3))
                     + rng.normal(0, 0.3, (n // 2, 3))).astype(np.float32)
    if lattice:
        pts = np.round(pts / 0.005).astype(np.float32) * np.float32(0.005)
    mask = np.ones(n, bool)
    mask[rng.choice(n, invalid, replace=False)] = False
    return pts, mask


def _oracle_dist2(q, d):
    """(Q, D) difference-form squared distances, each op rounded to f32."""
    acc = None
    for c in range(q.shape[1]):
        diff = (q[:, c][:, None] - d[:, c][None, :]).astype(np.float32)
        sq = (diff * diff).astype(np.float32)
        acc = sq if acc is None else (acc + sq).astype(np.float32)
    return acc


def _within_ulps(got, want, ulps=2):
    spacing = np.spacing(np.maximum(np.abs(want), np.float32(1e-30)))
    return bool(np.all(np.abs(got.astype(np.float64) - want) <= ulps * spacing))


@pytest.mark.parametrize("nq,nd,radius", [(3000, 2500, 0.3), (4096, 4096, 0.6)],
                         ids=["ragged", "radius-above-cell"])
def test_radius_count_dense_equal(jax_dense, nq, nd, radius):
    rng = np.random.default_rng(31)
    q, qm = _cloud(rng, nq)
    d, dm = _cloud(rng, nd)
    assert not JN._bandable(nq, nd, radius)
    want = np.asarray(JN.radius_count(jnp.asarray(q), jnp.asarray(qm),
                                      jnp.asarray(d), jnp.asarray(dm),
                                      radius, max_count=60))
    got = TN.radius_count(_t(q), _t(qm), _t(d), _t(dm), radius,
                          max_count=60).numpy()
    np.testing.assert_array_equal(got, want)
    assert want.max() == 60 and (want[~qm] == 0).all()


def test_knn_nearest_equal(jax_dense):
    rng = np.random.default_rng(32)
    q, qm = _cloud(rng, 2000)
    d, dm = _cloud(rng, 3000)
    jd, ji = JN.knn(jnp.asarray(q), jnp.asarray(qm), jnp.asarray(d),
                    jnp.asarray(dm), k=1)
    td, ti = TN.knn(_t(q), _t(qm), _t(d), _t(dm), k=1)
    jd, ji, td, ti = (np.asarray(a)[:, 0] for a in (jd, ji, td, ti))
    np.testing.assert_array_equal(ti, ji)
    assert (td[~qm] == np.inf).all() and (jd[~qm] == np.inf).all()
    # valid queries: bitwise the difference form's nearest, 2 ulp of JAX's
    oracle = _oracle_dist2(q[qm], np.where(dm[:, None], d, 1.0e6))
    np.testing.assert_array_equal(td[qm], oracle.min(axis=1))
    np.testing.assert_array_equal(ti[qm], oracle.argmin(axis=1))
    assert _within_ulps(td[qm], jd[qm])


def test_chamfer_distance_matches(jax_dense):
    rng = np.random.default_rng(33)
    a, am = _cloud(rng, 1500, spread=3.0)
    b, bm = _cloud(rng, 1800, spread=3.0)
    want = float(JN.chamfer_distance(jnp.asarray(a), jnp.asarray(am),
                                     jnp.asarray(b), jnp.asarray(bm)))
    got = float(TN.chamfer_distance(_t(a), _t(am), _t(b), _t(bm)))
    assert want > 0
    assert got == pytest.approx(want, rel=1e-6)


def _features(rng, n, lattice=False):
    pts, mask = _cloud(rng, n, lattice=lattice, spread=8.0)
    for b in range(6):
        c = rng.uniform(-7, 7, 3)
        pts[b * 250:(b + 1) * 250] = c + rng.normal(0, 0.08, (250, 3))
    if lattice:
        pts = np.round(pts / 0.005).astype(np.float32) * np.float32(0.005)
    feats = np.zeros((n, 5), np.float32)
    feats[:, :3] = pts
    feats[:, 3] = rng.uniform(0.3, 0.7, n)
    feats[:, 4] = np.float32(0.1) * rng.integers(0, 2, n)
    return feats, mask


@pytest.mark.parametrize("n,adaptive", [(3000, True), (6144 + 1000, True),
                                        (3000, False)],
                         ids=["below-4096", "not-2048-multiple", "plain"])
def test_dbscan_labels_dense_equal(jax_dense, n, adaptive):
    rng = np.random.default_rng(34)
    feats, mask = _features(rng, n)
    lj, pj = JC.dbscan_labels(jnp.asarray(feats), jnp.asarray(mask),
                              eps=0.15, min_samples=5, min_cluster_size=15,
                              adaptive=adaptive)
    lt, pt = TC.dbscan_labels(_t(feats), _t(mask), eps=0.15, min_samples=5,
                              min_cluster_size=15, adaptive=adaptive)
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-6, rtol=0)
    assert len(np.unique(lt.numpy()[lt.numpy() >= 0])) >= 5


def _labelled(rng, n_data):
    d, dm = _cloud(rng, n_data, spread=4.0)
    labels = rng.integers(-1, 20, n_data).astype(np.int32)
    probs = rng.uniform(0.0, 1.0, n_data).astype(np.float32)
    return d, dm, labels, probs


def _transfer_equal(q, qm, d, dm, labels, probs):
    lj, pj = JN.knn_labels(jnp.asarray(q), jnp.asarray(qm), jnp.asarray(d),
                           jnp.asarray(dm), jnp.asarray(labels),
                           jnp.asarray(probs), dist_threshold=0.2)
    lt, pt = TN.knn_labels(_t(q), _t(qm), _t(d), _t(dm), _t(labels),
                           _t(probs), dist_threshold=0.2)
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    return lt.numpy()


def test_knn_labels_dense_equal(jax_dense):
    """A data cloud whose size no tile divides takes the dense knn."""
    rng = np.random.default_rng(35)
    q, qm = _cloud(rng, 8192, spread=4.0)
    d, dm, labels, probs = _labelled(rng, 3000)
    assert not TN._bandable(8192, 3000, float(np.sqrt(0.2)))
    got = _transfer_equal(q, qm, d, dm, labels, probs)
    assert (got >= 0).sum() > 1000


def test_knn_labels_band_overflow_takes_dense_knn(jax_dense, dense_calls,
                                                  monkeypatch):
    """An 8192-point cloud with more than its 4096-point band in one cell
    row: the banded pass overflows and both packages run the dense knn
    (the overflow branch of knn_labels)."""
    from vilgod_tpu_torch.ops import banded as TB

    rng = np.random.default_rng(36)
    n = 8192
    d = rng.uniform(-30, 30, (n, 3)).astype(np.float32)
    # 5000 data points and 3000 queries crowd one 2 m x 1 m strip
    d[:5000, :2] = rng.uniform([0.0, 0.0], [2.0, 1.0], (5000, 2))
    q = rng.uniform(-30, 30, (n, 3)).astype(np.float32)
    q[:3000, :2] = rng.uniform([0.0, 0.0], [2.0, 1.0], (3000, 2))
    q[:3000, 2] = rng.uniform(-0.3, 0.3, 3000)
    d[:5000, 2] = rng.uniform(-0.3, 0.3, 5000)
    qm, dm = np.ones(n, bool), np.ones(n, bool)
    labels = rng.integers(-1, 20, n).astype(np.int32)
    probs = rng.uniform(0.0, 1.0, n).astype(np.float32)
    overflowed = []
    block_windows = TN.block_windows

    def spy(*args, **kwargs):
        out = block_windows(*args, **kwargs)
        overflowed.append(bool(out[2]))
        return out

    monkeypatch.setattr(TN, "block_windows", spy)
    assert TN._bandable(n, n, float(np.sqrt(0.2)))
    assert TB.band_width(n) == 4096
    got = _transfer_equal(q, qm, d, dm, labels, probs)
    assert overflowed == [True] and dense_calls["tile_nearest"] == 1
    assert (got[:3000] >= 0).sum() > 2000


def test_dense_kernels_on_lattice_points_match_numpy_oracle():
    """5 mm lattice points with thresholds that pairs sit on exactly (as
    the un-nudged DBSCAN core levels can): the counts, the min-label pass
    and the nearest pass follow the separately rounded distances."""
    rng = np.random.default_rng(37)
    pts, mask = _cloud(rng, 2500, lattice=True, spread=2.0)
    pts_t8 = prep_t8(_t(pts), _t(mask), 1)
    sent = np.where(mask[:, None], pts, np.float32(1e6))
    dist2 = _oracle_dist2(sent, sent)
    # three squared levels taken from actual pair distances
    inner = dist2[mask][:, mask]
    levels2 = np.array([inner[(inner > lo) & (inner < lo * 1.1)][0]
                        for lo in (0.0225, 0.045, 0.09)], np.float32)
    got = TK.tile_radius_count3(pts_t8, pts_t8, _t(levels2), ndim=3).numpy()
    want = np.stack([(dist2 <= lv).sum(axis=1) for lv in levels2], axis=1)
    np.testing.assert_array_equal(got, want)
    assert np.isin(inner, levels2).sum() >= 6

    r2 = np.where(mask, levels2[rng.integers(0, 3, len(mask))], 0.0)
    r2 = r2.astype(np.float32)
    lab = np.where(mask, np.arange(len(mask)), 2 ** 30).astype(np.int32)
    got = TK.tile_min_label(pts_t8, _t(r2), _t(lab), 3).numpy()
    joint = np.maximum(r2[:, None], r2[None, :])
    want = np.where(dist2 <= joint, lab[None, :], 2 ** 30).min(axis=1)
    np.testing.assert_array_equal(got, want)

    q_t8 = prep_t8(_t(pts[::-1].copy()), _t(mask[::-1].copy()), 1)
    gd, gi = TK.tile_nearest(q_t8, pts_t8, ndim=3)
    want = _oracle_dist2(np.where(mask[::-1, None], pts[::-1], 1e6)
                         .astype(np.float32), sent)
    np.testing.assert_array_equal(gd.numpy(), want.min(axis=1))
    np.testing.assert_array_equal(gi.numpy(), want.argmin(axis=1))


def _core_cloud(rng, n, ndim, noncore=0.2):
    """A sorted-core-cloud stand-in: off-lattice points in ``ndim``
    coordinates (two clumps and a spread), per-lane squared radii and
    labels; a share of lanes non-core (sentinel coordinates, radius 0,
    label >= 2**30)."""
    pts = rng.uniform(-3.0, 3.0, (n, ndim)).astype(np.float32)
    for c in range(2):
        sl = slice(c * n // 4, (c + 1) * n // 4)
        pts[sl] = (rng.uniform(-2, 2, (1, ndim))
                   + rng.normal(0, 0.25, (n // 4, ndim))).astype(np.float32)
    core = rng.uniform(size=n) >= noncore
    r2 = np.where(core, rng.uniform(0.01, 0.09, n), 0.0).astype(np.float32)
    labels = np.where(core, rng.permutation(n) + 7,
                      2 ** 30 + rng.integers(0, 3, n)).astype(np.int32)
    return prep_t8(_t(pts), _t(core), 1), r2, labels


@pytest.mark.parametrize("n,d,ndim", [(512, 4096, 5), (256, 2048, 3)],
                         ids=["512x4096-5d", "256x2048-3d"])
def test_min_label_qd_matches_pallas(jax_dense, n, d, ndim):
    """Kernel 12 on the shapes its JAX grid covers: a query block against a
    DIFFERENT data window of one core cloud (overlapping lanes, labels of
    the data lanes), per-lane radii. The JAX kernel returns the labels as
    f32; the values are equal."""
    rng = np.random.default_rng(38 + ndim)
    pts_t8, r2, labels = _core_cloud(rng, 6144, ndim)
    q0, d0 = 1024, 700
    q_t8 = pts_t8[:, q0:q0 + n].contiguous()
    d_t8 = pts_t8[:, d0:d0 + d].contiguous()
    q_r2, d_r2, d_lab = r2[q0:q0 + n], r2[d0:d0 + d], labels[d0:d0 + d]
    want = np.asarray(JK.tile_min_label_qd(
        jnp.asarray(q_t8.numpy()), jnp.asarray(d_t8.numpy()),
        jnp.asarray(q_r2), jnp.asarray(d_r2), jnp.asarray(d_lab), ndim=ndim))
    TK.reset_launches()
    got = TK.tile_min_label_qd(q_t8, d_t8, _t(q_r2), _t(d_r2), _t(d_lab),
                               ndim)
    assert got.dtype == torch.int32 and got.shape == (n,)
    assert want.dtype == np.float32
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    # the check has teeth: links found, non-core queries left at big
    assert 0.3 < (got.numpy() < 2 ** 30).mean() < 1.0
    assert (got.numpy()[q_r2 == 0] == 2 ** 30).all()
    assert TK.LAUNCHES["tile_min_label_qd"] == 0      # CPU: plain version


def test_min_label_qd_on_one_cloud_equals_min_label():
    """``tile_min_label_qd(p, p, r, r, lab)`` is ``tile_min_label(p, r,
    lab)`` on a ragged cloud: the contract of the CUDA kernel both share."""
    rng = np.random.default_rng(40)
    pts_t8, r2, labels = _core_cloud(rng, 3001, 4)
    TK.reset_launches()
    got = TK.tile_min_label_qd(pts_t8, pts_t8, _t(r2), _t(r2), _t(labels), 4)
    want = TK.tile_min_label(pts_t8, _t(r2), _t(labels), 4)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert (got.numpy() < 2 ** 30).sum() > 1000
    assert all(v == 0 for v in TK.LAUNCHES.values())


def test_dense_wrappers_count_no_cpu_launch():
    """On CPU tensors the wrappers take their plain versions: no launch is
    counted."""
    TK.reset_launches()
    q = prep_t8(torch.zeros(300, 3), torch.ones(300, dtype=torch.bool), 1)
    TK.tile_radius_count(q, q, 0.1)
    TK.tile_nearest(q, q)
    assert all(v == 0 for v in TK.LAUNCHES.values())


# ---------------------------------------------------------------------------
# the dense configuration on the verify scene
# ---------------------------------------------------------------------------

CAP = {"max_points": 16384, "max_ng_points": 8192, "max_clusters": 64,
       "max_cluster_points": 4096, "max_tracks": 64,
       "max_cluster_input": 6000, "clip_batch": 8}
STAGES = ["mask_ground_points", "calculate_entropy_scores",
          "spatial_clustering"]
SCENE = dict(n_sequences=1, n_frames=8, seed=12, n_ground=3000,
             n_vehicles=2, n_pedestrians=1, n_moving=1)
PARALLEL = {"shard_frames": False, "shard_ground": False,
            "shard_cluster": False, "shard_filter": False,
            "shard_clip": False}


def _dense_cfg(config, **kw):
    cfg = config(capacity=CAP, pipeline_active=STAGES, **kw)
    for p in cfg["pipeline"]:
        if p["name"] == "calculate_entropy_scores":
            p.setdefault("args", {})["max_neighbor_point_dist"] = 0.5
    return cfg


def test_dense_configuration_stages_match_jax(jax_dense, dense_calls):
    """Entropy radius 0.5 m (not bandable) and a 6000-point cluster input
    (per-frame _dbscan_full and the dense knn label transfer): the port's
    stages 2-3 over JAX's stage-1 ground masks give JAX's entropy, labels
    and detections."""
    zj = JaxDetector(JaxSyntheticDataset(**SCENE).sequence("synth_0"),
                     "synth_0", _dense_cfg(jax_waymo_config,
                                           parallel=PARALLEL))
    zj.process()
    j = zj.state
    zt = ZeroShotDetector(SyntheticDataset(**SCENE).sequence("synth_0"),
                          "synth_0", _dense_cfg(waymo_config), device="cpu")
    t = zt.state
    t._h_ground_mask[...] = j.ground_mask
    t.done["mask_ground_points"] = True
    rebuild_ng_buffers(t)
    zt.process()
    # every (frame, window frame) pair counted densely; every frame
    # clustered and its labels transferred densely
    rounds = dense_calls.pop("tile_min_label")
    assert dense_calls == {"tile_radius_count": 8 * 4,
                           "tile_radius_count3": 8, "tile_nearest": 2 * 8,
                           "tile_min_label_qd": 0}
    assert rounds >= 2 * 8
    np.testing.assert_array_equal(t.ng_mask, j.ng_mask)
    np.testing.assert_allclose(t.ng_entropy, j.ng_entropy, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(t.labels, j.labels)
    np.testing.assert_array_equal(t.det_n, j.det_n)
    np.testing.assert_allclose(t.det_center, j.det_center, atol=1e-4, rtol=0)
    assert (t.det_n > 0).sum(axis=1).min() >= 2
