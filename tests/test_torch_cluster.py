"""The port's density clustering and label transfer
(vilgod_tpu_torch/ops/cluster.py, ops/neighbors.py) and the chunk program
of stage 3 (pipeline/stages_geometry.py) against vilgod_tpu on the same
numpy inputs. Labels, counts, indices and tables must be equal;
probabilities agree within 1e-6 (1 - sqrt(d2)/r may round differently).

The label-transfer comparisons use off-lattice points: on the 5 mm
lattice many candidates tie exactly in squared distance, and the JAX
package's XLA CPU build may contract the (q - d)**2 sums into FMAs, which
breaks such ties unlike the separately rounded arithmetic of the TPU and
CUDA kernels (ROADMAP, faults). The chunk program runs on lattice data."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from vilgod_tpu.ops import cluster as JC
from vilgod_tpu.ops import neighbors as JN
from vilgod_tpu.pipeline import stages_geometry as JS
from vilgod_tpu_torch.ops import cluster as TC
from vilgod_tpu_torch.ops import neighbors as TN
from vilgod_tpu_torch.pipeline import stages_geometry as TS


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several pytest workers on a few cores: one intra-op
    thread per worker keeps torch's thread pools from oversubscribing them
    (eight threads per worker made these tests ten times slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _blob_cloud(rng, n, n_blobs=8, blob=300, invalid=200, lattice=True):
    pts = rng.uniform(-30, 30, (n, 3)).astype(np.float32)
    for b in range(n_blobs):
        c = rng.uniform(-25, 25, 3)
        pts[b * blob:(b + 1) * blob] = c + rng.normal(0, 0.08, (blob, 3))
    if lattice:
        pts = np.round(pts / 0.005).astype(np.float32) * np.float32(0.005)
    mask = np.ones(n, bool)
    mask[n - invalid:] = False
    return pts, mask


def _features(rng, n, **kw):
    pts, mask = _blob_cloud(rng, n, **kw)
    feats = np.zeros((n, 5), np.float32)
    feats[:, :3] = pts
    feats[:, 3] = rng.uniform(0.3, 0.7, n)
    feats[:, 4] = np.float32(0.1) * rng.integers(0, 2, n)
    return feats, mask


def test_dbscan_labels_equal():
    rng = np.random.default_rng(21)
    feats, mask = _features(rng, 8192, lattice=False)
    lj, pj = JC.dbscan_labels(jnp.asarray(feats), jnp.asarray(mask), eps=0.15,
                              min_samples=5, min_cluster_size=15)
    lt, pt = TC.dbscan_labels(_t(feats), _t(mask), eps=0.15, min_samples=5,
                              min_cluster_size=15)
    np.testing.assert_array_equal(np.asarray(lj), lt.numpy())
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-6, rtol=0)
    assert len(np.unique(lt.numpy()[lt.numpy() >= 0])) >= 6


def test_dbscan_labels_paged_equal():
    rng = np.random.default_rng(22)
    pages_n, n = 2, 8192
    feats = np.zeros((pages_n, n, 5), np.float32)
    masks = np.zeros((pages_n, n), bool)
    for p in range(pages_n):
        feats[p], masks[p] = _features(rng, n, lattice=False)
    pages = np.repeat(np.arange(pages_n, dtype=np.int32), n)
    flat, fm = feats.reshape(-1, 5), masks.reshape(-1)
    lj, pj = JC.dbscan_labels_paged(jnp.asarray(flat), jnp.asarray(fm),
                                    jnp.asarray(pages), pages_n, eps=0.15,
                                    min_samples=5, min_cluster_size=15)
    lt, pt = TC.dbscan_labels_paged(_t(flat), _t(fm), _t(pages), pages_n,
                                    eps=0.15, min_samples=5,
                                    min_cluster_size=15)
    np.testing.assert_array_equal(np.asarray(lj), lt.numpy())
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-6, rtol=0)


def _transfer_inputs(rng, nq, nd):
    d, dm = _blob_cloud(rng, nd, invalid=150, lattice=False)
    q = np.concatenate([d + rng.normal(0, 0.05, d.shape).astype(np.float32),
                        rng.uniform(-30, 30, (nq - nd, 3)).astype(np.float32)])
    qm = np.ones(nq, bool)
    qm[-100:] = False
    lab = rng.integers(-1, 40, nd).astype(np.int32)
    prob = rng.uniform(0, 1, nd).astype(np.float32)
    return q, qm, d, dm, lab, prob


def test_knn_labels_equal():
    rng = np.random.default_rng(23)
    q, qm, d, dm, lab, prob = _transfer_inputs(rng, 8192, 4096)
    lj, pj = JN.knn_labels(jnp.asarray(q), jnp.asarray(qm), jnp.asarray(d),
                           jnp.asarray(dm), jnp.asarray(lab),
                           jnp.asarray(prob), dist_threshold=0.2)
    lt, pt = TN.knn_labels(_t(q), _t(qm), _t(d), _t(dm), _t(lab), _t(prob),
                           dist_threshold=0.2)
    np.testing.assert_array_equal(np.asarray(lj), lt.numpy())
    np.testing.assert_array_equal(np.asarray(pj), pt.numpy())
    assert (lt.numpy() >= 0).mean() > 0.3


@pytest.mark.parametrize("dense_cell", [False, True], ids=["band", "2x-band"])
def test_knn_labels_paged_equal(dense_cell):
    """Two pages; with ``dense_cell`` one grid cell holds so many points
    that its blocks overflow the band and take the 2x-band middle tier."""
    rng = np.random.default_rng(24)
    pages_n, nq, nd = 2, 8192, 32768 if dense_cell else 4096
    qs, qms, ds, dms, labs, probs = [], [], [], [], [], []
    for _ in range(pages_n):
        q, qm, d, dm, lab, prob = _transfer_inputs(rng, max(nq, nd), nd)
        if dense_cell:
            d[:16000] = np.array([5.0, 5.0, 0.0]) + rng.normal(0, 0.15, (16000, 3))
            q = d[rng.integers(0, nd, nq)] + rng.normal(0, 0.05, (nq, 3))
            qm = np.ones(nq, bool)
        qs.append(q[:nq].astype(np.float32))
        qms.append(qm[:nq])
        ds.append(d.astype(np.float32))
        dms.append(dm)
        labs.append(lab); probs.append(prob)
    q, qm, d, dm = (np.concatenate(x) for x in (qs, qms, ds, dms))
    lab, prob = np.concatenate(labs), np.concatenate(probs)
    qp = np.repeat(np.arange(pages_n, dtype=np.int32), nq)
    dp = np.repeat(np.arange(pages_n, dtype=np.int32), nd)
    lj, pj = JN.knn_labels_paged(
        jnp.asarray(q), jnp.asarray(qm), jnp.asarray(qp), jnp.asarray(d),
        jnp.asarray(dm), jnp.asarray(dp), pages_n, jnp.asarray(lab),
        jnp.asarray(prob), dist_threshold=0.2)
    lt, pt = TN.knn_labels_paged(_t(q), _t(qm), _t(qp), _t(d), _t(dm), _t(dp),
                                 pages_n, _t(lab), _t(prob),
                                 dist_threshold=0.2)
    np.testing.assert_array_equal(np.asarray(lj), lt.numpy())
    np.testing.assert_array_equal(np.asarray(pj), pt.numpy())


def test_knn_labels_paged_page_id_overflow_asserts():
    """n_pages * GRID**2 must fit int32 (the JAX version lacks the check
    and would wrap the paged cell ids)."""
    z3 = torch.zeros((1024, 3))
    with pytest.raises(AssertionError, match="overflows int32"):
        TN.knn_labels_paged(z3, torch.ones(1024, dtype=torch.bool),
                            torch.zeros(1024, dtype=torch.int32),
                            torch.zeros((2048, 3)),
                            torch.ones(2048, dtype=torch.bool),
                            torch.zeros(2048, dtype=torch.int32), 512,
                            torch.zeros(2048, dtype=torch.int32))


def _chunk_inputs():
    """The tests/test_cluster.py direct-transfer scene: 4 frames of three
    blobs plus clutter in an 8192-point non-ground buffer."""
    rng = np.random.default_rng(25)
    f_pad, n_ng = 4, 8192
    xyz = np.zeros((f_pad, n_ng, 3), np.float32)
    m = np.zeros((f_pad, n_ng), bool)
    for f in range(f_pad):
        pts = [c + rng.normal(0, 0.05, (500, 3))
               for c in ((0, 0, 1), (4, 1, 1), (-3, 5, 1))]
        pts = np.concatenate(pts + [rng.uniform(-8, 8, (400, 3))])
        xyz[f, :len(pts)] = np.round(pts / 0.005) * 0.005
        m[f, :len(pts)] = True
    ent = rng.uniform(0, 1, (f_pad, n_ng)).astype(np.float32)
    return xyz, m, ent, np.ones(f_pad, bool)


@pytest.mark.parametrize("cap_in", [8192, 16384], ids=["per-frame", "paged"])
def test_cluster_frames_chunk_equal(cap_in):
    xyz, m, ent, fv = _chunk_inputs()
    sj = JS.frame_select_stats_all(jnp.asarray(xyz), jnp.asarray(m),
                                   jnp.asarray(ent), jnp.asarray(fv))
    st = TS.frame_select_stats_all(_t(xyz), _t(m), _t(ent), _t(fv))
    for a, b in zip(sj, st):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    kw = dict(chunk=2, cap_in=cap_in, max_clusters=32, capacity=512)
    oj = JS.cluster_frames_chunk(jnp.asarray(xyz), jnp.asarray(m),
                                 jnp.asarray(ent), jnp.asarray(fv), sj, 1,
                                 666, **kw)
    ot = TS.cluster_frames_chunk(_t(xyz), _t(m), _t(ent), _t(fv), st, 1, 666,
                                 **kw)
    for a, b, name in zip(oj, ot, ("labels", "probs", "det_n", "det_center",
                                   "det_static", "table")):
        if name == "probs":
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6,
                                       rtol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                          err_msg=name)
    assert (ot[2].numpy() > 0).sum(axis=1).min() >= 3  # three blobs per frame


def test_fidelity_vs_hdbscan_realistic_scene():
    """tests/test_cluster.py's HDBSCAN fidelity harness on the port: on a
    Waymo-density scene fragment (box shells at ~0.07 m surface spacing
    over a sparse background) the radius-graph clustering agrees with
    sklearn's HDBSCAN(min_cluster_size=15, cluster_selection_epsilon=0.15)
    at ARI > 0.85."""
    from sklearn.cluster import HDBSCAN
    from sklearn.metrics import adjusted_rand_score

    rng = np.random.default_rng(666)
    objs = []
    for cx, cy, ext in [(0, 0, (4.4, 1.9, 1.6)), (8, 4, (0.6, 0.6, 1.7)),
                        (-6, 5, (1.8, 0.6, 1.7)), (5, -6, (4.4, 1.9, 1.6))]:
        n = int(np.prod(ext) ** (2 / 3) * 600) + 150
        pts = rng.uniform(-0.5, 0.5, (n, 3)) * np.asarray(ext)
        pts[:, :2] += (cx, cy)
        ax = rng.integers(0, 3, n)
        for a in range(3):
            sel = ax == a
            pts[sel, a] = (np.sign(pts[sel, a] + 1e-9) * ext[a] / 2
                           + (cx, cy, 0)[a])
        objs.append(pts)
    background = rng.uniform(-15, 15, (400, 3))
    allp = np.concatenate(objs + [background]).astype(np.float32)
    allp = allp[rng.permutation(len(allp))]
    total = 1 << int(np.ceil(np.log2(len(allp))))
    padded = np.zeros((total, 3), np.float32)
    padded[: len(allp)] = allp
    mask = np.arange(total) < len(allp)

    labels, _ = TC.dbscan_labels(_t(padded), _t(mask), eps=0.15,
                                 min_samples=5, min_cluster_size=15)
    labels = labels.numpy()[: len(allp)]
    h = HDBSCAN(min_cluster_size=15, cluster_selection_epsilon=0.15,
                metric="euclidean", copy=True).fit(allp)
    score = adjusted_rand_score(labels, h.labels_)
    assert score > 0.85, f"ARI vs HDBSCAN = {score:.3f}"
