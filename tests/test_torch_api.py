"""The rest of the port's public API against the JAX package: each package
``__init__`` of vilgod_tpu_torch exports every name its vilgod_tpu
counterpart exports, and the ops that no stage of the main path calls
(label compaction and cluster sizes, ``entropy_scores_window``,
``pca_plane_stats``, the gather-table statistics, the single-set hull,
the box and SE(3) transforms, ``knn`` with k > 1) match JAX on seeded
numpy inputs. Integers are equal; each float comparison states its
tolerance and where it comes from.

``knn`` with k > 1 runs JAX's blockwise top-k, whose squared distances
take the matmul expansion (q^2 + d^2 - 2 q.d); the port takes the
difference form. On integer-lattice points both forms are exact, so
there the distances and the indices (ties to the lower index) are equal;
on random points the distances agree within the expansion's rounding."""
import importlib

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.experimental import pallas as pl

from vilgod_tpu import ops as J
from vilgod_tpu.ops import cluster as JC
from vilgod_tpu.ops import neighbors as JN
from vilgod_tpu_torch import ops as T
from vilgod_tpu_torch.ops import cluster as TC
from vilgod_tpu_torch.ops import dense_kernels, kernels


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per pytest worker (see test_torch_slice.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return np.asarray(x)


# the port's utils also export resolve_device, its device rule; its
# parallel its Mesh and local_devices, where the stages learn their devices
PORT_EXTRAS = {"utils": {"resolve_device"},
               "parallel": {"Mesh", "local_devices"}}


@pytest.mark.parametrize("package", ["data", "eval", "ops", "ground",
                                     "models", "config", "pipeline",
                                     "tracking", "utils", "parallel"])
def test_package_exports_every_jax_name(package):
    jax_mod = importlib.import_module(f"vilgod_tpu.{package}")
    port_mod = importlib.import_module(f"vilgod_tpu_torch.{package}")
    jax_names = set(jax_mod.__all__)
    port_names = set(port_mod.__all__)
    assert jax_names <= port_names, sorted(jax_names - port_names)
    assert port_names - jax_names <= PORT_EXTRAS.get(package, set())
    for name in port_names:
        assert hasattr(port_mod, name), name
    # the port's own copies, never the JAX package's objects
    for name in jax_names:
        obj = getattr(port_mod, name)
        assert not getattr(obj, "__module__", "").startswith("vilgod_tpu."), name


# JAX-only plumbing (the compilation cache, the Pallas switch) and the two
# box fits the port folds into its box stage (ROADMAP: exceptions)
NOT_PORTED = {"enable_compilation_cache", "pallas_supported",
              "fit_heading_from_tables", "fit_static_from_tables"}


def _public_top_level(root):
    import ast
    from pathlib import Path

    names = set()
    for path in Path(root).rglob("*.py"):
        for node in ast.parse(path.read_text()).body:
            if (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef))
                    and not node.name.startswith("_")):
                names.add(node.name)
    return names


def test_every_public_jax_name_has_a_counterpart():
    """Every public top-level function and class of the JAX package has a
    namesake in the port but the listed exceptions."""
    from pathlib import Path

    import vilgod_tpu
    import vilgod_tpu_torch

    jax_names = _public_top_level(Path(vilgod_tpu.__file__).parent)
    port_names = _public_top_level(Path(vilgod_tpu_torch.__file__).parent)
    assert jax_names - port_names == NOT_PORTED
    assert NOT_PORTED <= jax_names


# ---------------------------------------------------------------------------
# label compaction and cluster sizes
# ---------------------------------------------------------------------------

def test_cluster_sizes_and_compact_labels_match_jax():
    rng = np.random.default_rng(0)
    n = 500
    for max_clusters in (4, 64):
        labels = rng.choice(np.array([-1, 3, 17, 42, 199, 499, 250]), n)
        labels = labels.astype(np.int32)
        mask = rng.random(n) > 0.2
        np.testing.assert_array_equal(
            TC.compact_labels(_t(labels), max_clusters).numpy(),
            _np(JC.compact_labels(jnp.asarray(labels), max_clusters)))
        # any non-negative values, the paged clustering's global roots
        wide = np.where(labels >= 0, labels * 7919 + 100000, -1).astype(np.int32)
        got = TC.compact_labels_any(_t(wide), max_clusters)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(
            got.numpy(), _np(JC.compact_labels_any(jnp.asarray(wide),
                                                   max_clusters)))
        compact = _np(JC.compact_labels(jnp.asarray(labels), max_clusters))
        got = T.cluster_sizes(_t(compact), _t(mask), max_clusters)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(
            got.numpy(), _np(J.cluster_sizes(jnp.asarray(compact),
                                             jnp.asarray(mask),
                                             max_clusters)))
    # labels past num_clusters count nowhere, as JAX drops them
    labels = np.array([0, 1, 5, 9, 2, -1], np.int32)
    mask = np.ones(6, bool)
    np.testing.assert_array_equal(
        T.cluster_sizes(_t(labels), _t(mask), 3).numpy(),
        _np(J.cluster_sizes(jnp.asarray(labels), jnp.asarray(mask), 3)))


# ---------------------------------------------------------------------------
# plane statistics, gather-table statistics, hull, transforms
# ---------------------------------------------------------------------------

def test_pca_plane_stats_matches_jax():
    """float64 sums and eigensolver in the port, float32 in JAX: within
    1e-5 (normals, eigenvalues) and 1e-5 m (means, d)."""
    rng = np.random.default_rng(1)
    for n_valid in (200, 3):
        pts = rng.normal(size=(256, 3)).astype(np.float32) * [4.0, 3.0, 0.05]
        pts = (pts + [10.0, -5.0, -1.7]).astype(np.float32)
        mask = np.zeros(256, bool)
        mask[:n_valid] = True
        j = [_np(x) for x in J.pca_plane_stats(jnp.asarray(pts),
                                               jnp.asarray(mask))]
        t = [x.numpy() for x in T.pca_plane_stats(_t(pts), _t(mask))]
        for a, b in zip(t, j):
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-5)
        assert t[0][2] >= 0


def _table(rng, n_points=300, clusters=6, cap=64):
    points = rng.normal(size=(n_points, 4)).astype(np.float32) * 5
    table = rng.integers(0, n_points, (clusters, cap)).astype(np.int32)
    counts = np.array([0, 1, 2, 7, 31, cap])[:clusters]
    table_mask = np.arange(cap)[None, :] < counts[:, None]
    table = np.where(table_mask, table, -1).astype(np.int32)
    return points, table, table_mask


def test_gather_table_statistics_match_jax():
    """Gather, count, min, max, median and percentile are equal (one
    sort, one gather, one interpolation in the same f32 order); the mean
    within 1e-6 relative (the row sums' order)."""
    from vilgod_tpu.ops import segment as JS
    rng = np.random.default_rng(2)
    points, table, table_mask = _table(rng)
    g_t = T.gather_cluster_points(_t(points), _t(table), _t(table_mask))
    g_j = J.gather_cluster_points(jnp.asarray(points), jnp.asarray(table),
                                  jnp.asarray(table_mask))
    np.testing.assert_array_equal(g_t.numpy(), _np(g_j))
    m_t, m_j = _t(table_mask), jnp.asarray(table_mask)
    np.testing.assert_array_equal(T.seg_count(m_t).numpy(),
                                  _np(J.seg_count(m_j)))
    assert T.seg_count(m_t).dtype == torch.int32
    for vals in (g_t, g_t[..., 2]):
        v_j = jnp.asarray(vals.numpy())
        for fn in ("seg_min", "seg_max", "seg_median"):
            np.testing.assert_array_equal(
                getattr(T, fn)(vals, m_t).numpy(),
                _np(getattr(JS, fn)(v_j, m_j)), err_msg=fn)
        np.testing.assert_allclose(T.seg_mean(vals, m_t).numpy(),
                                   _np(J.seg_mean(v_j, m_j)), rtol=1e-6,
                                   atol=1e-6)
    for q in (0.0, 10.0, 50.0, 90.0, 100.0):
        np.testing.assert_array_equal(
            T.seg_percentile(g_t[..., 1], m_t, q).numpy(),
            _np(J.seg_percentile(jnp.asarray(g_t[..., 1].numpy()), m_j, q)))


def test_convex_hull_area_bev_matches_jax():
    """The same support polygon; the port sums it in float64, JAX in
    float32: within 1e-4 relative. Under three points the area is 0."""
    rng = np.random.default_rng(3)
    for n_valid in (400, 40, 3, 2):
        pts = (rng.normal(size=(512, 2)) * [3.0, 1.0] + [20.0, -7.0])
        pts = pts.astype(np.float32)
        mask = np.zeros(512, bool)
        mask[:n_valid] = True
        j = float(J.convex_hull_area_bev(jnp.asarray(pts), jnp.asarray(mask)))
        t = float(T.convex_hull_area_bev(_t(pts), _t(mask)))
        assert t == pytest.approx(j, rel=1e-4, abs=1e-6), (n_valid, t, j)
        if n_valid < 3:
            assert t == 0.0


def test_box_and_se3_transforms_match_jax():
    """yaw_of, make_se3 equal; apply_transform_boxes and invert_se3
    within 1e-5 (JAX's einsum and the port's fixed-order sums round
    differently), batched too."""
    rng = np.random.default_rng(4)
    angles = rng.uniform(-np.pi, np.pi, (5, 3)).astype(np.float32)
    rot = _np(J.euler2mat(jnp.asarray(angles)))
    trans = rng.normal(size=(5, 3)).astype(np.float32) * 50
    se3_t = T.make_se3(_t(rot), _t(trans))
    se3_j = J.make_se3(jnp.asarray(rot), jnp.asarray(trans))
    np.testing.assert_array_equal(se3_t.numpy(), _np(se3_j))
    np.testing.assert_array_equal(T.yaw_of(se3_t).numpy(),
                                  _np(J.yaw_of(se3_j)))
    np.testing.assert_allclose(T.invert_se3(se3_t).numpy(),
                               _np(J.invert_se3(se3_j)), atol=1e-5)
    boxes = np.concatenate([rng.normal(size=(5, 9, 3)) * 30,
                            rng.uniform(0.5, 5, (5, 9, 3)),
                            rng.uniform(-3, 3, (5, 9, 1)),
                            rng.normal(size=(5, 9, 2))], -1).astype(np.float32)
    np.testing.assert_allclose(
        T.apply_transform_boxes(_t(boxes), se3_t).numpy(),
        _np(J.apply_transform_boxes(jnp.asarray(boxes), se3_j)),
        atol=2e-5, rtol=1e-6)
    np.testing.assert_allclose(
        T.apply_transform_boxes(_t(boxes[0]), se3_t[1]).numpy(),
        _np(J.apply_transform_boxes(jnp.asarray(boxes[0]), se3_j[1])),
        atol=2e-5, rtol=1e-6)


# ---------------------------------------------------------------------------
# knn with k > 1
# ---------------------------------------------------------------------------

def _lattice_cloud(rng, n, extent=6):
    return rng.integers(-extent, extent + 1, (n, 3)).astype(np.float32)


@pytest.mark.parametrize("k", [2, 8])
def test_knn_k_ties_go_to_the_lower_index(k):
    """Integer lattice points: every squared distance is exact in both
    forms and many tie; the port equals JAX (and a stable numpy sort)
    in distances and indices. The data spans three 4096-point blocks, so
    the merge of block lists is exercised; some data and queries are
    invalid."""
    rng = np.random.default_rng(5 + k)
    q, d = _lattice_cloud(rng, 300), _lattice_cloud(rng, 9000)
    qm, dm = rng.random(300) > 0.1, rng.random(9000) > 0.3
    dt, it = T.knn(_t(q), _t(qm), _t(d), _t(dm), k=k)
    dj, ij = J.knn(jnp.asarray(q), jnp.asarray(qm), jnp.asarray(d),
                   jnp.asarray(dm), k=k)
    assert dt.dtype == torch.float32 and it.dtype == torch.int32
    np.testing.assert_array_equal(dt.numpy(), _np(dj))
    np.testing.assert_array_equal(it.numpy()[qm], _np(ij)[qm])
    # the oracle: a stable sort of exact distances
    d2 = ((q[:, None, :] - d[None]) ** 2).sum(-1)
    d2 = np.where(dm[None], d2, np.inf)
    order = np.argsort(d2, axis=1, kind="stable")[:, :k]
    np.testing.assert_array_equal(it.numpy()[qm], order[qm])
    assert (np.diff(dt.numpy()[qm], axis=1) >= 0).all()


def test_knn_k_fewer_valid_points_than_k():
    """Past the valid data the entries are +inf with index 0, as JAX's
    merge with its initial list gives them; an invalid query is +inf."""
    rng = np.random.default_rng(9)
    q, d = _lattice_cloud(rng, 20), _lattice_cloud(rng, 50)
    qm, dm = np.ones(20, bool), np.zeros(50, bool)
    dm[[3, 17, 40]] = True
    qm[5] = False
    dt, it = T.knn(_t(q), _t(qm), _t(d), _t(dm), k=6)
    dj, ij = J.knn(jnp.asarray(q), jnp.asarray(qm), jnp.asarray(d),
                   jnp.asarray(dm), k=6)
    np.testing.assert_array_equal(dt.numpy(), _np(dj))
    np.testing.assert_array_equal(it.numpy(), _np(ij))
    assert np.isinf(dt.numpy()[:, 3:]).all() and (it.numpy()[:, 3:] == 0).all()
    assert np.isinf(dt.numpy()[5]).all()


def test_knn_k_random_points_match_jax():
    """Random f32 points: distances within JAX's matmul-form rounding
    (a few f32 ulp of |q|^2 + |d|^2, about 1.1e-3 at these 35 m
    magnitudes); indices equal wherever the neighbour's distance stands
    3e-3 clear of the others around it."""
    rng = np.random.default_rng(10)
    q = rng.uniform(-20, 20, (256, 3)).astype(np.float32)
    d = rng.uniform(-20, 20, (5000, 3)).astype(np.float32)
    qm, dm = np.ones(256, bool), rng.random(5000) > 0.05
    dt, it = T.knn(_t(q), _t(qm), _t(d), _t(dm), k=8)
    dj, ij = J.knn(jnp.asarray(q), jnp.asarray(qm), jnp.asarray(d),
                   jnp.asarray(dm), k=8)
    dt, it, dj, ij = dt.numpy(), it.numpy(), _np(dj), _np(ij)
    tol = 4 * np.finfo(np.float32).eps * float(
        (q ** 2).sum(1).max() + (d ** 2).sum(1).max())
    np.testing.assert_allclose(dt, dj, atol=tol)
    gaps = np.diff(dt, axis=1)
    clear = np.ones_like(dt, bool)
    clear[:, 1:] &= gaps > 3 * tol
    clear[:, :-1] &= gaps > 3 * tol
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(it[clear], ij[clear])
    # the port's distances are the difference form's, bit for bit
    exact = np.zeros_like(dt)
    for c in range(3):
        diff = q[:, None, c] - d[it, c]
        exact = exact + diff * diff
    np.testing.assert_array_equal(dt, exact)


def test_knn_k1_stays_on_the_nearest_kernel(monkeypatch):
    """k = 1 goes through the dense nearest wrapper (kernel 9); k > 1
    launches no kernel."""
    calls = []
    nearest = dense_kernels.tile_nearest
    monkeypatch.setattr(dense_kernels, "tile_nearest",
                        lambda *a, **kw: calls.append(1) or nearest(*a, **kw))
    rng = np.random.default_rng(11)
    q, d = _lattice_cloud(rng, 64), _lattice_cloud(rng, 128)
    m_q, m_d = np.ones(64, bool), np.ones(128, bool)
    T.knn(_t(q), _t(m_q), _t(d), _t(m_d), k=1)
    assert calls == [1]
    T.knn(_t(q), _t(m_q), _t(d), _t(m_d), k=4)
    assert calls == [1]


# ---------------------------------------------------------------------------
# entropy_scores_window: banded and dense routes
# ---------------------------------------------------------------------------

def _window(rng, n, frames=5, lattice=True):
    """A drifting cloud over ``frames`` frames: most points move 2 cm a
    frame, a tenth jump, so the counts spread over the window."""
    base = rng.uniform(-12, 12, (n, 3)).astype(np.float32)
    base[:, 2] *= 0.1
    out = []
    for f in range(frames):
        pts = base + np.float32(0.02 * f)
        jump = rng.random(n) < 0.1
        pts[jump] += rng.normal(0, 0.5, (int(jump.sum()), 3)).astype(np.float32)
        if lattice:
            pts = np.round(pts / 0.005).astype(np.float32) * np.float32(0.005)
        out.append(pts)
    win = np.stack(out).astype(np.float32)
    mask = rng.random(win.shape[:2]) > 0.05
    return win, mask


@pytest.fixture
def launches(monkeypatch):
    """Calls of the banded count (kernel 1) and the dense count (kernel
    6) wrappers."""
    calls = {"banded_tile_count": 0, "tile_radius_count": 0}
    from vilgod_tpu_torch.ops import banded
    count1, count6 = kernels.banded_tile_count, dense_kernels.tile_radius_count

    def k1(*a, **kw):
        calls["banded_tile_count"] += 1
        return count1(*a, **kw)

    def k6(*a, **kw):
        calls["tile_radius_count"] += 1
        return count6(*a, **kw)

    monkeypatch.setattr(banded.kernels, "banded_tile_count", k1)
    monkeypatch.setattr(dense_kernels, "tile_radius_count", k6)
    return calls


def test_entropy_scores_window_banded_route(launches):
    """8192-point frames, radius 0.3 m: the banded count (kernel 1), one
    call per window frame; counts exact, so the scores are within 1e-6
    (the log and the division may round differently)."""
    rng = np.random.default_rng(12)
    win, mask = _window(rng, 8192, frames=4)
    seek = 2
    q, qm = win[seek], mask[seek]
    j = _np(J.entropy_scores_window(jnp.asarray(q), jnp.asarray(qm),
                                    jnp.asarray(win), jnp.asarray(mask),
                                    jnp.asarray(seek)))
    t = T.entropy_scores_window(_t(q), _t(qm), _t(win), _t(mask), seek)
    assert launches == {"banded_tile_count": 4, "tile_radius_count": 0}
    np.testing.assert_allclose(t.numpy(), j, atol=1e-6)
    assert (t.numpy()[~qm] == 1.0).all() and (t.numpy() < 1.0).any()


@pytest.fixture
def jax_dense(monkeypatch):
    """The JAX package's dense Pallas branches interpreted on the CPU (as
    in test_torch_dense.py); nothing in the package changes."""
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


@pytest.mark.parametrize("exclude_self_frame", [True, False])
def test_entropy_scores_window_dense_route(jax_dense, launches,
                                           exclude_self_frame):
    """1000-point frames (not a tile multiple): the dense count (kernel 6)
    against JAX's interpreted Pallas kernel, on off-lattice points (XLA's
    CPU contraction breaks exact lattice ties, ROADMAP faults): counts
    exact, scores within 1e-6."""
    rng = np.random.default_rng(13)
    win, mask = _window(rng, 1000, frames=3, lattice=False)
    seek = 0
    q, qm = win[seek], mask[seek]
    kw = dict(radius=0.3, max_neighbor_points=40,
              exclude_self_frame=exclude_self_frame)
    j = _np(J.entropy_scores_window(jnp.asarray(q), jnp.asarray(qm),
                                    jnp.asarray(win), jnp.asarray(mask),
                                    jnp.asarray(seek), **kw))
    t = T.entropy_scores_window(_t(q), _t(qm), _t(win), _t(mask), seek, **kw)
    assert launches == {"banded_tile_count": 0, "tile_radius_count": 3}
    np.testing.assert_allclose(t.numpy(), j, atol=1e-6)
