"""The port's filter stage (vilgod_tpu_torch: ops/plane.py, the by-label
statistics of ops/segment.py, filter_detections) against the JAX package
on the same numpy inputs: the RANSAC ground plane for the same key, the
by-label min / max / count / hull area, and the filter's valid flags on
the verify scene from JAX's own upstream buffers."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from vilgod_tpu.config.presets import waymo_config as jax_waymo_config
from vilgod_tpu.data import SyntheticDataset as JaxSyntheticDataset
from vilgod_tpu.ops import plane as JP
from vilgod_tpu.ops import segment as JS
from vilgod_tpu.pipeline import stages_geometry as JG
from vilgod_tpu.pipeline.runner import ZeroShotDetector as JaxDetector
from vilgod_tpu_torch.config import waymo_config
from vilgod_tpu_torch.data import SyntheticDataset
from vilgod_tpu_torch.ops import plane as TP
from vilgod_tpu_torch.ops import random as R
from vilgod_tpu_torch.ops import segment as TS
from vilgod_tpu_torch.pipeline import stages_geometry as TG
from vilgod_tpu_torch.pipeline.runner import ZeroShotDetector
from vilgod_tpu_torch.pipeline.stages_geometry import (filter_detections,
                                                       rebuild_ng_buffers)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per pytest worker (see test_torch_slice.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ground_scene(seed, total=4096):
    """A tilted noisy ground plane plus a box of wall points, zero padded."""
    rng = np.random.default_rng(seed)
    n = 2500
    xy = rng.uniform(-20, 20, size=(n, 2))
    z = (0.05 * xy[:, 0] - 0.02 * xy[:, 1] + 1.0
         + rng.normal(scale=0.02, size=n))
    ground = np.column_stack([xy, z])
    wall = rng.uniform(-1, 1, size=(400, 3)) * [1, 1, 3] + [5, 5, 4]
    pts = np.zeros((total, 3), np.float32)
    pts[:n + 400] = np.concatenate([ground, wall])
    mask = np.zeros(total, bool)
    mask[:n + 400] = True
    return pts, mask


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fit_ground_plane_matches_jax(seed):
    """Same key -> the same Gumbel triples, inlier sets and refit: the
    plane within 1e-5 (the refit's eigenproblem is f64 in the port, f32 in
    JAX)."""
    pts, mask = _ground_scene(seed)
    key_j = jax.random.fold_in(jax.random.PRNGKey(666), seed)
    key_t = R.fold_in(R.PRNGKey(666), seed)
    want = np.asarray(JP.fit_ground_plane(jnp.asarray(pts), jnp.asarray(mask),
                                          key_j, 0.1, 100))
    got = TP.fit_ground_plane(torch.from_numpy(pts), torch.from_numpy(mask),
                              key_t, 0.1, 100).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # one RANSAC stage: the same best plane and the same inliers
    pj, ij = JP.ransac_plane(jnp.asarray(pts), jnp.asarray(mask), key_j)
    pt, it = TP.ransac_plane(torch.from_numpy(pts), torch.from_numpy(mask),
                             key_t)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))


def test_ransac_skips_masked_points():
    """Masked points never enter a triple while three valid points exist:
    with three valid points every iteration draws exactly them."""
    pts = np.random.default_rng(0).normal(size=(64, 3)).astype(np.float32)
    mask = np.zeros(64, bool)
    mask[[5, 17, 40]] = True
    plane, inl = TP.ransac_plane(torch.from_numpy(pts), torch.from_numpy(mask),
                                 R.PRNGKey(3))
    want = TP.plane_from_triplet(*(torch.from_numpy(pts[i]) for i in (5, 17, 40)))
    np.testing.assert_allclose(torch.abs(plane).numpy(),
                               torch.abs(want).numpy(), atol=1e-6)
    assert set(np.flatnonzero(inl.numpy())) == {5, 17, 40}


def test_minmax_count_by_label_equal_jax():
    rng = np.random.default_rng(4)
    n, c = 4096, 12
    labels = rng.integers(-1, c, n).astype(np.int32)
    valid = (rng.random(n) < 0.9) & (labels >= 0)
    labels[labels == 7] = -1          # one empty label
    pts = rng.normal(0, 4, (n, 3)).astype(np.float32)
    args_j = (jnp.asarray(labels), jnp.asarray(valid), c)
    args_t = (torch.from_numpy(labels), torch.from_numpy(valid), c)
    for vals in (pts, pts[:, 2]):
        for fj, ft, fill in ((JS.seg_min_by_label, TS.seg_min_by_label, 1e9),
                             (JS.seg_max_by_label, TS.seg_max_by_label, -1e9)):
            np.testing.assert_array_equal(
                ft(torch.from_numpy(vals), *args_t, fill=fill).numpy(),
                np.asarray(fj(jnp.asarray(vals), *args_j, fill=fill)))
    np.testing.assert_array_equal(TS.seg_count_by_label(*args_t).numpy(),
                                  np.asarray(JS.seg_count_by_label(*args_j)))


def test_hull_area_by_label_matches_jax():
    """Support-function hull areas within 1e-4 relative (the projections
    are f32 products in both; only their summation order differs)."""
    rng = np.random.default_rng(5)
    n, c = 6000, 16
    labels = rng.integers(-1, c, n).astype(np.int32)
    valid = rng.random(n) < 0.9
    centers = rng.uniform(-30, 30, (c, 2))
    xy = (centers[np.clip(labels, 0, None)]
          + rng.normal(0, 1.5, (n, 2))).astype(np.float32)
    labels[:5] = 15
    labels[labels == 15] = -1
    labels[:2] = 15                       # a label with 2 points: area 0
    valid[:2] = True
    want = np.asarray(JS.hull_area_by_label(
        jnp.asarray(xy), jnp.asarray(labels), jnp.asarray(valid), c))
    got = TS.hull_area_by_label(torch.from_numpy(xy), torch.from_numpy(labels),
                                torch.from_numpy(valid), c).numpy()
    assert want[15] == 0 and got[15] == 0
    assert (want[:15] > 1.0).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0)


CAP = {"max_points": 16384, "max_ng_points": 8192, "max_clusters": 64,
       "max_cluster_points": 4096, "max_tracks": 64,
       "max_cluster_input": 8192, "clip_batch": 8}
SCENE = dict(n_sequences=1, n_frames=16, seed=12, n_ground=3000,
             n_vehicles=2, n_pedestrians=1, n_moving=1)
STAGES = ["mask_ground_points", "calculate_entropy_scores",
          "spatial_clustering", "filter_detections"]
# the single-device JAX paths are the ones the port mirrors
PARALLEL = {"shard_frames": False, "shard_ground": False,
            "shard_cluster": False, "shard_filter": False}


def _capturing(module, name, store, monkeypatch):
    """Patch ``module.name`` to keep the result of its call in ``store``."""
    fn = getattr(module, name)

    def wrapper(*args, **kwargs):
        store.update(fn(*args, **kwargs))
        return store
    monkeypatch.setattr(module, name, wrapper)


def test_filter_detections_matches_jax_from_its_buffers(monkeypatch):
    """The port's filter over JAX's own stage-1..3 buffers on the verify
    scene gives JAX's valid flags and ground planes, from the same
    metrics."""
    want, got = {}, {}
    _capturing(JG, "filter_metrics_all", want, monkeypatch)
    _capturing(TG, "filter_metrics_all", got, monkeypatch)
    jcfg = jax_waymo_config(capacity=CAP, pipeline_active=STAGES,
                            parallel=PARALLEL)
    zj = JaxDetector(JaxSyntheticDataset(**SCENE).sequence("synth_0"),
                     "synth_0", jcfg)
    zj.process()
    j = zj.state

    cfg = waymo_config(capacity=CAP, pipeline_active=[])
    zt = ZeroShotDetector(SyntheticDataset(**SCENE).sequence("synth_0"),
                          "synth_0", cfg, device="cpu")
    t = zt.state
    for name in ("ground_mask", "labels", "probs", "ng_entropy"):
        getattr(t, "_h_" + name)[...] = getattr(j, name)
    for name in ("det_n", "det_center", "det_static"):
        getattr(t, name)[...] = getattr(j, name)
    t.det_valid[...] = t.det_n > 0
    t._dev.clear()
    t._canon.clear()
    rebuild_ng_buffers(t)
    filter_detections(t, cfg)
    np.testing.assert_allclose(t.plane_ref, j.plane_ref, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(t.det_valid, j.det_valid)
    assert j.det_valid.sum(axis=1).min() >= 3  # the scene's objects

    # the metrics the flags come from (the scene's filters keep every
    # detection, so compare them directly); 16 frames, no padded frame
    for k in ("height", "size"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    # ephe_p: the percentile's interpolation rounds once more without FMA
    for k in ("plane", "dmin", "dmax", "ephe_p"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-5, rtol=0, err_msg=k)
    # a small cluster ~20 m from the origin: its shoelace sum over 720
    # support vertices cancels from ~400 m^2 terms to ~1 m^2, which JAX sums
    # in f32 and the port in f64 (1e-4 holds for the unit test above)
    np.testing.assert_allclose(got["hull_area"].numpy(),
                               np.asarray(want["hull_area"]), rtol=1e-3,
                               atol=1e-6)
