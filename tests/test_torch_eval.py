"""The port's sequence evaluation and TF-metrics adapter
(vilgod_tpu_torch/eval/{sequence_eval,waymo_tf}.py) against the JAX
package's: tests/test_eval.py's sequence cases and seeded random frames
give equal dataclasses (numpy in both, so every float is equal), and the
TF adapter builds the reference config against tests/test_waymo_tf.py's
mocked ``waymo_open_dataset``."""
import dataclasses

import numpy as np
import pytest

from vilgod_tpu.eval import sequence_eval as JE
from vilgod_tpu.eval import waymo_tf as JT
from vilgod_tpu_torch import eval as T
from vilgod_tpu_torch.eval import sequence_eval as TE
from vilgod_tpu_torch.eval import waymo_tf as TT

from test_eval import BOX_A, BOX_B
from test_waymo_tf import _annos, _install_mock


def _summary(ev):
    return {
        "rows": [dataclasses.asdict(r) for r in ev.cluster_filtered_tracked_results],
        "moving": [dataclasses.asdict(a) for a in ev.cluster_moving_accuracy],
        "means": [dataclasses.asdict(ev.cluster_results_mean()),
                  dataclasses.asdict(ev.cluster_filtered_results_mean()),
                  dataclasses.asdict(ev.cluster_filtered_tracked_results_mean())],
        "moving_pr": (ev.cluster_moving_precision_mean(),
                      ev.cluster_moving_recall_mean()),
        "moving_counts": (ev.cluster_moving_tp(), ev.cluster_moving_fp(),
                          ev.cluster_moving_fn()),
    }


def _both(results, gt, **kw):
    j = JE.evaluate_sequence_quality(results, gt, **kw)
    t = T.evaluate_sequence_quality(results, gt, **kw)
    assert isinstance(t, T.SequenceEvaluation)
    assert _summary(t) == _summary(j)
    return t


def test_sequence_eval_cases_match_jax():
    """tests/test_eval.py's cases: perfect frames, then a missed moving
    GT."""
    gt0 = {"gt_boxes_lidar": np.array([BOX_A, BOX_B], np.float32),
           "moving": np.array([True, False]),
           "num_points_in_gt": np.array([100, 50])}
    det_perfect = {"boxes_lidar": np.array([BOX_A, BOX_B], np.float32),
                   "moving": np.array([True, False])}
    ev = _both([det_perfect], [gt0])
    assert ev.cluster_filtered_tracked_results_mean().box_recall == 1.0
    det_partial = {"boxes_lidar": np.array([BOX_B], np.float32),
                   "moving": np.array([False])}
    ev2 = _both([det_perfect, det_partial], [gt0, gt0])
    assert ev2.cluster_moving_fn() == 1 and ev2.cluster_moving_tp() == 1
    assert ev2.cluster_filtered_tracked_results_mean().point_recall == \
        pytest.approx((1.0 + 50.0 / 150.0) / 2)


def test_sequence_eval_edge_frames_match_jax():
    """Empty GT, empty detections, no point counts, no moving flags."""
    empty_det = {"boxes_lidar": np.zeros((0, 7), np.float32)}
    gt_a = {"gt_boxes_lidar": np.array([BOX_A], np.float32)}
    empty_gt = {"gt_boxes_lidar": np.zeros((0, 7))}
    det_a = {"boxes_lidar": np.array([BOX_A], np.float32),
             "moving": np.array([True])}
    _both([empty_det, det_a, det_a, {}], [gt_a, empty_gt, gt_a, {}])
    assert T.evaluate_sequence_quality([], []).cluster_moving_precision_mean() == 0.0


def test_sequence_eval_random_frames_match_jax():
    """Seeded random frames: greedy centre matching (within 2 m, or 0.7 m)
    with ties, moving flags and point weights."""
    rng = np.random.default_rng(0)
    results, gt = [], []
    for _ in range(12):
        n_gt, n_det = rng.integers(0, 7), rng.integers(0, 7)
        g = np.zeros((n_gt, 7), np.float32)
        g[:, :2] = rng.uniform(-10, 10, (n_gt, 2))
        d = np.zeros((n_det, 7), np.float32)
        d[:, :2] = rng.uniform(-10, 10, (n_det, 2))
        d[: min(n_det, n_gt), :2] = g[: min(n_det, n_gt), :2] + rng.normal(
            0, 0.8, (min(n_det, n_gt), 2))
        results.append({"boxes_lidar": d, "moving": rng.random(n_det) > 0.5})
        gt.append({"gt_boxes_lidar": g, "moving": rng.random(n_gt) > 0.5,
                   "num_points_in_gt": rng.integers(0, 200, n_gt)})
    for dist in (2.0, 0.7):
        _both(results, gt, max_center_dist=dist)
    d_xy = rng.uniform(0, 4, (9, 2))
    g_xy = rng.uniform(0, 4, (7, 2))
    np.testing.assert_array_equal(TE._greedy_center_match(d_xy, g_xy, 1.0),
                                  JE._greedy_center_match(d_xy, g_xy, 1.0))


def test_tf_adapter_flatten_matches_jax():
    det, gt = _annos()
    classes = ("Vehicle", "Pedestrian", "Cyclist")
    for a, b in zip(TT._flatten(det, gt, classes), JT._flatten(det, gt, classes)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert TT.tf_available() == JT.tf_available()


def test_tf_adapter_builds_reference_config(monkeypatch):
    """tests/test_waymo_tf.py's mocked waymo_open_dataset, driven by the
    port's adapter: the reference config (OBJECT_TYPE breakdown, LEVEL_2,
    Hungarian, IoU thresholds with the leading 0.0, 101 score cutoffs) and
    the same tensors as the JAX adapter passes."""
    captured = {}
    _install_mock(monkeypatch, captured)
    det, gt = _annos()
    assert TT.waymo_tf_ap(det, gt) == {"OBJECT_TYPE_TYPE_VEHICLE_LEVEL_2/AP": 0.625}
    cfg, kw = captured["config"], captured["kwargs"]
    assert cfg.breakdown_generator_ids == [11]
    assert [d.levels for d in cfg._difficulties] == [[2]]
    assert cfg.matcher_type == 7
    assert cfg.iou_thresholds == [0.0, 0.4, 0.4, 0.4, 0.4]
    assert cfg.box_type == 3
    assert len(cfg.score_cutoffs) == 101
    assert cfg.score_cutoffs[0] == 0.0 and cfg.score_cutoffs[-1] == 1.0
    jax_captured = {}
    _install_mock(monkeypatch, jax_captured)
    JT.waymo_tf_ap(det, gt)
    for k, v in jax_captured["kwargs"].items():
        np.testing.assert_array_equal(kw[k], v, err_msg=k)
    # LEVEL_1 and LEVEL_2 together, other thresholds
    TT.waymo_tf_ap(det, gt, iou_thresholds=(0.7, 0.5, 0.5, 0.5),
                   difficulties=(1, 2))
    cfg = jax_captured["config"]
    assert [d.levels for d in cfg._difficulties] == [[1, 2]]
    assert cfg.iou_thresholds == [0.0, 0.7, 0.5, 0.5, 0.5]


def test_tf_adapter_unavailable_raises():
    """Without the package ``tf_available`` is false and the adapter
    raises ImportError (the numpy AP is the first-class path)."""
    if TT.tf_available():
        pytest.skip("waymo_open_dataset is installed")
    with pytest.raises(ImportError):
        TT.waymo_tf_ap(*_annos())
