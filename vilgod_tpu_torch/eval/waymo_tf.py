"""Optional official Waymo TF metrics (certification path); the port's
own copy of ``vilgod_tpu/eval/waymo_tf.py``.

The reference computes AP through the TensorFlow waymo-open-dataset
metric ops (its ``waymo_eval.py:126-231``). That
package is optional, so the first-class evaluation here is the numpy
implementation in :mod:`detection_metrics`; this module keeps a
gated adapter so environments that DO have ``waymo_open_dataset`` can
certify numbers against the official library with the exact config the
reference builds (`waymo_eval.py:95-124`): OBJECT_TYPE breakdown,
configurable difficulty levels, Hungarian matcher, per-class IoU
thresholds, 101 score cutoffs.
"""
from __future__ import annotations

import numpy as np

from .detection_metrics import WAYMO_CLASSES, _assign_difficulty


def tf_available() -> bool:
    try:
        import tensorflow  # noqa: F401
        from waymo_open_dataset.metrics.ops import py_metrics_ops  # noqa: F401
        return True
    except ImportError:
        return False


def _flatten(det_annos, gt_annos, class_names):
    """Frame-indexed flat tensors in the layout the TF ops expect
    (waymo_eval.py:30-93)."""
    fid_d, box_d, typ_d, score_d = [], [], [], []
    fid_g, box_g, typ_g, diff_g = [], [], [], []
    for i, (det, gt) in enumerate(zip(det_annos, gt_annos)):
        names = np.asarray(det["name"])
        boxes = np.asarray(det["boxes_lidar"], np.float32).reshape(-1, 7)
        for j, name in enumerate(names):
            if name in class_names:
                fid_d.append(i)
                box_d.append(boxes[j])
                typ_d.append(WAYMO_CLASSES.index(name))
                score_d.append(float(np.asarray(det["score"]).reshape(-1)[j]))
        diff = _assign_difficulty(gt)
        gnames = np.asarray(gt["name"])
        gboxes = np.asarray(gt["gt_boxes_lidar"], np.float32).reshape(-1, 7)
        npts = np.asarray(gt["num_points_in_gt"])
        for j, name in enumerate(gnames):
            if name in class_names and npts[j] > 0:
                fid_g.append(i)
                box_g.append(gboxes[j])
                typ_g.append(WAYMO_CLASSES.index(name))
                diff_g.append(int(diff[j]))
    z = np.zeros((0, 7), np.float32)
    return (np.asarray(fid_d, np.int64), np.stack(box_d) if box_d else z,
            np.asarray(typ_d, np.uint8), np.asarray(score_d, np.float32),
            np.asarray(fid_g, np.int64), np.stack(box_g) if box_g else z,
            np.asarray(typ_g, np.uint8), np.asarray(diff_g, np.int8))


def waymo_tf_ap(det_annos, gt_annos, class_names=("Vehicle", "Pedestrian",
                                                  "Cyclist"),
                iou_thresholds=(0.4, 0.4, 0.4, 0.4),
                difficulties=(2,)) -> dict:
    """Run the official TF detection metrics. Raises ImportError when the
    waymo-open-dataset package is absent — use
    :func:`vilgod_tpu_torch.eval.waymo_detection_ap` there instead."""
    import tensorflow as tf
    from waymo_open_dataset import label_pb2
    from waymo_open_dataset.metrics.python import detection_metrics
    from waymo_open_dataset.protos import breakdown_pb2, metrics_pb2

    config = metrics_pb2.Config()
    config.breakdown_generator_ids.append(breakdown_pb2.Breakdown.OBJECT_TYPE)
    difficulty = config.difficulties.add()
    if 1 in difficulties or not difficulties:
        difficulty.levels.append(label_pb2.Label.LEVEL_1)
    if 2 in difficulties:
        difficulty.levels.append(label_pb2.Label.LEVEL_2)
    config.matcher_type = metrics_pb2.MatcherProto.TYPE_HUNGARIAN
    config.iou_thresholds.append(0.0)
    for t in iou_thresholds:
        config.iou_thresholds.append(t)
    config.box_type = label_pb2.Label.Box.TYPE_3D
    for x in range(100):
        config.score_cutoffs.append(x * 0.01)
    config.score_cutoffs.append(1.0)

    (fid_d, box_d, typ_d, score_d,
     fid_g, box_g, typ_g, diff_g) = _flatten(det_annos, gt_annos, class_names)

    metrics = detection_metrics.get_detection_metric_ops(
        config=config,
        prediction_frame_id=tf.constant(fid_d),
        prediction_bbox=tf.constant(box_d),
        prediction_type=tf.constant(typ_d),
        prediction_score=tf.constant(score_d),
        prediction_overlap_nlz=tf.zeros_like(tf.constant(fid_d), tf.bool),
        ground_truth_frame_id=tf.constant(fid_g),
        ground_truth_bbox=tf.constant(box_g),
        ground_truth_type=tf.constant(typ_g),
        ground_truth_difficulty=tf.constant(diff_g, tf.uint8),
    )
    return {k: float(np.asarray(v[0]).reshape(-1)[0]) for k, v in metrics.items()}
