"""Waymo-protocol detection AP / APH in numpy and scipy; the port's own
copy of ``vilgod_tpu/eval/detection_metrics.py``, with its rotated IoU
from the port's ``ops/boxes.iou3d_matrix``.

- GT difficulty: L1 if ``num_points_in_gt > 5`` else L2; zero-point boxes
  dropped; LEVEL_2 counts both;
- per-frame Hungarian matching on rotated 3D IoU with per-class
  thresholds, re-matched at every score cutoff (the detections kept at a
  cutoff are a prefix of the score-sorted order);
- 101 score cutoffs 0.00..0.99 and 1.0; AP is the area under the
  precision/recall curve with precision made non-increasing;
- APH weights each true positive by ``1 - |wrap(yaw_det - yaw_gt)| / pi``.

Like the JAX package's, this follows the official metric's documented
recipe and is not certified against the TensorFlow implementation.
"""
from __future__ import annotations

import numpy as np
from scipy.optimize import linear_sum_assignment

WAYMO_CLASSES = ("unknown", "Vehicle", "Pedestrian", "Sign", "Cyclist")


def _iou3d(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    """Rotated 3D IoU in float32 from the port's ``iou3d_matrix`` (CPU)."""
    if len(boxes_a) == 0 or len(boxes_b) == 0:
        return np.zeros((len(boxes_a), len(boxes_b)))
    import torch

    from ..ops.boxes import iou3d_matrix
    return iou3d_matrix(
        torch.as_tensor(np.asarray(boxes_a)[:, :7], dtype=torch.float32),
        torch.as_tensor(np.asarray(boxes_b)[:, :7], dtype=torch.float32)
    ).numpy()


def _wrap_angle(a: np.ndarray) -> np.ndarray:
    return np.abs(np.mod(a + np.pi, 2 * np.pi) - np.pi)


def _assign_difficulty(gt: dict) -> np.ndarray:
    """L1 if num_points_in_gt > 5 else L2; respects a pre-set nonzero
    difficulty column."""
    n = len(gt["name"])
    diff = np.array(gt.get("difficulty", np.zeros(n)), dtype=np.int8).copy()
    npts = np.asarray(gt["num_points_in_gt"])
    zero = diff == 0
    diff[(npts > 5) & zero] = 1
    diff[(npts <= 5) & zero] = 2
    return diff


def _match_prefixes(det_boxes, det_scores, gt_boxes, iou_thresh):
    """Exact per-cutoff Hungarian matching for one frame & class.

    The detections kept at any score cutoff are a *prefix* of the
    score-descending order, so one Hungarian per prefix length k
    reproduces the official metric's per-cutoff re-matching exactly.

    Returns (sorted_scores (D,) desc, tp (D+1,), tp_heading (D+1,)):
    ``tp[k]`` is the matched count when the top-k detections are kept.
    """
    d, g = len(det_boxes), len(gt_boxes)
    order = np.argsort(-det_scores, kind="stable")
    boxes = det_boxes[order]
    scores = det_scores[order]
    tp = np.zeros(d + 1, np.int64)
    tp_h = np.zeros(d + 1)
    if d == 0 or g == 0:
        return scores, tp, tp_h
    iou = _iou3d(boxes, gt_boxes)
    h_acc = np.maximum(0.0, 1.0 - _wrap_angle(
        boxes[:, 6:7] - gt_boxes[None, :, 6]) / np.pi)
    cost = -iou
    cost[iou < iou_thresh] = 1e6
    for k in range(1, d + 1):
        rows, cols = linear_sum_assignment(cost[:k])
        ok = iou[rows, cols] >= iou_thresh
        tp[k] = int(np.sum(ok))
        tp_h[k] = float(np.sum(h_acc[rows, cols][ok]))
    return scores, tp, tp_h


def _pr_to_ap(recall: np.ndarray, precision: np.ndarray) -> float:
    """Area under p(r) with precision forced monotone non-increasing in
    recall (the official ComputeMeanAveragePrecision recipe)."""
    order = np.argsort(recall)
    r = np.concatenate([[0.0], recall[order]])
    p = np.concatenate([[precision[order][0] if len(order) else 0.0],
                        precision[order]])
    # make precision non-increasing as recall grows
    for i in range(len(p) - 2, -1, -1):
        p[i] = max(p[i], p[i + 1])
    return float(np.sum(np.diff(r) * p[1:]))


# Official RANGE breakdown shards (waymo_open_dataset breakdown/range):
# box-center range buckets, labels as the TF metric names them.
RANGE_BUCKETS = (("[0, 30)", 0.0, 30.0), ("[30, 50)", 30.0, 50.0),
                 ("[50, +inf)", 50.0, np.inf))


def _range_mask(boxes: np.ndarray, lo: float, hi: float) -> np.ndarray:
    r = np.linalg.norm(boxes[:, :3], axis=1)
    return (r >= lo) & (r < hi)


def _ap_for_subset(det_annos, gt_annos, cls, thresh, level, cutoffs,
                   range_bucket=None):
    """AP/APH for one (class, level[, range bucket]) shard via exact
    per-cutoff prefix-Hungarian matching."""
    frame_data = []
    total_gt = 0
    for det, gt in zip(det_annos, gt_annos):
        diff = _assign_difficulty(gt)
        npts = np.asarray(gt["num_points_in_gt"])
        gmask = (np.asarray(gt["name"]) == cls) & (npts > 0) & (diff <= level)
        gt_boxes = np.asarray(gt["gt_boxes_lidar"], np.float64).reshape(-1, 7)[gmask]
        dmask = np.asarray(det["name"]) == cls
        det_boxes = np.asarray(det["boxes_lidar"], np.float64).reshape(-1, 7)[dmask]
        det_scores = np.asarray(det["score"], np.float64).reshape(-1)[dmask]
        if range_bucket is not None:
            lo, hi = range_bucket
            gt_boxes = gt_boxes[_range_mask(gt_boxes, lo, hi)]
            keep = _range_mask(det_boxes, lo, hi)
            det_boxes, det_scores = det_boxes[keep], det_scores[keep]
        scores, tp_k, tph_k = _match_prefixes(det_boxes, det_scores,
                                              gt_boxes, thresh)
        frame_data.append((scores, tp_k, tph_k))
        total_gt += len(gt_boxes)

    precisions, recalls, h_precisions = [], [], []
    for s in cutoffs:
        tp = fp = 0
        tp_h = 0.0
        for scores, tp_k, tph_k in frame_data:
            k = int(np.sum(scores >= s))  # kept dets = prefix
            tp += int(tp_k[k])
            fp += k - int(tp_k[k])
            tp_h += float(tph_k[k])
        denom = tp + fp
        precisions.append(tp / denom if denom else 0.0)
        h_precisions.append(tp_h / denom if denom else 0.0)
        recalls.append(tp / total_gt if total_gt else 0.0)
    return (_pr_to_ap(np.array(recalls), np.array(precisions)),
            _pr_to_ap(np.array(recalls), np.array(h_precisions)))


def waymo_detection_ap(det_annos: list[dict], gt_annos: list[dict],
                       class_names=("Vehicle", "Pedestrian", "Cyclist"),
                       iou_thresholds=(0.4, 0.4, 0.4, 0.4),
                       difficulties=(2,),
                       num_cutoffs: int = 101,
                       breakdown_range: bool = False) -> dict:
    """Compute per-class AP/APH over frame-aligned det/gt anno lists.

    det_annos[i]: {'boxes_lidar' (D, 7), 'name' (D,), 'score' (D,)}.
    gt_annos[i]: {'gt_boxes_lidar' (G, 7), 'name' (G,),
                  'num_points_in_gt' (G,), optional 'difficulty'}.
    iou_thresholds follow the config order [Vehicle, Pedestrian, Sign,
    Cyclist] offset into WAYMO_CLASSES.
    ``breakdown_range`` adds the optional RANGE shards of the reference
    config: per box-center-range bucket
    [0,30)/[30,50)/[50,+inf), det and gt both sharded by their own range.

    Returns {'OBJECT_TYPE_TYPE_<CLS>_LEVEL_<L>/AP': v, '... /APH': v,
    ...} plus 'RANGE_TYPE_<CLS>_<bucket>_LEVEL_<L>/AP(H)' when enabled.
    """
    cutoffs = np.concatenate([np.arange(num_cutoffs - 1) / (num_cutoffs - 1), [1.0]])
    results = {}
    thr_by_class = {WAYMO_CLASSES[i + 1]: t for i, t in enumerate(iou_thresholds)}

    for level in difficulties:
        for cls in class_names:
            thresh = thr_by_class.get(cls, 0.4)
            ap, aph = _ap_for_subset(det_annos, gt_annos, cls, thresh,
                                     level, cutoffs)
            key = f"OBJECT_TYPE_TYPE_{cls.upper()}_LEVEL_{level}"
            results[f"{key}/AP"] = ap
            results[f"{key}/APH"] = aph
            if breakdown_range:
                for rng, lo, hi in RANGE_BUCKETS:
                    ap, aph = _ap_for_subset(det_annos, gt_annos, cls,
                                             thresh, level, cutoffs,
                                             range_bucket=(lo, hi))
                    rkey = f"RANGE_TYPE_{cls.upper()}_{rng}_LEVEL_{level}"
                    results[f"{rkey}/AP"] = ap
                    results[f"{rkey}/APH"] = aph
    return results
