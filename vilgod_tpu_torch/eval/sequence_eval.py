"""Per-sequence cluster-quality aggregates; the port's own copy of
``vilgod_tpu/eval/sequence_eval.py`` (numpy only).

Equivalent of the reference's evaluation dataclasses (its
``dataclass/evaluation.py:5-58``): per-frame cluster
recall/precision rows plus a moving-flag confusion aggregate, with the
same mean/sum reducers. The reference declares these containers but never
instantiates them (its imports at `eval_utils.py:7` and
`lidar_frame.py:11` are dead); here they are computed from a pipeline
run's detection dicts + ground-truth annos, so intermediate pipeline
quality (before the AP protocol) is actually observable.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class ClusterResult:
    """One frame's cluster-vs-GT quality (evaluation.py:6-10)."""
    point_recall: float = 0.0
    box_recall: float = 0.0
    box_precision: float = 0.0


@dataclass
class Accuracy:
    """Binary-flag confusion counts (evaluation.py:12-18)."""
    tp: int
    fp: int
    fn: int
    precision: float | None
    recall: float | None


@dataclass
class SequenceEvaluation:
    """Per-sequence aggregate of frame rows (evaluation.py:20-58)."""
    cluster_results: list = field(default_factory=list)
    cluster_filtered_results: list = field(default_factory=list)
    cluster_filtered_tracked_results: list = field(default_factory=list)
    cluster_moving_accuracy: list = field(default_factory=list)

    @staticmethod
    def _mean(rows: list) -> ClusterResult:
        if not rows:
            return ClusterResult()
        return ClusterResult(
            point_recall=float(np.mean([r.point_recall for r in rows])),
            box_recall=float(np.mean([r.box_recall for r in rows])),
            box_precision=float(np.mean([r.box_precision for r in rows])))

    def cluster_results_mean(self) -> ClusterResult:
        return self._mean(self.cluster_results)

    def cluster_filtered_results_mean(self) -> ClusterResult:
        return self._mean(self.cluster_filtered_results)

    def cluster_filtered_tracked_results_mean(self) -> ClusterResult:
        return self._mean(self.cluster_filtered_tracked_results)

    def cluster_moving_precision_mean(self) -> float:
        vals = [a.precision for a in self.cluster_moving_accuracy
                if a.precision is not None]
        return float(np.mean(vals)) if vals else 0.0

    def cluster_moving_recall_mean(self) -> float:
        vals = [a.recall for a in self.cluster_moving_accuracy
                if a.recall is not None]
        return float(np.mean(vals)) if vals else 0.0

    def cluster_moving_tp(self) -> int:
        return int(sum(a.tp for a in self.cluster_moving_accuracy))

    def cluster_moving_fp(self) -> int:
        return int(sum(a.fp for a in self.cluster_moving_accuracy))

    def cluster_moving_fn(self) -> int:
        return int(sum(a.fn for a in self.cluster_moving_accuracy))


def _greedy_center_match(det_xy: np.ndarray, gt_xy: np.ndarray,
                         max_dist: float) -> np.ndarray:
    """Greedy nearest-center matching; returns per-GT matched det index
    (-1 unmatched). Each detection claims at most one GT."""
    m = np.full(len(gt_xy), -1, np.int64)
    if not len(det_xy) or not len(gt_xy):
        return m
    d = np.linalg.norm(det_xy[:, None, :] - gt_xy[None, :, :], axis=2)
    taken = np.zeros(len(det_xy), bool)
    for _ in range(min(len(det_xy), len(gt_xy))):
        i, j = np.unravel_index(np.argmin(d), d.shape)
        if d[i, j] > max_dist:
            break
        m[j] = i
        taken[i] = True
        d[i, :] = np.inf
        d[:, j] = np.inf
    return m


def frame_cluster_result(det_boxes: np.ndarray, gt_boxes: np.ndarray,
                         num_points_in_gt: np.ndarray | None = None,
                         max_center_dist: float = 2.0) -> ClusterResult:
    """One frame's box recall/precision by greedy center matching.

    ``point_recall`` is approximated as the point-weighted box recall
    (matched GT points / total GT points) when per-GT point counts are
    available — the fraction of annotated points covered by some cluster.
    """
    if len(gt_boxes) == 0:
        return ClusterResult(point_recall=1.0, box_recall=1.0,
                             box_precision=0.0 if len(det_boxes) else 1.0)
    match = _greedy_center_match(det_boxes[:, :2] if len(det_boxes) else
                                 np.zeros((0, 2)), gt_boxes[:, :2],
                                 max_center_dist)
    hit = match >= 0
    box_recall = float(np.mean(hit))
    box_precision = (float(np.sum(hit)) / len(det_boxes)
                     if len(det_boxes) else 0.0)
    if num_points_in_gt is not None and np.sum(num_points_in_gt) > 0:
        pts = np.asarray(num_points_in_gt, np.float64)
        point_recall = float(np.sum(pts[hit]) / np.sum(pts))
    else:
        point_recall = box_recall
    return ClusterResult(point_recall=point_recall, box_recall=box_recall,
                         box_precision=box_precision)


def frame_moving_accuracy(det_boxes: np.ndarray, det_moving: np.ndarray,
                          gt_boxes: np.ndarray, gt_moving: np.ndarray,
                          max_center_dist: float = 2.0) -> Accuracy:
    """Moving-flag confusion over matched det/GT pairs."""
    match = _greedy_center_match(det_boxes[:, :2] if len(det_boxes) else
                                 np.zeros((0, 2)),
                                 gt_boxes[:, :2] if len(gt_boxes) else
                                 np.zeros((0, 2)), max_center_dist)
    tp = fp = fn = 0
    for j, i in enumerate(match):
        if i < 0:
            fn += int(bool(gt_moving[j]))
            continue
        d, g = bool(det_moving[i]), bool(gt_moving[j])
        tp += int(d and g)
        fp += int(d and not g)
        fn += int(g and not d)
    precision = tp / (tp + fp) if (tp + fp) else None
    recall = tp / (tp + fn) if (tp + fn) else None
    return Accuracy(tp=tp, fp=fp, fn=fn, precision=precision, recall=recall)


def evaluate_sequence_quality(results: list[dict], gt_annos: list[dict],
                              max_center_dist: float = 2.0
                              ) -> SequenceEvaluation:
    """Build a :class:`SequenceEvaluation` from frame-aligned pipeline
    results (``boxes_lidar``/``moving``) and GT annos
    (``gt_boxes_lidar``/``moving``/``num_points_in_gt``)."""
    ev = SequenceEvaluation()
    for det, gt in zip(results, gt_annos):
        det_boxes = np.asarray(det.get("boxes_lidar",
                                       np.zeros((0, 7)))).reshape(-1, 7)
        gt_boxes = np.asarray(gt.get("gt_boxes_lidar",
                                     np.zeros((0, 7)))).reshape(-1, 7)
        ev.cluster_filtered_tracked_results.append(frame_cluster_result(
            det_boxes, gt_boxes, gt.get("num_points_in_gt"),
            max_center_dist))
        det_moving = np.asarray(det.get("moving",
                                        np.zeros(len(det_boxes), bool)))
        gt_moving = np.asarray(gt.get("moving",
                                      np.zeros(len(gt_boxes), bool)))
        ev.cluster_moving_accuracy.append(frame_moving_accuracy(
            det_boxes, det_moving, gt_boxes, gt_moving, max_center_dist))
    return ev
