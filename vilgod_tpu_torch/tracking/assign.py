"""Detection-track assignment; the port's own copy of
``vilgod_tpu/tracking/assign.py`` (host-side numpy and scipy):

- :func:`assign_greedy`: sorted-distance greedy matching on BEV centres;
- :func:`assign_hungarian`: ``scipy.optimize.linear_sum_assignment`` over
  BEV centre distance or rotated 3D IoU (the port's ``iou3d_matrix`` on
  the CPU).

Cost matrices are tiny (detections x active tracks of one frame).
"""
from __future__ import annotations

import numpy as np
from scipy.optimize import linear_sum_assignment


def assign_greedy(detections: np.ndarray, tracks: np.ndarray,
                  max_distance: float = 1.0, **_):
    """Greedy sorted-distance matching on BEV centres.

    detections (D, >=2), tracks (T, >=2) -> (matches (M, 2) [det_idx,
    track_idx], det_mask (D,) distance-accepted, overlap (D,) matched
    distance)."""
    if len(detections) == 0 or len(tracks) == 0:
        return np.empty((0, 2), np.int64), np.array([], bool), np.array([])
    diff = detections[:, None, :2] - tracks[None, :, :2]
    cost = np.sqrt(np.sum(diff * diff, axis=-1))  # (D, T)
    d, t = cost.shape
    order = np.argsort(cost.reshape(-1))
    det_used = np.full(d, -1, np.int64)
    trk_used = np.full(t, -1, np.int64)
    matches = []
    for flat in order:
        di, ti = int(flat // t), int(flat % t)
        if det_used[di] == -1 and trk_used[ti] == -1:
            det_used[di] = ti
            trk_used[ti] = di
            matches.append((di, ti))
    matches = np.array(matches, np.int64).reshape(-1, 2)
    overlap = np.full(d, max_distance + 1.0)
    overlap[matches[:, 0]] = cost[matches[:, 0], matches[:, 1]]
    mask = overlap < max_distance
    return matches, mask, overlap


def _iou3d(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    import torch

    from ..ops.boxes import iou3d_matrix
    return iou3d_matrix(torch.as_tensor(boxes_a[:, :7], dtype=torch.float32),
                        torch.as_tensor(boxes_b[:, :7], dtype=torch.float32)
                        ).numpy()


def assign_hungarian(detections: np.ndarray, tracks: np.ndarray,
                     max_distance: float | None = None,
                     det_overlap_threshold: float | None = None, **_):
    """Hungarian matching over BEV distance, or over IoU when
    ``det_overlap_threshold`` is given."""
    if len(detections) == 0 or len(tracks) == 0:
        return np.empty((0, 2), np.int64), np.array([], bool), np.array([])
    if det_overlap_threshold is not None:
        iou = _iou3d(detections, tracks)
        cost = -iou
    else:
        diff = detections[:, None, :2] - tracks[None, :, :2]
        cost = np.sqrt(np.sum(diff * diff, axis=-1))
        cost[cost > max_distance] = 1e7
    rows, cols = linear_sum_assignment(cost)
    matches = np.stack([rows, cols], axis=1)
    overlap = np.zeros(len(detections))
    if det_overlap_threshold is not None:
        overlap[rows] = iou[rows, cols]
        mask = overlap >= det_overlap_threshold
    else:
        overlap[rows] = cost[rows, cols]
        mask = overlap < max_distance
    return matches, mask, overlap


ASSIGNMENT_FNS = {
    "assign_detections_greedy": assign_greedy,
    "assign_detections_hungarian": assign_hungarian,
}
