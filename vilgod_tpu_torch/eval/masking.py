"""Pre-metric det/GT masking (range, BEV, class-agnostic, moving/static);
the port's own copy of ``vilgod_tpu/eval/masking.py``.

Detections are range-masked on their BEV box corners and
score-thresholded; ground truth is range-masked and optionally split into
moving/static, removing detections that overlap ground truth of the
excluded motion class (rotated 3D IoU).
"""
from __future__ import annotations

from copy import deepcopy

import numpy as np


def boxes_to_corners_bev(boxes: np.ndarray) -> np.ndarray:
    """(N, 7) -> (N, 4, 2) BEV corners (pcdet corner convention)."""
    l, w = boxes[:, 3], boxes[:, 4]
    template = np.array([[1, 1], [1, -1], [-1, -1], [-1, 1]], np.float64) / 2
    corners = template[None] * np.stack([l, w], axis=1)[:, None, :]
    c, s = np.cos(boxes[:, 6]), np.sin(boxes[:, 6])
    rot = np.stack([np.stack([c, -s], -1), np.stack([s, c], -1)], axis=-2)
    return np.einsum("nij,nkj->nki", rot, corners) + boxes[:, None, :2]


def _range_mask(boxes: np.ndarray, eval_range) -> np.ndarray:
    """All four BEV corners inside [x0, y0, x1, y1]."""
    if len(boxes) == 0:
        return np.zeros(0, bool)
    corners = boxes_to_corners_bev(boxes)
    lo = np.asarray(eval_range[0:2])
    hi = np.asarray(eval_range[2:4])
    out = (corners < lo[None, None]) | (corners > hi[None, None])
    return np.sum(out.reshape(len(boxes), -1), axis=1) == 0


def mask_eval_annos(det_annos: list[dict], gt_annos: list[dict],
                    class_names, eval_range=(-50.0, -20.0, 50.0, 20.0),
                    score_thresh: float = 0.0, bev: bool = False,
                    class_agnostic: bool = False, moving: bool = False,
                    static: bool = False, sampling_rate: int = 1):
    """Returns (masked_det_annos, masked_gt_annos), both deep copies."""
    det_annos = deepcopy(det_annos)[::sampling_rate]
    gt_annos = deepcopy(gt_annos)[::sampling_rate]

    for anno in det_annos:
        boxes = np.asarray(anno["boxes_lidar"]).reshape(-1, 7)
        if len(boxes) == 0:
            continue
        if bev:
            boxes[:, 2] = 0.0
            boxes[:, 5] = 1.0
        if class_agnostic:
            anno["name"] = np.array([class_names[0]] * len(boxes))
        mask = _range_mask(boxes, eval_range)
        mask[np.asarray(anno["score"]) < score_thresh] = False
        anno["boxes_lidar"] = boxes[mask]
        for k in ("name", "score", "moving"):
            if k in anno:
                anno[k] = np.asarray(anno[k])[mask]

    for a_idx, anno in enumerate(gt_annos):
        # frame-level annos use 'gt_names' (waymo_dataset.get_annos), the
        # infos pkl uses 'name' — accept both
        if "name" not in anno and "gt_names" in anno:
            anno["name"] = anno.pop("gt_names")
        n = len(anno["name"])
        if "difficulty" not in anno or anno.get("difficulty") is None:
            anno["difficulty"] = np.ones(n)
        boxes = np.asarray(anno["gt_boxes_lidar"], np.float64).reshape(-1, 7)
        if class_agnostic:
            anno["name"] = np.array([class_names[0] if nm in class_names else nm
                                     for nm in anno["name"]])
        if len(boxes) == 0:
            continue
        if bev:
            boxes[:, 2] = 0.0
            boxes[:, 5] = 1.0
        mask = _range_mask(boxes, eval_range)

        if moving or static:
            mv = np.asarray(anno["moving"], bool)
            # remove detections overlapping GT of the *excluded* motion
            # class
            excl = mask & (~mv if moving else mv)
            det_boxes = np.asarray(det_annos[a_idx]["boxes_lidar"]).reshape(-1, 7)
            if len(det_boxes) and np.any(excl):
                from .detection_metrics import _iou3d
                iou = _iou3d(det_boxes, boxes[excl])
                keep = np.sum(iou, axis=1) == 0
                det_annos[a_idx]["boxes_lidar"] = det_boxes[keep]
                for k in ("name", "score", "moving"):
                    if k in det_annos[a_idx]:
                        det_annos[a_idx][k] = np.asarray(det_annos[a_idx][k])[keep]
            mask &= mv if moving else ~mv

        anno["gt_boxes_lidar"] = boxes[mask]
        for k in ("name", "num_points_in_gt", "moving"):
            if k in anno:
                anno[k] = np.asarray(anno[k])[mask]
        anno["difficulty"] = np.asarray(anno["difficulty"])[mask]
    return det_annos, gt_annos


def evaluate_detections(det_annos: list[dict], gt_annos: list[dict],
                        class_names=("Vehicle", "Pedestrian", "Cyclist"),
                        eval_cfg: dict | None = None, **kwargs) -> dict:
    """Full evaluation path: masking, then the Waymo-protocol AP."""
    from .detection_metrics import waymo_detection_ap

    eval_cfg = eval_cfg or {}
    det_m, gt_m = mask_eval_annos(det_annos, gt_annos, class_names, **kwargs)
    return waymo_detection_ap(
        det_m, gt_m, class_names=class_names,
        iou_thresholds=tuple(eval_cfg.get("iou_thresholds", (0.4, 0.4, 0.4, 0.4))),
        difficulties=tuple(eval_cfg.get("difficulties", (2,))),
        breakdown_range=bool(eval_cfg.get("breakdown_range", False)))
