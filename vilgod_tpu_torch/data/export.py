"""Pseudo-label export for detector self-training; the port's own copy of
``vilgod_tpu/data/export.py``, writing the same files.

The reference's end goal is feeding the produced pseudo-labels into an
off-the-shelf OpenPCDet training round (its README, "self-training"). This
module writes the pipeline's per-frame detections as an OpenPCDet-style
infos pickle: each frame entry mirrors the source info (frame id, point
cloud pointer, pose) with its ``annos`` replaced by the pseudo-labels, so
an unmodified OpenPCDet dataset class can train from it.

Every array written is numpy, never a ``torch.Tensor``: OpenPCDet reads
the export, and it must load where torch is not installed.
"""
from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np


def _host(x, dtype=None) -> np.ndarray:
    """``x`` as a numpy array; a tensor (on any device) is copied to the
    host first."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


def pseudo_annos(frame_result: dict) -> dict:
    """One frame's detections -> OpenPCDet annos dict."""
    boxes = _host(frame_result["boxes_lidar"], np.float32).reshape(-1, 7)
    n = len(boxes)
    return {
        "name": _host(frame_result["name"]).reshape(-1),
        "gt_boxes_lidar": boxes,
        "score": _host(frame_result["score"], np.float32).reshape(-1),
        # point counts are unknown for pseudo boxes; -1 marks them so
        # difficulty assignment in downstream tooling can special-case
        "num_points_in_gt": np.full(n, -1, np.int32),
        "difficulty": np.zeros(n, np.int32),
        "obj_ids": np.array([f"pseudo_{i}" for i in range(n)]),
        "moving": _host(frame_result.get("moving",
                                         np.zeros(n, bool))).reshape(-1),
    }


def make_pseudo_infos(dataset, results_by_sequence: dict[str, list[dict]]) -> list[dict]:
    """Assemble infos for every processed sequence, in sequence-frame order.

    ``dataset`` provides per-frame metadata; OpenPCDet-backed datasets
    (recognised by their ``indices`` and ``dataset``, of either package)
    contribute their original info dicts (minus GT annos), synthetic or
    custom sources get a minimal skeleton.
    """
    infos = []
    for name, frames in results_by_sequence.items():
        seq = dataset.sequence(name)
        base_infos = None
        if hasattr(seq, "indices") and hasattr(seq, "dataset"):
            base_infos = [seq.dataset.infos[i] for i in seq.indices]
        for fnr, frame_result in enumerate(frames):
            if base_infos is not None:
                info = dict(base_infos[fnr])
            else:
                info = {
                    "frame_id": f"{name}_{fnr:03d}",
                    "point_cloud": {"lidar_sequence": name, "sample_idx": fnr},
                    "pose": _host(seq.get_pose(fnr)),
                }
            info["annos"] = pseudo_annos(frame_result)
            infos.append(info)
    return infos


def export_pseudo_labels(dataset, results_by_sequence: dict[str, list[dict]],
                         out_path: str | Path) -> Path:
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    infos = make_pseudo_infos(dataset, results_by_sequence)
    with open(out_path, "wb") as f:
        pickle.dump(infos, f)
    return out_path


def _points_in_box_count(points: np.ndarray, box: np.ndarray) -> int:
    """Axis-aligned count in the box frame (pseudo num_points_in_gt)."""
    d = points[:, :3] - box[:3]
    c, s = np.cos(-box[6]), np.sin(-box[6])
    x = d[:, 0] * c - d[:, 1] * s
    y = d[:, 0] * s + d[:, 1] * c
    inside = (np.abs(x) <= box[3] / 2) & (np.abs(y) <= box[4] / 2) & (
        np.abs(d[:, 2]) <= box[5] / 2)
    return int(np.sum(inside))


def export_pseudo_dataset(dataset, results_by_sequence: dict, out_root,
                          split: str = "pseudo",
                          processed_tag: str = "waymo_processed_data_v0_5_0",
                          track_ids_by_sequence: dict | None = None) -> Path:
    """Write a COMPLETE reloadable OpenPCDet split: per-frame ``.npy``
    point files plus the infos pickle, so the round trip closes —
    :class:`~vilgod_tpu_torch.data.waymo.WaymoSequenceDataset` (or an
    external OpenPCDet training setup) loads the export as a dataset.

    Unlike :func:`export_pseudo_labels` (infos-only, for datasets whose
    point files already exist on disk), this also materializes points and
    fills ``num_points_in_gt`` by an axis-aligned in-box count.
    ``track_ids_by_sequence`` ({seq: [per-frame int arrays]}) gives boxes
    stable identities so the reader's moving-track extraction works;
    defaults to unique ids per box.
    """
    out_root = Path(out_root)
    info_path = out_root / f"{processed_tag}_infos_{split}.pkl"
    infos = []
    for seq_name, frames in results_by_sequence.items():
        seq = dataset.sequence(seq_name)
        seq_dir = out_root / processed_tag / seq_name
        seq_dir.mkdir(parents=True, exist_ok=True)
        for fnr, res in enumerate(frames):
            pts = _host(seq.get_lidar_points(fnr), np.float32)
            arr = np.zeros((len(pts), 6), np.float32)
            n_feat = min(5, pts.shape[1])
            arr[:, :n_feat] = pts[:, :n_feat]
            # the reader tanh-squashes intensity (waymo_dataset get_lidar);
            # store arctanh so the loaded points equal the originals
            arr[:, 3] = np.arctanh(np.clip(arr[:, 3], -0.999999, 0.999999))
            arr[:, 5] = -1.0  # NLZ flag: valid
            np.save(seq_dir / f"{fnr:04d}.npy", arr)

            annos = pseudo_annos(res)
            boxes = annos["gt_boxes_lidar"]
            if track_ids_by_sequence is not None:
                tids = _host(track_ids_by_sequence[seq_name][fnr])
                annos["obj_ids"] = np.array(
                    [f"{seq_name}_t{t}" for t in tids])
            else:
                annos["obj_ids"] = np.array(
                    [f"{seq_name}_{fnr}_{i}" for i in range(len(boxes))])
            annos["num_points_in_gt"] = np.array(
                [_points_in_box_count(pts, b) for b in boxes], np.int32)
            infos.append({
                "frame_id": f"{seq_name}_{fnr}",
                "point_cloud": {"lidar_sequence": seq_name,
                                "sample_idx": fnr, "num_features": 6},
                "pose": _host(seq.get_pose(fnr), np.float64),
                "annos": annos,
            })
    out_root.mkdir(parents=True, exist_ok=True)
    with open(info_path, "wb") as f:
        pickle.dump(infos, f)
    return info_path
