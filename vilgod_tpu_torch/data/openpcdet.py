"""Standalone readers for OpenPCDet-style sequence datasets; the port's
own copy of ``vilgod_tpu/data/openpcdet.py`` (numpy only, since its
frames feed ``SequenceState.set_frame``, which takes numpy).

The reference subclasses OpenPCDet dataset classes (its
``waymo_dataset.py:12`` and ``argo2_dataset.py:10``); here the same
on-disk layout (an ``infos`` pickle plus per-frame point files) is read
directly, so the pipeline has no OpenPCDet dependency. Shared machinery:
sequence mapping from frame ids, moving-track extraction by world-frame
GT displacement, and the frame-level anno filtering the orchestrator
consumes.
"""
from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np


def load_infos(paths: list[str | Path]) -> list[dict]:
    infos = []
    for p in paths:
        with open(p, "rb") as f:
            infos.extend(pickle.load(f))
    return infos


def apply_transform_boxes_np(boxes: np.ndarray, t: np.ndarray) -> np.ndarray:
    out = boxes.copy()
    out[:, :3] = boxes[:, :3] @ t[:3, :3].T + t[:3, 3]
    out[:, 6] += np.arctan2(t[1, 0], t[0, 0])
    return out


class OpenPCDetSequence:
    """One sequence view over a shared infos list (SequenceSource)."""

    def __init__(self, dataset: "OpenPCDetSequenceDataset", name: str,
                 indices: list[int]):
        self.dataset = dataset
        self.name = name
        self.indices = indices
        self.sequence_length = len(indices)
        self._moving_track_ids = self._extract_moving_tracks()

    # -- required protocol --------------------------------------------
    def get_pose(self, fnr: int) -> np.ndarray:
        return np.asarray(self.dataset.infos[self.indices[fnr]]["pose"])

    def get_lidar_points(self, fnr: int) -> np.ndarray:
        return self.dataset.load_points(self.dataset.infos[self.indices[fnr]])

    def get_annos(self, fnr: int) -> dict:
        """Filtered frame annos (the reference's waymo_dataset.py:88-160):
        'unknown' and empty boxes dropped, classes restricted, moving
        flags attached."""
        info = self.dataset.infos[self.indices[fnr]]
        annos = self.dataset.adapt_annos(info)
        names = np.asarray(annos["name"])
        npts = np.asarray(annos.get("num_points_in_gt",
                                    np.full(len(names), 100)))
        obj_ids = np.asarray(annos["obj_ids"])
        boxes = np.asarray(annos["gt_boxes_lidar"], np.float64).reshape(-1, 7)
        keep = (names != "unknown") & (npts >= 1)
        keep &= np.isin(names, self.dataset.class_names)
        return {
            "gt_boxes_lidar": boxes[keep],
            "gt_names": names[keep],
            "num_points_in_gt": npts[keep],
            "obj_ids": obj_ids[keep],
            "moving": np.array([oid in self._moving_track_ids
                                for oid in obj_ids[keep]], bool),
        }

    # -- moving tracks -------------------------------------------------
    def _extract_moving_tracks(self, threshold: float = 1.0) -> set:
        """GT track ids whose world-frame box centers move > ``threshold``
        meters from their first sighting anywhere in the sequence (the
        reference's waymo_dataset.py:167-200)."""
        tracks: dict = {}
        for fnr in range(self.sequence_length):
            info = self.dataset.infos[self.indices[fnr]]
            annos = self.dataset.adapt_annos(info)
            pose = np.asarray(info["pose"])
            boxes = np.asarray(annos["gt_boxes_lidar"], np.float64).reshape(-1, 7)
            for oid, box in zip(np.asarray(annos["obj_ids"]), boxes):
                tracks.setdefault(oid, []).append((pose, box))
        moving = set()
        for oid, entries in tracks.items():
            if len(entries) < 2:
                continue
            ref_pose, ref_box = entries[0]
            for pose, box in entries[1:]:
                world = apply_transform_boxes_np(
                    box[None], np.linalg.inv(ref_pose) @ pose)[0]
                if np.linalg.norm(ref_box[:3] - world[:3]) > threshold:
                    moving.add(oid)
                    break
        return moving


class OpenPCDetSequenceDataset:
    """Base dataset: infos pkl -> named sequences."""

    class_names = ["Vehicle", "Pedestrian", "Cyclist"]

    def __init__(self, info_paths, class_names=None,
                 start_sequence: int | None = None,
                 end_sequence: int | None = None):
        if class_names is not None:
            self.class_names = list(class_names)
        self.infos = load_infos(
            [info_paths] if isinstance(info_paths, (str, Path)) else info_paths)
        self._mapping = self._create_sequence_mapping()
        names = list(self._mapping)
        lo = start_sequence if start_sequence else 0
        hi = end_sequence if end_sequence else len(names)
        # an end at or before the start keeps every sequence from the start
        self._names = names[lo:hi] if hi > lo else names[lo:]

    # -- per-format hooks ----------------------------------------------
    def sequence_name_of(self, info: dict) -> str:
        raise NotImplementedError

    def load_points(self, info: dict) -> np.ndarray:
        raise NotImplementedError

    def adapt_annos(self, info: dict) -> dict:
        """Return annos with gt_boxes_lidar/name/obj_ids normalized."""
        return info["annos"]

    def sort_key(self, info: dict):
        return 0  # stable infos order by default

    # -- shared ---------------------------------------------------------
    def _create_sequence_mapping(self) -> dict:
        mapping: dict[str, list[int]] = {}
        for idx, info in enumerate(self.infos):
            mapping.setdefault(self.sequence_name_of(info), []).append(idx)
        for idxs in mapping.values():
            idxs.sort(key=lambda i: (self.sort_key(self.infos[i]), i))
        return mapping

    def sequence_names(self) -> list[str]:
        return list(self._names)

    def sequence(self, name: str) -> OpenPCDetSequence:
        return OpenPCDetSequence(self, name, self._mapping[name])

    def gt_annos(self, name: str) -> list[dict]:
        """Eval-format GT annos for a sequence (masking.py consumes these)."""
        seq = self.sequence(name)
        return [seq.get_annos(f) for f in range(seq.sequence_length)]
