"""Waymo Open Dataset adapter (OpenPCDet processed layout); the port's
own copy of ``vilgod_tpu/data/waymo.py``.

Standalone equivalent of the reference's ``WaymoDataset`` (its
``waymo_dataset.py:12-200``): reads
``<root>/<processed_tag>_infos_<split>.pkl`` plus per-frame
``<root>/<processed_tag>/<sequence>/<sample_idx:04d>.npy`` point files
((N, 6) = [x, y, z, intensity, elongation, NLZ_flag]).

Point semantics follow OpenPCDet's ``WaymoDataset.get_lidar`` with the
reference pipeline's config (DISABLE_NLZ_FLAG_ON_POINTS: True): intensity
tanh-squashed, NLZ flag kept.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from .openpcdet import OpenPCDetSequenceDataset


class WaymoSequenceDataset(OpenPCDetSequenceDataset):
    def __init__(self, root_path: str | Path, split: str = "val",
                 processed_tag: str = "waymo_processed_data_v0_5_0",
                 disable_nlz_flag: bool = True, **kwargs):
        self.root_path = Path(root_path)
        self.processed_tag = processed_tag
        self.disable_nlz_flag = disable_nlz_flag
        info_path = self.root_path / f"{processed_tag}_infos_{split}.pkl"
        super().__init__(info_path, **kwargs)

    def sequence_name_of(self, info: dict) -> str:
        # frame_id = '<sequence>_<frame>' (waymo_dataset.py:61-63)
        return "_".join(info["frame_id"].split("_")[:-1])

    def load_points(self, info: dict) -> np.ndarray:
        pc = info["point_cloud"]
        lidar_file = (self.root_path / self.processed_tag /
                      pc["lidar_sequence"] / f"{pc['sample_idx']:04d}.npy")
        feats = np.load(lidar_file)
        points, nlz = feats[:, 0:5], feats[:, 5]
        if not self.disable_nlz_flag:
            points = points[nlz == -1]
        points = points.copy()
        points[:, 3] = np.tanh(points[:, 3])
        return points.astype(np.float32)
