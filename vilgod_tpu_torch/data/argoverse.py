"""Argoverse 2 sensor-dataset adapter (OpenPCDet processed layout); the
port's own copy of ``vilgod_tpu/data/argoverse.py``.

Standalone equivalent of the reference's ``Argo2Dataset`` (its
``argo2_dataset.py:10-377``): frames ordered by the uuid frame index,
boxes assembled from location/dimensions/rotation_y, and AV2 category
names mapped into {Vehicle, Pedestrian, Cyclist} / 'unknown' (the
reference's ``argoverse_dataset.yaml:7-26``).

Point files: ``info['lidar_path']`` if present (relative to root), else
``<root>/<split>/velodyne/<sample_idx>.bin`` — (N, 4) float32
[x, y, z, intensity] (no elongation feature).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from .openpcdet import OpenPCDetSequenceDataset

# argoverse_dataset.yaml:7-26
CLASS_MAPPING = {
    "Regular_vehicle": "Vehicle",
    "Pedestrian": "Pedestrian",
    "Bicyclist": "Cyclist",
    "Motorcyclist": "Cyclist",
    "Wheeled_rider": "Cyclist",
    "Large_vehicle": "Vehicle",
    "Bus": "Vehicle",
    "Box_truck": "Vehicle",
    "Truck": "Vehicle",
    "Vehicular_trailer": "Vehicle",
    "Truck_cab": "Vehicle",
    "School_bus": "Vehicle",
    "Articulated_bus": "Vehicle",
    "Message_board_trailer": "Vehicle",
}


class ArgoverseSequenceDataset(OpenPCDetSequenceDataset):
    def __init__(self, root_path: str | Path, split: str = "val",
                 info_name: str | None = None, **kwargs):
        self.root_path = Path(root_path)
        self.split = split
        info_path = self.root_path / (info_name or f"argo2_infos_{split}.pkl")
        super().__init__(info_path, **kwargs)

    def sequence_name_of(self, info: dict) -> str:
        return info["uuid"].split("/")[0]

    def sort_key(self, info: dict):
        # frames sorted by uuid frame index (argo2_dataset.py:49-51)
        return int(info["uuid"].split("/")[1])

    def load_points(self, info: dict) -> np.ndarray:
        if "lidar_path" in info:
            path = self.root_path / info["lidar_path"]
        else:
            path = (self.root_path / self.split / "velodyne" /
                    f"{info['sample_idx']}.bin")
        if path.suffix == ".npy":
            pts = np.load(path)
        else:
            pts = np.fromfile(path, dtype=np.float32).reshape(-1, 4)
        return pts[:, :4].astype(np.float32)

    def adapt_annos(self, info: dict) -> dict:
        """Build gt_boxes_lidar + map AV2 classes (argo2_dataset.py:92-104).
        Idempotent: the result is cached on the info dict in place."""
        annos = info["annos"]
        if "gt_boxes_lidar" not in annos:
            loc = np.asarray(annos["location"], np.float32).reshape(-1, 3)
            dims = np.asarray(annos["dimensions"], np.float32).reshape(-1, 3)
            rots = np.asarray(annos["rotation_y"], np.float32).reshape(-1)
            annos["gt_boxes_lidar"] = np.concatenate(
                [loc, dims, rots[:, None]], axis=1)
            names = np.asarray(annos["name"], dtype=object)
            mapped = np.array(
                [CLASS_MAPPING.get(n, n if n in self.class_names else "unknown")
                 for n in names])
            annos["name"] = mapped
        return annos
