"""Dataset interfaces (copy of ``vilgod_tpu.data.base``).

The reference couples its dataset adapters to OpenPCDet base classes
(`src/datasets/waymo_dataset.py:24-56`); here the pipeline
only needs a minimal sequence-source protocol, so adapters are standalone
readers and anything (including procedural generators) can feed the
pipeline.
"""
from __future__ import annotations

from typing import Iterable, Protocol

import numpy as np


class SequenceSource(Protocol):
    """One LiDAR sequence: per-frame points, poses, and (optional) annos."""

    sequence_length: int

    def get_lidar_points(self, fnr: int) -> np.ndarray:
        """(N, >=3) sensor-frame points [x, y, z, intensity, ...]."""
        ...

    def get_pose(self, fnr: int) -> np.ndarray:
        """(4, 4) sensor->world transform for frame ``fnr``."""
        ...

    def get_annos(self, fnr: int) -> dict:
        """{'gt_boxes_lidar': (M, 7), 'gt_names': (M,), 'moving': (M,),
        'num_points_in_gt': (M,)} in the sensor frame."""
        ...


class SequenceDataset(Protocol):
    """A collection of sequences plus evaluation metadata."""

    class_names: list[str]

    def sequence_names(self) -> Iterable[str]: ...

    def sequence(self, name: str) -> SequenceSource: ...
