"""The scene, caps and configurations that ``chip_smoke.py`` and the tools
of this package drive.

``SCENE`` is the bench's parity scene (one 24-frame synthetic sequence),
``CAPS`` the bench's full caps, ``STAGES`` the nine-stage main path and
:func:`dense_config` the dense configuration: stages 1-3 with an entropy
radius the banded passes refuse and a cluster input that sends clustering
and the label transfer to the dense kernels. ``RANSAC_SHAPES`` and
:func:`ground_cloud` give the filter's RANSAC draw its inputs at the
benchmark cells' shapes; ``SELECT_SHAPES`` and :func:`select_masks` give
the clustering's input selection (kernel 14) its inputs at those cells'
shapes.
"""
from __future__ import annotations

import torch

from ..config import waymo_config

SCENE = dict(n_sequences=1, seed=7, n_frames=24, n_ground=120000,
             n_vehicles=12, n_pedestrians=6, n_cyclists=4, n_moving=6,
             area=90.0)
# the bench's full caps (bench.py:68-75)
CAPS = {"max_points": 196608, "max_ng_points": 131072, "max_clusters": 256,
        "max_cluster_points": 4096, "max_tracks": 1024,
        "max_cluster_input": 65536, "clip_batch": 512}
# the nine-stage main path (vilgod_tpu/config/presets.py pipeline_active)
STAGES = ["mask_ground_points", "calculate_entropy_scores",
          "spatial_clustering", "filter_detections", "track_clusters",
          "classification", "fit_bounding_boxes_simple", "propagate_labels",
          "evaluate_sequence"]
# the dense configuration: an entropy radius the banded passes refuse and
# the largest cluster input below the 16384 paged threshold that no tile
# divides
DENSE_RADIUS = 0.5
DENSE_CLUSTER_INPUT = 16000
# the filter's RANSAC draw in the benchmark's cells: (raw-points bucket,
# valid points of the cell's fullest frame)
RANSAC_SHAPES = {"waymo.urban": (155648, 153172),
                 "av2.urban": (106496, 102231)}
# the clustering's input selection in the benchmark's cells: (padded
# frames, real frames, non-ground bucket); a chunk holds 32 pages of two
# window frames
SELECT_SHAPES = {"waymo.urban": (200, 199, 40960),
                 "av2.urban": (152, 150, 32768)}


def ground_cloud(bucket: int, n_valid: int, seed: int = 0):
    """(points (bucket, 4) float32, mask (bucket,) bool) on the CPU: a raw
    frame as the filter's RANSAC sees it, 85 % of its valid points on a
    tilted ground plane with 3 cm of noise within 75 m, the rest in boxes
    up to 4 m above it, zeros past ``n_valid``."""
    g = torch.Generator().manual_seed(seed)
    n_gnd = n_valid * 85 // 100
    pts = torch.zeros((bucket, 4), dtype=torch.float32)
    xy = (torch.rand((n_valid, 2), generator=g) * 2 - 1) * 75
    z = 0.02 * xy[:, 0] - 0.01 * xy[:, 1] - 1.8
    z[:n_gnd] += 0.03 * torch.randn(n_gnd, generator=g)
    z[n_gnd:] += 0.3 + 3.7 * torch.rand(n_valid - n_gnd, generator=g)
    pts[:n_valid, :2], pts[:n_valid, 2] = xy, z
    pts[:n_valid, 3] = torch.rand(n_valid, generator=g)
    mask = torch.arange(bucket) < n_valid
    return pts, mask


def select_masks(frames: int, n: int, seed: int = 0):
    """(mask, has_nbr, dense_moving, entropy_mask), each (frames, n) bool
    on the CPU: the selection's inputs as the statistics nest them (every
    set within the mask, the dense moving points within the moving ones),
    80 % of a frame's rows occupied, 70 % of those with a neighbour, 60 %
    moving, half of those dense."""
    g = torch.Generator().manual_seed(seed)
    mask = torch.arange(n) < n * 4 // 5
    mask = mask.expand(frames, n).clone()
    has_nbr = mask & (torch.rand((frames, n), generator=g) < 0.7)
    moving = mask & (torch.rand((frames, n), generator=g) < 0.6)
    dense = moving & (torch.rand((frames, n), generator=g) < 0.5)
    return mask, has_nbr, dense, moving


def main_path(scale: str = "full"):
    """(config, dataset) of the main path: ``SCENE`` at ``CAPS`` through
    ``STAGES``; at ``"smoke"`` the bench's smoke scene, caps and stages
    (``tools/bench.build``)."""
    if scale == "full":
        from ..data import SyntheticDataset
        return (waymo_config(capacity=CAPS, pipeline_active=STAGES),
                SyntheticDataset(**SCENE))
    from .bench import build
    cfg, ds, _ = build("smoke")
    return cfg, ds


def dense_config():
    """The dense configuration: stages 1-3 with a 0.5 m entropy radius and
    a 16000-point cluster input."""
    cfg = waymo_config(capacity={**CAPS,
                                 "max_cluster_input": DENSE_CLUSTER_INPUT},
                       pipeline_active=STAGES[:3])
    for p in cfg["pipeline"]:
        if p["name"] == "calculate_entropy_scores":
            p.setdefault("args", {})["max_neighbor_point_dist"] = DENSE_RADIUS
    return cfg


class FirstFrames:
    """The first ``n`` frames of a sequence source (the same scene, not a
    shorter scene: a synthetic scene's motion depends on its length)."""

    def __init__(self, source, n):
        self.source, self.sequence_length = source, n

    def get_lidar_points(self, fnr):
        return self.source.get_lidar_points(fnr)

    def get_pose(self, fnr):
        return self.source.get_pose(fnr)
