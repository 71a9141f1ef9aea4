"""The scene, caps and configurations that ``chip_smoke.py`` and the tools
of this package drive.

``SCENE`` is the bench's parity scene (one 24-frame synthetic sequence),
``CAPS`` the bench's full caps, ``STAGES`` the nine-stage main path and
:func:`dense_config` the dense configuration: stages 1-3 with an entropy
radius the banded passes refuse and a cluster input that sends clustering
and the label transfer to the dense kernels.
"""
from __future__ import annotations

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
