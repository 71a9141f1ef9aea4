"""Procedural LiDAR scene generator (copy of ``vilgod_tpu.data.synthetic``:
the same seed makes the same scenes in both packages).

Stands in for Waymo/Argoverse raw data in tests and benchmarks: a moving
ego over a flat ground plane with static and moving box-shaped objects.
Points are synthesized on object surfaces in the world frame, transformed
into the per-frame sensor frame by the ego pose, so every pipeline stage
(ground removal, ephemerality, clustering, tracking, box fitting, eval)
has a ground-truth answer. The reference has no equivalent — its de-facto
fixtures are six KITTI ``.bin`` frames bundled with Patchwork++
(`third_party/patchwork-plusplus/data/`); this generator
is the deterministic fixture set.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

SENSOR_HEIGHT = 1.723  # matches the Waymo preprocessor z offset


@dataclass
class SceneObject:
    kind: str               # 'Vehicle' | 'Pedestrian' | 'Cyclist'
    size: np.ndarray        # (l, w, h)
    start_xy: np.ndarray    # world position at frame 0
    velocity_xy: np.ndarray  # m / frame
    heading: float
    points_per_frame: int

    def center(self, fnr: int) -> np.ndarray:
        xy = self.start_xy + self.velocity_xy * fnr
        return np.array([xy[0], xy[1], self.size[2] / 2])

    @property
    def moving(self) -> bool:
        return bool(np.linalg.norm(self.velocity_xy) > 1e-6)


# points per frame sized for <=0.09 m surface spacing over the three
# visible faces: the clustering stage random-subsamples 1/2 of each frame
# (zero_shot_detector.py:223), and the subsampled cloud must stay inside
# the eps=0.15 connectivity radius the way real Waymo-density clouds do
# Waymo-realistic mean extents (val-set class means); a 0.6 m synthetic
# pedestrian would be un-matchable at IoU 0.4 once the reference's +0.3 m
# box enlargement is applied — real peds are ~0.9 m wide
_SIZES = {
    "Vehicle": ([4.4, 1.9, 1.6], 2400),
    "Pedestrian": ([0.9, 0.86, 1.75], 320),
    "Cyclist": ([1.76, 0.8, 1.8], 480),
}


class SyntheticSequence:
    """One procedurally generated sequence."""

    def __init__(self, name: str = "synth_0", n_frames: int = 20, seed: int = 0,
                 n_ground: int = 6000, n_vehicles: int = 3, n_pedestrians: int = 2,
                 n_cyclists: int = 0, n_moving: int = 2, area: float = 40.0,
                 ego_speed: float = 0.5, noise: float = 0.02):
        self.name = name
        self.sequence_length = n_frames
        self.rng = np.random.default_rng(seed)
        self.noise = noise
        self.n_ground = n_ground
        self.area = area

        self.objects: list[SceneObject] = []
        kinds = (["Vehicle"] * n_vehicles + ["Pedestrian"] * n_pedestrians
                 + ["Cyclist"] * n_cyclists)
        def sample_pos():
            p = self.rng.uniform(-area / 2 + 6, area / 2 - 6, 2)
            while np.linalg.norm(p) < 4.0:
                p = self.rng.uniform(-area / 2 + 6, area / 2 - 6, 2)
            return p

        for i, kind in enumerate(kinds):
            size, npts = _SIZES[kind]
            moving = i < n_moving
            pos = sample_pos()
            if moving:
                # start/end waypoints inside the area; >= 0.8 m/frame
                # (~8 m/s at 10 Hz) so the entropy window separates cleanly
                end = sample_pos()
                for _ in range(50):
                    if np.linalg.norm(end - pos) >= 0.8 * n_frames:
                        break
                    end = sample_pos()
                vel = (end - pos) / n_frames
                heading = float(np.arctan2(vel[1], vel[0]))
            else:
                vel = np.zeros(2)
                heading = float(self.rng.uniform(0, 2 * np.pi))
            self.objects.append(SceneObject(
                kind=kind, size=np.array(size, np.float64), start_xy=pos,
                velocity_xy=vel, heading=heading, points_per_frame=npts))

        # ego drives +x at constant speed; sensor sits SENSOR_HEIGHT above ground
        self.poses = []
        for fnr in range(n_frames):
            pose = np.eye(4)
            pose[0, 3] = ego_speed * fnr
            pose[2, 3] = SENSOR_HEIGHT
            self.poses.append(pose)

        # stable world-frame ground: a real sensor rescans the same road
        # surface, so ground points must persist across frames (they would
        # otherwise read as ephemeral to the entropy stage)
        corridor = area + ego_speed * n_frames
        n_total = int(n_ground * corridor / area)
        gx = self.rng.uniform(-area / 2, area / 2 + ego_speed * n_frames, n_total)
        gy = self.rng.uniform(-area / 2, area / 2, n_total)
        self._ground_world = np.stack([gx, gy, np.zeros(n_total)], axis=1)

        self._frames: dict[int, np.ndarray] = {}
        # per-frame true ground point count (points are ordered
        # [ground..., object...] in each frame) — used by tests
        self.n_ground_in_frame: dict[int, int] = {}

    # -- geometry helpers ---------------------------------------------
    def _object_points(self, obj: SceneObject, fnr: int, rng) -> np.ndarray:
        """Sample points on the object's visible box surfaces (world frame):
        one long side, one short side, and the top — roughly what a LiDAR
        sees, and area-proportional so spacing stays uniform."""
        n = obj.points_per_frame
        l, w, h = obj.size
        areas = np.array([l * h, w * h, l * w])
        face = rng.choice(3, n, p=areas / areas.sum())
        u, v = rng.uniform(-0.5, 0.5, (2, n))
        x = np.where(face == 1, 0.5, u) * l
        y = np.where(face == 0, 0.5, v) * w
        z = np.where(face == 2, 1.0, rng.uniform(0, 1, n)) * h
        pts = np.stack([x, y, z - h / 2], axis=1)
        c, s = np.cos(obj.heading), np.sin(obj.heading)
        rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        return pts @ rot.T + obj.center(fnr)

    def _world_frame_points(self, fnr: int) -> np.ndarray:
        rng = np.random.default_rng(self.rng.bit_generator.seed_seq.entropy % (2**31)
                                    + 7919 * fnr)
        ego_x = self.poses[fnr][0, 3]
        in_view = np.abs(self._ground_world[:, 0] - ego_x) < self.area / 2
        self.n_ground_in_frame[fnr] = int(np.sum(in_view))
        parts = [self._ground_world[in_view]]
        for obj in self.objects:
            parts.append(self._object_points(obj, fnr, rng))
        pts = np.concatenate(parts, axis=0)
        pts += rng.normal(0, self.noise, pts.shape)
        return pts

    # -- SequenceSource protocol --------------------------------------
    def get_pose(self, fnr: int) -> np.ndarray:
        return self.poses[fnr]

    def get_lidar_points(self, fnr: int) -> np.ndarray:
        if fnr not in self._frames:
            world = self._world_frame_points(fnr)
            inv = np.linalg.inv(self.poses[fnr])
            sensor = world @ inv[:3, :3].T + inv[:3, 3]
            feats = np.full((len(sensor), 2), 0.5, np.float32)
            self._frames[fnr] = np.concatenate(
                [sensor, feats], axis=1).astype(np.float32)
        return self._frames[fnr]

    def get_annos(self, fnr: int) -> dict:
        boxes, names, moving = [], [], []
        inv = np.linalg.inv(self.poses[fnr])
        yaw = np.arctan2(inv[1, 0], inv[0, 0])
        for obj in self.objects:
            c = obj.center(fnr) @ inv[:3, :3].T + inv[:3, 3]
            boxes.append([*c, *obj.size, obj.heading + yaw])
            names.append(obj.kind)
            moving.append(obj.moving)
        return {
            "gt_boxes_lidar": np.array(boxes, np.float32).reshape(-1, 7),
            "gt_names": np.array(names),
            "moving": np.array(moving, bool),
            "num_points_in_gt": np.array(
                [o.points_per_frame for o in self.objects], np.int32),
        }


class SyntheticDataset:
    class_names = ["Vehicle", "Pedestrian", "Cyclist"]

    def __init__(self, n_sequences: int = 1, seed: int = 0, **seq_kwargs):
        self._seqs = {
            f"synth_{i}": SyntheticSequence(name=f"synth_{i}", seed=seed + i,
                                            **seq_kwargs)
            for i in range(n_sequences)
        }

    def sequence_names(self):
        return list(self._seqs)

    def sequence(self, name: str) -> SyntheticSequence:
        return self._seqs[name]
