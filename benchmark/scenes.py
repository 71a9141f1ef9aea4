"""The benchmark's traffic: procedural LiDAR sequences made from the seed.

:class:`SyntheticSequence` is a frozen copy of the program's scene
generator (``vilgod_tpu_torch/data/synthetic.py``, itself a copy of the
JAX package's), so the benchmark owns the inputs it hands the program: a
moving ego over a flat ground plane with static and moving box-shaped
objects, points on their visible faces, Gaussian noise. One parameter is
the benchmark's own: with ``min_gap`` an object is drawn again until it
keeps that distance from every object placed before it, in every frame,
so that no two objects touch and merge into one cluster. A cell's
``workloads/<name>.json`` gives the scene parameters; the frames of every
sequence a run may use are made in set-up by :func:`start_sequences`, in
worker processes.
"""
from __future__ import annotations

import contextlib
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass

import numpy as np

SENSOR_HEIGHT = 1.723  # the Waymo preprocessor's z offset


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


# Waymo val-set mean extents; points per frame keep <= 0.09 m surface
# spacing over the three visible faces
_SIZES = {
    "Vehicle": ([4.4, 1.9, 1.6], 2400),
    "Pedestrian": ([0.9, 0.86, 1.75], 320),
    "Cyclist": ([1.76, 0.8, 1.8], 480),
}


_PLACEMENT_TRIES = 1000


def _clear(obj: SceneObject, others: list[SceneObject], n_frames: int,
           gap: float) -> bool:
    """Whether ``obj`` keeps ``gap`` from each of ``others`` in every frame
    (each footprint taken as the disc around its diagonal)."""
    f = np.arange(n_frames)[:, None]
    xy = obj.start_xy + obj.velocity_xy * f
    r = np.hypot(*obj.size[:2]) / 2
    for o in others:
        d = np.linalg.norm(xy - (o.start_xy + o.velocity_xy * f), axis=1)
        if d.min() < r + np.hypot(*o.size[:2]) / 2 + gap:
            return False
    return True


class SyntheticSequence:
    """One procedurally generated sequence (the generator's semantics,
    unchanged: the same seed makes the same frames as the program's
    copy)."""

    def __init__(self, n_frames: int = 20, seed: int = 0,
                 n_ground: int = 6000, n_vehicles: int = 3,
                 n_pedestrians: int = 2, n_cyclists: int = 0,
                 n_moving: int = 2, area: float = 40.0,
                 ego_speed: float = 0.5, noise: float = 0.02,
                 min_gap: float | None = None):
        self.sequence_length = n_frames
        self.rng = np.random.default_rng(seed)
        self.noise = noise
        self.area = area

        self.objects: list[SceneObject] = []
        kinds = (["Vehicle"] * n_vehicles + ["Pedestrian"] * n_pedestrians
                 + ["Cyclist"] * n_cyclists)

        def sample_pos():
            p = self.rng.uniform(-area / 2 + 6, area / 2 - 6, 2)
            while np.linalg.norm(p) < 4.0:
                p = self.rng.uniform(-area / 2 + 6, area / 2 - 6, 2)
            return p

        def place(i, kind):
            size, npts = _SIZES[kind]
            pos = sample_pos()
            if i < n_moving:
                # >= 0.8 m/frame so the entropy window separates cleanly
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
            return SceneObject(
                kind=kind, size=np.array(size, np.float64), start_xy=pos,
                velocity_xy=vel, heading=heading, points_per_frame=npts)

        for i, kind in enumerate(kinds):
            obj = place(i, kind)
            if min_gap is not None:
                # drawn again until it keeps min_gap from every object
                # placed before it, in every frame (footprints as discs)
                for _ in range(_PLACEMENT_TRIES):
                    if _clear(obj, self.objects, n_frames, min_gap):
                        break
                    obj = place(i, kind)
                else:
                    raise ValueError(f"no room for {kind} {i} at "
                                     f"min_gap {min_gap} m in {area} m")
            self.objects.append(obj)

        # the ego drives +x at constant speed, the sensor SENSOR_HEIGHT up
        self.poses = []
        for fnr in range(n_frames):
            pose = np.eye(4)
            pose[0, 3] = ego_speed * fnr
            pose[2, 3] = SENSOR_HEIGHT
            self.poses.append(pose)

        # a world-frame ground that persists across frames
        corridor = area + ego_speed * n_frames
        n_total = int(n_ground * corridor / area)
        gx = self.rng.uniform(-area / 2, area / 2 + ego_speed * n_frames,
                              n_total)
        gy = self.rng.uniform(-area / 2, area / 2, n_total)
        self._ground_world = np.stack([gx, gy, np.zeros(n_total)], axis=1)

    def _object_points(self, obj: SceneObject, fnr: int, rng) -> np.ndarray:
        """Points on one long side, one short side and the top, area
        proportional (world frame)."""
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

    def ground_count(self, fnr: int) -> int:
        """How many of frame ``fnr``'s points, its first, are the ground."""
        ego_x = self.poses[fnr][0, 3]
        return int(np.sum(np.abs(self._ground_world[:, 0] - ego_x)
                          < self.area / 2))

    def frame(self, fnr: int) -> np.ndarray:
        """Frame ``fnr`` in the sensor frame: (P, 5) float32, x y z and two
        constant features."""
        rng = np.random.default_rng(
            self.rng.bit_generator.seed_seq.entropy % (2**31) + 7919 * fnr)
        ego_x = self.poses[fnr][0, 3]
        in_view = np.abs(self._ground_world[:, 0] - ego_x) < self.area / 2
        parts = [self._ground_world[in_view]]
        for obj in self.objects:
            parts.append(self._object_points(obj, fnr, rng))
        world = np.concatenate(parts, axis=0)
        world += rng.normal(0, self.noise, world.shape)
        inv = np.linalg.inv(self.poses[fnr])
        sensor = world @ inv[:3, :3].T + inv[:3, 3]
        feats = np.full((len(sensor), 2), 0.5, np.float32)
        return np.concatenate([sensor, feats], axis=1).astype(np.float32)


class Sequence:
    """A made sequence: its frames and poses, served to the program as a
    sequence source (``sequence_length``, ``get_lidar_points``,
    ``get_pose``), and how many of each frame's points are the ground."""

    def __init__(self, frames: list[np.ndarray], poses: list[np.ndarray],
                 ground_counts: list[int]):
        self.frames, self.poses = frames, poses
        self.ground_counts = ground_counts
        self.sequence_length = len(frames)

    def get_lidar_points(self, fnr: int) -> np.ndarray:
        return self.frames[fnr]

    def get_pose(self, fnr: int) -> np.ndarray:
        return self.poses[fnr]

    def head(self, n: int) -> "Sequence":
        """The first ``n`` frames (the same scene, cut)."""
        return Sequence(self.frames[:n], self.poses[:n],
                        self.ground_counts[:n])


class Dataset:
    """``names`` served cyclically from ``sequences``: the window takes as
    many sequences as it runs, the set-up makes only a few."""

    def __init__(self, sequences: list[Sequence], n_names: int = 64):
        self.sequences = sequences
        self.names = [f"seq_{i:03d}" for i in range(n_names)]

    def sequence_names(self):
        return list(self.names)

    def sequence(self, name: str) -> Sequence:
        return self.sequences[self.names.index(name) % len(self.sequences)]


def sequence_seed(seed: int, index: int) -> int:
    """The scene seed of a run's ``index``-th sequence (non-negative)."""
    return (int(seed) % (2**62)) * 16 + index


def _frames(scene: dict, seed: int, lo: int, hi: int) -> list[np.ndarray]:
    seq = SyntheticSequence(seed=seed, **scene)
    return [seq.frame(f) for f in range(lo, hi)]


@contextlib.contextmanager
def _one_thread_children():
    """Spawned workers start with single-threaded numerical libraries
    (workers with a thread per core each slowed the set-up several-fold)."""
    keys = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")
    old = {k: os.environ.get(k) for k in keys}
    os.environ.update(dict.fromkeys(keys, "1"))
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v


class Pending:
    """Sequences being made by worker processes: :meth:`result` waits for
    them and stops every worker."""

    def __init__(self, scene: dict, seed: int, count: int, workers: int,
                 chunk: int):
        self.scene = scene
        self.seeds = [sequence_seed(seed, i) for i in range(count)]
        n = scene["n_frames"]
        self.tasks = [(s, lo, min(lo + chunk, n)) for s in self.seeds
                      for lo in range(0, n, chunk)]
        self.ex = None
        if workers > 1:
            ctx = multiprocessing.get_context("spawn")
            with _one_thread_children():
                self.ex = ProcessPoolExecutor(max_workers=workers,
                                              mp_context=ctx)
            self.futures = [self.ex.submit(_frames, scene, *t)
                            for t in self.tasks]

    def result(self) -> list[Sequence]:
        if self.ex is None:
            parts = [_frames(self.scene, *t) for t in self.tasks]
        else:
            try:
                parts = [f.result() for f in self.futures]
            finally:
                self.close()
        out = []
        for s in self.seeds:
            frames = [fr for (ts, _, _), p in zip(self.tasks, parts)
                      if ts == s for fr in p]
            gen = SyntheticSequence(seed=s, **self.scene)
            out.append(Sequence(frames, gen.poses,
                                [gen.ground_count(f)
                                 for f in range(len(frames))]))
        return out

    def close(self):
        if self.ex is not None:
            self.ex.shutdown(wait=True, cancel_futures=True)
            self.ex = None


def start_sequences(scene: dict, seed: int, count: int,
                    workers: int | None = None, chunk: int = 25) -> Pending:
    """Start making ``count`` sequences of ``scene`` for run seed ``seed``
    in ``workers`` spawned processes (one a core by default; <= 1: made
    in this process when the result is asked for)."""
    if workers is None:
        workers = os.cpu_count() or 1
    return Pending(scene, seed, count, workers, chunk)


def make_sequences(scene: dict, seed: int, count: int,
                   workers: int | None = None,
                   chunk: int = 25) -> list[Sequence]:
    """``count`` sequences of ``scene`` for run seed ``seed``, their frames
    made by ``workers`` processes, every worker stopped before this
    returns."""
    return start_sequences(scene, seed, count, workers, chunk).result()
