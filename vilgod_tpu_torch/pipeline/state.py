"""Array-resident per-sequence state; the port of
``vilgod_tpu/pipeline/state.py``.

One :class:`SequenceState` holds a whole sequence as fixed-capacity padded
arrays: raw frames (int16 on a 5 mm lattice), the compacted non-ground
cloud, entropy, cluster labels and per-detection tables. The per-point
buffers live on the state's torch device between stages (``device()`` /
``put_device()``) and download to the numpy host mirrors only when host
code reads them. The ``.npz`` checkpoint schema is the JAX package's, so
either package resumes from the other's file.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from ..tracking.tracker import TrackPool
from ..utils.common import resolve_device

CLS_NONE = -1
MAPPED_CLASSES = ("Vehicle", "Pedestrian", "Cyclist", "Background")

ST_UNSET = -1
ST_MOVING = 0
ST_STATIC = 1

# raw-point quantization: int16 at 5 mm covers +-163 m (max_range is 80 m)
POINT_QUANT = 0.005

# per-point buffers that live on device between stages; values are the
# "unset" fill of the padded tail
_LAZY = {
    "ground_mask": False,
    "ng_xyz": 0.0,
    "ng_mask": False,
    "ng_src": -1,
    "ng_entropy": 1.0,
    "labels": -1,
    "probs": 0.0,
}


@dataclass
class Capacity:
    """Fixed padded-buffer sizes."""

    max_points: int = 196608        # raw per-frame cloud
    max_ng_points: int = 131072     # compacted non-ground per-frame cloud
    max_clusters: int = 256         # per-frame detection table
    max_cluster_points: int = 4096  # per-cluster gathered point budget
    max_tracks: int = 1024          # per-sequence track pool
    clip_batch: int = 64

    @classmethod
    def from_cfg(cls, cfg) -> "Capacity":
        cap = (cfg or {}).get("capacity", {}) if hasattr(cfg, "get") else {}
        return cls(
            max_points=cap.get("max_points", 196608),
            max_ng_points=cap.get("max_ng_points",
                                  cap.get("max_ground_points", 131072)),
            max_clusters=cap.get("max_clusters", 256),
            max_cluster_points=cap.get("max_cluster_points", 4096),
            max_tracks=cap.get("max_tracks", 1024),
            clip_batch=cap.get("clip_batch", 64),
        )


@dataclass
class SequenceState:
    """All per-sequence pipeline state as padded arrays.

    F = n_frames, P = max_points, N = max_ng_points, C = max_clusters. The
    per-point buffers of ``_LAZY`` are properties: reading one downloads
    the device-canonical tensor first."""

    name: str
    caps: Capacity
    torch_device: torch.device
    points: np.ndarray        # (F, P, 4) int16, [x y z intensity] / 5 mm
    points_mask: np.ndarray   # (F, P) bool
    poses: np.ndarray         # (F, 4, 4) sensor->world
    _h_ground_mask: np.ndarray   # (F, P) bool
    plane_ref: np.ndarray     # (F, 4) world-frame ground plane; NaN = unset
    _h_ng_xyz: np.ndarray     # (F, N, 3) world frame
    _h_ng_mask: np.ndarray    # (F, N) bool
    _h_ng_src: np.ndarray     # (F, N) int32 index into the raw buffer
    _h_ng_entropy: np.ndarray  # (F, N) float32, 1.0 default
    _h_labels: np.ndarray     # (F, N) int32, -1 noise, else [0, C)
    _h_probs: np.ndarray      # (F, N) float32
    det_n: np.ndarray         # (F, C) int32 point count (0 = no detection)
    det_valid: np.ndarray     # (F, C) bool
    det_static: np.ndarray    # (F, C) bool
    det_static_track: np.ndarray  # (F, C) int8 tri-state
    det_tid: np.ndarray       # (F, C) int32, -1 unassigned
    det_center: np.ndarray    # (F, C, 3) median mass center, world frame
    det_box: np.ndarray       # (F, C, 7) world frame, NaN = unfitted
    det_cls: np.ndarray       # (F, C) int32 index into MAPPED_CLASSES
    det_score: np.ndarray     # (F, C) float32
    done: dict = field(default_factory=dict)   # stage-name -> bool
    tracks: TrackPool | None = None  # attached by track_clusters
    # per-frame detection dicts of evaluate_sequence
    detection_3d_result_list: list | None = None
    _ng_counts: np.ndarray = None  # (F,) non-ground occupancy (stage 1)
    _dev: dict = field(default_factory=dict, repr=False)    # device cache
    _canon: dict = field(default_factory=dict, repr=False)  # name -> _dev key
    _stale: set = field(default_factory=set, repr=False)    # stale mirrors

    @classmethod
    def allocate(cls, name: str, n_frames: int, caps: Capacity,
                 n_feat: int = 5, device=None):
        F, P, N, C = (n_frames, caps.max_points, caps.max_ng_points,
                      caps.max_clusters)
        return cls(
            name=name,
            caps=caps,
            torch_device=resolve_device(device),
            points=np.zeros((F, P, min(n_feat, 4)), np.int16),
            points_mask=np.zeros((F, P), bool),
            poses=np.tile(np.eye(4, dtype=np.float32), (F, 1, 1)),
            _h_ground_mask=np.zeros((F, P), bool),
            plane_ref=np.full((F, 4), np.nan, np.float32),
            _h_ng_xyz=np.zeros((F, N, 3), np.float32),
            _h_ng_mask=np.zeros((F, N), bool),
            _h_ng_src=np.full((F, N), -1, np.int32),
            _h_ng_entropy=np.ones((F, N), np.float32),
            _h_labels=np.full((F, N), -1, np.int32),
            _h_probs=np.zeros((F, N), np.float32),
            det_n=np.zeros((F, C), np.int32),
            det_valid=np.zeros((F, C), bool),
            det_static=np.ones((F, C), bool),
            det_static_track=np.full((F, C), ST_UNSET, np.int8),
            det_tid=np.full((F, C), -1, np.int32),
            det_center=np.zeros((F, C, 3), np.float32),
            det_box=np.full((F, C, 7), np.nan, np.float32),
            det_cls=np.full((F, C), CLS_NONE, np.int32),
            det_score=np.zeros((F, C), np.float32),
        )

    @property
    def n_frames(self) -> int:
        return self.points.shape[0]

    def transform_to_ref(self, fnr: int) -> np.ndarray:
        """Sensor -> world-of-frame-0."""
        return np.linalg.inv(self.poses[0]) @ self.poses[fnr]

    def transform_to_ego(self, fnr: int) -> np.ndarray:
        """World-of-frame-0 -> sensor."""
        return np.linalg.inv(self.poses[fnr]) @ self.poses[0]

    def set_frame(self, fnr: int, points: np.ndarray, pose: np.ndarray):
        """Store one frame, quantized to int16 on the 5 mm lattice exactly
        as the JAX package does (divide, rint, clip over f32)."""
        n = min(len(points), self.caps.max_points)
        c = min(points.shape[1], self.points.shape[2])
        w = np.ascontiguousarray(points[:n, :c], dtype=np.float32)
        np.divide(w, np.float32(POINT_QUANT), out=w)
        np.rint(w, out=w)
        np.clip(w, -32767, 32767, out=w)
        self.points[fnr, :n, :c] = w.astype(np.int16)
        self.points_mask[fnr, :n] = True
        self.poses[fnr] = pose

    # -- device residency ----------------------------------------------
    def _host_array(self, name: str) -> np.ndarray:
        """Host mirror of a lazy buffer, synced down if the device copy is
        newer."""
        host = getattr(self, "_h_" + name)
        if name not in self._stale:
            return host
        arr = self._dev[self._canon[name]].cpu().numpy()
        f = min(self.n_frames, arr.shape[0])
        host[...] = _LAZY[name]
        if host.ndim >= 2 and arr.shape[1] != host.shape[1]:
            host[:f, : arr.shape[1]] = arr[:f]
        else:
            host[:f] = arr[:f]
        self._stale.discard(name)
        return host

    def put_device(self, name: str, arr: torch.Tensor, f_pad: int,
                   n_points: int):
        """Install a freshly computed device tensor as the canonical copy
        of a lazy buffer; the host mirror becomes stale until read."""
        assert name in _LAZY, name
        for key in list(self._dev):
            if key[0] == name:
                del self._dev[key]
        key = (name, f_pad, n_points)
        self._dev[key] = arr
        self._canon[name] = key
        self._stale.add(name)
        if name in ("labels", "ng_mask", "ng_xyz"):
            for key in list(self._dev):
                if key[0] == "det_tables":
                    del self._dev[key]

    def device(self, name: str, f_pad: int | None = None,
               n_points: int | None = None) -> torch.Tensor:
        """Device copy of a per-frame array, padded to ``f_pad`` frames and
        sliced (or padded) to ``n_points`` along the point axis: an exact
        cached entry, else a slice/pad of the canonical device tensor,
        else an upload of the host mirror (raw points upload as int16 and
        dequantize on the device)."""
        key = (name, f_pad, n_points)
        if key in self._dev:
            return self._dev[key]

        canon = self._canon.get(name)
        if canon is not None:
            arr = self._dev[canon]
            if (n_points is not None and arr.dim() >= 2
                    and n_points != arr.shape[1]):
                arr = _resize_axis(arr, 1, n_points, _LAZY[name])
            if f_pad is not None and f_pad != arr.shape[0]:
                arr = _resize_axis(arr, 0, f_pad, _LAZY[name])
            self._dev[key] = arr
            return arr

        dev = self.torch_device
        if name == "points_mask":
            # points are front-compacted per frame: the (F,) occupancy
            # counts describe the mask
            counts = self.points_mask.sum(axis=1).astype(np.int64)
            if f_pad and f_pad > len(counts):
                counts = np.concatenate(
                    [counts, np.zeros(f_pad - len(counts), np.int64)])
            counts_t = torch.from_numpy(counts).to(dev)
            self._dev[key] = (torch.arange(n_points, device=dev)[None, :]
                              < counts_t[:, None])
            return self._dev[key]

        host = self._host_array(name) if name in _LAZY else getattr(self, name)
        arr = host
        f_pad = f_pad or arr.shape[0]
        if n_points is not None and arr.ndim >= 2:
            arr = arr[:, :n_points]
        if f_pad > arr.shape[0]:
            pad = np.zeros((f_pad - arr.shape[0],) + arr.shape[1:], arr.dtype)
            arr = np.concatenate([arr, pad])
        t = torch.from_numpy(np.ascontiguousarray(arr)).to(dev)
        if name == "points":
            # int16 5 mm lattice -> f32 (quantize(0) == 0, so frame padding
            # commutes); f32 product like the JAX package's dequant
            t = t.to(torch.float32) * torch.tensor(
                POINT_QUANT, dtype=torch.float32, device=dev)
        self._dev[key] = t
        return t

    def prefetch(self, f_pad: int | None = None):
        """Upload the raw cloud before the pipeline starts."""
        if f_pad is None:
            from .stages_geometry import frame_bucket
            f_pad = frame_bucket(self.n_frames)
        n_pts = self.points_bucket()
        self.device("points", f_pad, n_pts)
        self.device("points_mask", f_pad, n_pts)

    def det_tables(self, f_pad: int, n_ng: int):
        """Device-resident per-frame cluster gather tables (F_pad, C, cap)
        and their masks. ``spatial_clustering`` leaves them in the cache;
        after a labels mutation or an ``.npz`` resume they are rebuilt
        here from the labels."""
        from ..ops.cluster import build_cluster_table

        key = ("det_tables", f_pad, n_ng)
        if key not in self._dev:
            labels = self.device("labels", f_pad, n_ng)
            ng_mask = self.device("ng_mask", f_pad, n_ng)
            built = [build_cluster_table(labels[f], ng_mask[f],
                                         self.caps.max_clusters,
                                         self.caps.max_cluster_points)
                     for f in range(f_pad)]
            self._dev[key] = tuple(torch.stack(t) for t in zip(*built))
        return self._dev[key]

    def ng_bucket(self) -> int:
        """Multiple-of-8192 bucket (>= 8192) of the max per-frame
        non-ground occupancy."""
        if self._ng_counts is not None:
            used = int(self._ng_counts.max()) if len(self._ng_counts) else 1
        else:
            ng_mask = self._host_array("ng_mask")
            used = int(ng_mask.sum(axis=1).max()) if ng_mask.any() else 1
        b = max(8192, -(-max(used, 1) // 8192) * 8192)
        return min(b, self.caps.max_ng_points)

    def points_bucket(self) -> int:
        """Multiple-of-8192 bucket of the max raw occupancy."""
        used = (int(self.points_mask.sum(axis=1).max())
                if self.points_mask.any() else 1)
        return min(-(-used // 8192) * 8192, self.caps.max_points)

    # -- checkpoint / resume (the JAX package's schema) ----------------
    _SAVE_DENSE = (
        "ground_mask", "plane_ref", "ng_src", "labels", "probs",
        "det_n", "det_valid", "det_static", "det_static_track", "det_tid",
        "det_center", "det_box", "det_cls", "det_score",
    )

    def save(self, path: str | Path):
        """Write the stage-output checkpoint. Entropy is stored sparsely
        below 0.9."""
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        ng_entropy = self.ng_entropy
        sel = ng_entropy < 0.9
        f_idx, p_idx = np.nonzero(sel)
        payload = {k: getattr(self, k) for k in self._SAVE_DENSE}
        payload["entropy_frame_idx"] = f_idx.astype(np.int32)
        payload["entropy_point_idx"] = p_idx.astype(np.int32)
        payload["entropy_values"] = ng_entropy[sel].astype(np.float32)
        payload["done_keys"] = np.array(
            sorted(k for k, v in self.done.items() if v))
        if self.tracks is not None:
            for k, v in self.tracks.serialize().items():
                payload[f"trk_{k}"] = v
        np.savez_compressed(path, **payload)

    def load(self, path: str | Path) -> bool:
        path = Path(path)
        if not path.exists():
            return False
        with np.load(path, allow_pickle=False) as data:
            for k in self._SAVE_DENSE:
                if k in data and data[k].shape == getattr(self, k).shape:
                    getattr(self, k)[...] = data[k]
            self._h_ng_entropy[...] = 1.0
            self._h_ng_entropy[data["entropy_frame_idx"],
                               data["entropy_point_idx"]] = data["entropy_values"]
            self.done = {str(k): True for k in data["done_keys"]}
            trk = {k[4:]: data[k] for k in data.files if k.startswith("trk_")}
            self.tracks = TrackPool.deserialize(trk) if trk else None
        # the loaded host arrays are canonical; the ng buffers' geometry is
        # rebuilt from the raw frames by the runner
        self._dev.clear()
        self._canon.clear()
        self._stale.clear()
        return True


def _resize_axis(arr: torch.Tensor, axis: int, size: int, fill):
    """Slice or pad ``arr`` along ``axis`` to ``size``."""
    if size <= arr.shape[axis]:
        return arr.narrow(axis, 0, size)
    shape = list(arr.shape)
    shape[axis] = size - arr.shape[axis]
    pad = torch.full(shape, fill, dtype=arr.dtype, device=arr.device)
    return torch.cat([arr, pad], dim=axis)


def _make_lazy_property(name: str):
    def get(self: SequenceState) -> np.ndarray:
        return self._host_array(name)

    get.__name__ = name
    get.__doc__ = f"Host mirror of `{name}` (lazily synced from device)."
    return property(get)


for _name in _LAZY:
    setattr(SequenceState, _name, _make_lazy_property(_name))
