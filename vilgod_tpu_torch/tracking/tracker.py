"""Table-based multi-object tracker (cluster-centre mode); the port's own
copy of ``vilgod_tpu/tracking/tracker.py`` (host-side numpy).

Tracks are rows of a fixed-capacity pool; the per-frame association is a
batched KF predict, an assignment and a vectorised KF update. A track
step stores a source pointer (frame, cluster): a prediction step points
at the last real detection, which is what the reference's cloned
detection holds. Reference behaviours kept:
- a distance-rejected pair is rescued when the point-count ratio is
  > 0.7 and the 3D mass-centre distance < 5 m;
- a rescued detection still spawns a fresh track (the spawn loop checks
  the filtered match list);
- finalising trims trailing prediction steps;
- a track finalises after ``max_missed`` misses.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .assign import ASSIGNMENT_FNS
from .kalman import kf_init, kf_predict, kf_update


@dataclass
class TrackPool:
    """Fixed-capacity pool of tracks over an F-frame sequence."""

    cap: int
    n_frames: int
    n_tracks: int
    active: np.ndarray       # (T,) bool
    valid: np.ndarray        # (T,) bool
    static: np.ndarray       # (T,) bool track-level motion
    first: np.ndarray        # (T,) int32 first frame, -1 unset
    last: np.ndarray         # (T,) int32 last frame with an entry
    miss: np.ndarray         # (T,) int32 consecutive miss count
    src_frame: np.ndarray    # (T, F) int32 source frame of step entry, -1 none
    src_cluster: np.ndarray  # (T, F) int32 source cluster id
    is_pred: np.ndarray      # (T, F) bool prediction (miss) step
    kf_x: np.ndarray         # (T, 4)
    kf_p: np.ndarray         # (T, 4, 4)
    pred_center: np.ndarray  # (T, 3) current_prediction
    last_center: np.ndarray  # (T, 3) mass center of last *real* detection
    last_npoints: np.ndarray  # (T,) point count of last *real* detection

    @classmethod
    def allocate(cls, cap: int, n_frames: int) -> "TrackPool":
        return cls(
            cap=cap, n_frames=n_frames, n_tracks=0,
            active=np.zeros(cap, bool), valid=np.ones(cap, bool),
            static=np.ones(cap, bool),
            first=np.full(cap, -1, np.int32), last=np.full(cap, -1, np.int32),
            miss=np.zeros(cap, np.int32),
            src_frame=np.full((cap, n_frames), -1, np.int32),
            src_cluster=np.full((cap, n_frames), -1, np.int32),
            is_pred=np.zeros((cap, n_frames), bool),
            kf_x=np.zeros((cap, 4)), kf_p=np.zeros((cap, 4, 4)),
            pred_center=np.zeros((cap, 3)), last_center=np.zeros((cap, 3)),
            last_npoints=np.zeros(cap, np.int32),
        )

    # -- views ---------------------------------------------------------
    def length(self, tid: int) -> int:
        return int(np.sum(self.src_frame[tid] >= 0))

    def steps(self, tid: int):
        """Yield (frame, src_frame, src_cluster, is_pred) for each entry."""
        frames = np.flatnonzero(self.src_frame[tid] >= 0)
        for f in frames:
            yield int(f), int(self.src_frame[tid, f]), int(self.src_cluster[tid, f]), bool(
                self.is_pred[tid, f])

    def valid_tracks(self) -> np.ndarray:
        return np.flatnonzero(self.valid[: self.n_tracks])

    # -- serialization -------------------------------------------------
    def serialize(self) -> dict:
        n = self.n_tracks
        return {
            "active": self.active[:n], "valid": self.valid[:n], "static": self.static[:n],
            "first": self.first[:n], "last": self.last[:n], "miss": self.miss[:n],
            "src_frame": self.src_frame[:n], "src_cluster": self.src_cluster[:n],
            "is_pred": self.is_pred[:n], "kf_x": self.kf_x[:n], "kf_p": self.kf_p[:n],
            "pred_center": self.pred_center[:n], "last_center": self.last_center[:n],
            "last_npoints": self.last_npoints[:n],
            "meta": np.array([self.cap, self.n_frames, n], np.int64),
        }

    @classmethod
    def deserialize(cls, data: dict) -> "TrackPool":
        cap, n_frames, n = (int(v) for v in data["meta"])
        pool = cls.allocate(cap, n_frames)
        pool.n_tracks = n
        for k in ("active", "valid", "static", "first", "last", "miss", "src_frame",
                  "src_cluster", "is_pred", "kf_x", "kf_p", "pred_center", "last_center",
                  "last_npoints"):
            getattr(pool, k)[:n] = data[k]
        return pool


class Tracker:
    """Per-frame association driver over a :class:`TrackPool`."""

    def __init__(self, n_frames: int, cfg: dict, cap: int = 1024):
        self.cfg = cfg
        self.max_distance = cfg.get("assignment", {}).get("max_distance", 1.0)
        self.max_missed = cfg.get("max_missed", 3)
        method = cfg.get("assignment", {}).get("method", "assign_detections_greedy")
        self.assign = ASSIGNMENT_FNS[method]
        self.pool = TrackPool.allocate(cap, n_frames)

    def next(self, fnr: int, det_clusters: np.ndarray, det_centers: np.ndarray,
             det_npoints: np.ndarray) -> np.ndarray:
        """Associate one frame's detections.

        det_clusters: (D,) cluster column ids; det_centers: (D, 3) world
        mass centers; det_npoints: (D,). Returns (D,) assigned track ids
        (-1 for none — note a detection that seeds a new track gets that
        new track's id).
        """
        pool = self.pool
        active_ids = np.flatnonzero(pool.active[: pool.n_tracks])
        d = len(det_clusters)
        tids = np.full(d, -1, np.int32)

        # batched KF predict for all active tracks
        if len(active_ids) > 0:
            x, p = kf_predict(pool.kf_x[active_ids], pool.kf_p[active_ids])
            pool.kf_x[active_ids], pool.kf_p[active_ids] = x, p
            pool.pred_center[active_ids, :2] = x[:, :2]
            pool.pred_center[active_ids, 2] = pool.last_center[active_ids, 2]

        matches_all, mask, _ = self.assign(
            det_centers[:, :2].reshape(d, -1) if d else np.zeros((0, 2)),
            pool.pred_center[active_ids][:, :2] if len(active_ids) else np.zeros((0, 2)),
            max_distance=self.max_distance,
        )
        if len(matches_all) > 0:
            matches = matches_all[mask[matches_all[:, 0]]]
        else:
            matches = matches_all

        matched_real: list[tuple[int, int]] = []  # (track_id, det_idx)
        for t_idx, tid in enumerate(active_ids):
            in_filtered = len(matches) > 0 and t_idx in matches[:, 1]
            in_all = len(matches_all) > 0 and t_idx in matches_all[:, 1]
            if in_filtered:
                d_idx = int(matches[matches[:, 1] == t_idx, 0][0])
                matched_real.append((tid, d_idx))
            elif in_all:
                d_idx = int(matches_all[matches_all[:, 1] == t_idx, 0][0])
                n1, n2 = int(det_npoints[d_idx]), int(pool.last_npoints[tid])
                c1, c2 = det_centers[d_idx], pool.last_center[tid]
                ratio = min(n1, n2) / max(max(n1, n2), 1)
                if ratio > 0.7 and np.linalg.norm(c1 - c2) < 5.0:
                    matched_real.append((tid, d_idx))
                else:
                    self._miss_step(tid, fnr)
            else:
                if pool.miss[tid] >= self.max_missed:
                    self.finalize(tid)
                else:
                    self._miss_step(tid, fnr)

        # vectorized KF update for all real matches 
        if matched_real:
            m_tids = np.array([t for t, _ in matched_real])
            m_dets = np.array([di for _, di in matched_real])
            z = det_centers[m_dets, :2]
            x, p = kf_update(pool.kf_x[m_tids], pool.kf_p[m_tids], z)
            pool.kf_x[m_tids], pool.kf_p[m_tids] = x, p
            pool.miss[m_tids] = 0
            pool.src_frame[m_tids, fnr] = fnr
            pool.src_cluster[m_tids, fnr] = det_clusters[m_dets]
            pool.is_pred[m_tids, fnr] = False
            pool.last[m_tids] = fnr
            pool.last_center[m_tids] = det_centers[m_dets]
            pool.last_npoints[m_tids] = det_npoints[m_dets]
            tids[m_dets] = m_tids

        # spawn tracks for detections not in the *filtered* matches
        # (a rescued detection spawns too; see the module doc)
        in_filtered_dets = set(int(i) for i in matches[:, 0]) if len(matches) else set()
        for d_idx in range(d):
            if d_idx not in in_filtered_dets:
                tid = self._spawn(fnr, int(det_clusters[d_idx]), det_centers[d_idx],
                                  int(det_npoints[d_idx]))
                if tids[d_idx] == -1:
                    tids[d_idx] = tid
        return tids

    def _spawn(self, fnr: int, cluster: int, center: np.ndarray, npoints: int) -> int:
        pool = self.pool
        if pool.n_tracks >= pool.cap:
            return -1
        tid = pool.n_tracks
        pool.n_tracks += 1
        pool.active[tid] = True
        pool.first[tid] = fnr
        pool.last[tid] = fnr
        pool.src_frame[tid, fnr] = fnr
        pool.src_cluster[tid, fnr] = cluster
        pool.is_pred[tid, fnr] = False
        x, p = kf_init(center[None, :2])
        pool.kf_x[tid], pool.kf_p[tid] = x[0], p[0]
        pool.pred_center[tid] = center
        pool.last_center[tid] = center
        pool.last_npoints[tid] = npoints
        return tid

    def _miss_step(self, tid: int, fnr: int):
        pool = self.pool
        pool.miss[tid] += 1
        prev = pool.last[tid]
        pool.src_frame[tid, fnr] = pool.src_frame[tid, prev]
        pool.src_cluster[tid, fnr] = pool.src_cluster[tid, prev]
        pool.is_pred[tid, fnr] = True
        pool.last[tid] = fnr

    def finalize(self, tid: int):
        """Deactivate and trim trailing prediction steps."""
        pool = self.pool
        pool.active[tid] = False
        f = int(pool.last[tid])
        while f >= 0 and pool.src_frame[tid, f] >= 0 and pool.is_pred[tid, f]:
            pool.src_frame[tid, f] = -1
            pool.src_cluster[tid, f] = -1
            pool.is_pred[tid, f] = False
            f -= 1
        pool.last[tid] = f

    def finish(self) -> TrackPool:
        for tid in np.flatnonzero(self.pool.active[: self.pool.n_tracks]):
            self.finalize(int(tid))
        return self.pool
