"""The geometry stages' reference: the non-ground cloud of a frame in the
world frame of the sequence's first pose, and its points' entropy scores
(MODEST's ephemerality: neighbour counts within 0.3 m in every second
frame of a 15-frame window, H = -sum p log p / log W)."""
from __future__ import annotations

import numpy as np
import torch

from .precision import tf32

POINT_QUANT = 0.005   # the program's input lattice: int16 steps of 5 mm
# the squared radius every neighbour count of the configuration uses: r**2
# in float64 plus half a lattice step's square, rounded to float32 once,
# so pairs exactly on r resolve alike everywhere
RADIUS2_NUDGE = 1.25e-5


def quantized(frame: np.ndarray, max_points: int) -> np.ndarray:
    """The frame's first ``max_points`` points as the program receives
    them: x y z on the 5 mm lattice (float64)."""
    w = frame[:max_points, :3].astype(np.float32) / np.float32(POINT_QUANT)
    q = np.clip(np.rint(w), -32767, 32767).astype(np.int16)
    return q.astype(np.float64) * np.float64(np.float32(POINT_QUANT))


def to_first_pose(pts: np.ndarray, poses, fnr: int) -> np.ndarray:
    """Sensor frame of frame ``fnr`` -> world frame of frame 0 (float64)."""
    t = np.linalg.inv(poses[0]) @ poses[fnr]
    return pts @ t[:3, :3].T + t[:3, 3]


def to_first_pose_control(pts: np.ndarray, poses, fnr: int, device):
    """The same transform as one TF32 product on the card (the control)."""
    t = torch.from_numpy(np.linalg.inv(poses[0]) @ poses[fnr]).float()
    p = torch.from_numpy(pts).float().to(device)
    with tf32(True):
        out = p @ t[:3, :3].T.to(device) + t[:3, 3].to(device)
    return out.double().cpu().numpy()


def window_frames(fnr: int, n_frames: int, window: int = 15,
                  skip_frames: int = 1) -> tuple[list[int], int]:
    """The frames frame ``fnr`` is scored against, and the position of
    ``fnr`` among them (-1 where it is not taken): the window starts at
    clamp(fnr, 0, F - W) and takes every (skip_frames + 1)-th frame."""
    w = min(window, n_frames)
    start = min(max(fnr, 0), max(n_frames - w, 0))
    frames = [start + s for s in range(w)[::skip_frames + 1]]
    return frames, frames.index(fnr) if fnr in frames else -1


def cluster_window(fnr: int, n_frames: int, n_window: int = 2) -> list[int]:
    """The frames whose points make frame ``fnr``'s cluster input: from
    clamp(fnr, 0, F - n) on, ``n_window`` of them."""
    lo = min(max(fnr, 0), max(n_frames - n_window, 0))
    return list(range(lo, min(lo + n_window, n_frames)))


def neighbour_counts(q: torch.Tensor, d: torch.Tensor, radius: float,
                     control: bool = False, block: int = 1024) -> torch.Tensor:
    """For each row of ``q`` (Nq, 3) the points of ``d`` (Nd, 3) within
    ``radius``: squared differences summed x, y, z in float32; the control
    takes |q|^2 + |d|^2 - 2 q.d as one TF32 product."""
    r2 = float(np.float32(np.float64(radius) ** 2 + RADIUS2_NUDGE))
    out = [torch.zeros(0, dtype=torch.int64, device=q.device)]
    for i in range(0, q.shape[0], block):
        qb = q[i:i + block]
        if control:
            with tf32(True):
                d2 = ((qb * qb).sum(1)[:, None] + (d * d).sum(1)[None, :]
                      - 2.0 * qb @ d.T)
        else:
            d2 = (qb[:, 0:1] - d[None, :, 0]) ** 2
            d2 = d2 + (qb[:, 1:2] - d[None, :, 1]) ** 2
            d2 = d2 + (qb[:, 2:3] - d[None, :, 2]) ** 2
        out.append((d2 <= r2).sum(dim=1))
    return torch.cat(out)


def entropy(query: torch.Tensor, window: list[torch.Tensor], seek: int,
            radius: float = 0.3, max_neighbor_points: int = 1000,
            control: bool = False) -> torch.Tensor:
    """Scores of ``query`` (N, 3) against the window's clouds; its own
    frame (position ``seek`` among the window frames taken) does not count
    the point itself."""
    counts = []
    for s, d in enumerate(window):
        c = neighbour_counts(query, d, radius, control)
        c = c.clamp(max=max_neighbor_points + 1)
        if s == seek:
            c = (c - 1).clamp(min=0)
        counts.append(c.clamp(max=max_neighbor_points))
    c = torch.stack(counts, dim=1).float()
    p = c / (c.sum(dim=1, keepdim=True) + 1e-8)
    return (-p * torch.log(p + 1e-8)).sum(dim=1) / np.log(len(window))
