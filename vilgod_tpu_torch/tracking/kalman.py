"""Batched constant-velocity Kalman filter over a track pool; the port's
own copy of ``vilgod_tpu/tracking/kalman.py`` (host-side numpy).

State [x, y, vx, vy], dt = 0.1, position-only measurements; the whole
pool predicts and updates in one vectorised step. The reference's quirks
stay: the process noise is filterpy's 4th-order single-axis
``Q_discrete_white_noise(dim=4, dt, var=0.15)`` applied as-is to
[x, y, vx, vy], and the measurement noise is the identity.
"""
from __future__ import annotations

import numpy as np

DT = 0.1


def _q_discrete_white_noise_4(dt: float, var: float) -> np.ndarray:
    # the (x, x', x'', x''') ladder, applied as-is to [x, y, vx, vy]
    return var * np.array(
        [
            [(dt**6) / 36, (dt**5) / 12, (dt**4) / 6, (dt**3) / 6],
            [(dt**5) / 12, (dt**4) / 4, (dt**3) / 2, (dt**2) / 2],
            [(dt**4) / 6, (dt**3) / 2, dt**2, dt],
            [(dt**3) / 6, (dt**2) / 2, dt, 1.0],
        ],
        dtype=np.float64,
    )


F_MAT = np.array([[1.0, 0.0, DT, 0.0], [0.0, 1.0, 0.0, DT],
                  [0.0, 0.0, 1.0, 0.0], [0.0, 0.0, 0.0, 1.0]])
Q_MAT = _q_discrete_white_noise_4(DT, 0.15)
H_MAT = np.array([[1.0, 0.0, 0.0, 0.0], [0.0, 1.0, 0.0, 0.0]])
R_MAT = np.eye(2)
P0_MAT = np.diag([10.0, 10.0, 500.0, 500.0])  # P[2:,2:]*=50 then P*=10


def kf_init(centers_xy: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Seed (T, 2) centres -> states (T, 4) [x, y, 0, 0] and covs (T, 4, 4)."""
    t = len(centers_xy)
    x = np.zeros((t, 4))
    x[:, :2] = centers_xy
    return x, np.tile(P0_MAT, (t, 1, 1))


def kf_predict(x: np.ndarray, p: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Batched predict: x (T, 4), p (T, 4, 4)."""
    x_new = x @ F_MAT.T
    p_new = np.einsum("ij,tjk,lk->til", F_MAT, p, F_MAT) + Q_MAT
    return x_new, p_new


def kf_update(x: np.ndarray, p: np.ndarray,
              z: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Batched position update: z (T, 2)."""
    y = z - x @ H_MAT.T                                   # innovation (T, 2)
    s = np.einsum("ij,tjk,lk->til", H_MAT, p, H_MAT) + R_MAT
    s_inv = np.linalg.inv(s)
    k = np.einsum("tij,kj,tkl->til", p, H_MAT, s_inv)     # gain (T, 4, 2)
    x_new = x + np.einsum("tij,tj->ti", k, y)
    kh = np.einsum("tij,jk->tik", k, H_MAT)
    i_kh = np.eye(4) - kh
    # Joseph form (filterpy's default update: (I-KH)P(I-KH)' + KRK')
    p_new = np.einsum("tij,tjk,tlk->til", i_kh, p, i_kh) + np.einsum(
        "tij,jk,tlk->til", k, R_MAT, k
    )
    return x_new, p_new
