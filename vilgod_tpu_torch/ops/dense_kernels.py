"""The dense (all-pairs) neighbour kernels: CUDA wrappers, plain PyTorch
versions and launch counts. The port of the five dense ``tile_*`` kernels
of ``vilgod_tpu/ops/pallas_kernels.py``: four on the small-input and
overflow paths of ``ops/neighbors.py``, ``ops/entropy.py`` and
``ops/cluster.py``, and ``tile_min_label_qd``, which has no caller in
either package (the per-block min-label pass that the single-launch banded
kernels replaced).

Layout as in ``ops/kernels.py``: clouds are ``(8, N)`` float32 from
:func:`~vilgod_tpu_torch.ops.kernels.prep_t8` with invalid points at the
far sentinel; every query meets every data point; squared distances are
``(q - d)**2`` summed over rows 0..ndim-1 in order, each product and sum
rounded on its own, so kernel and plain version agree bit for bit.
Indices are into the caller's data order.

Each wrapper takes its plain version only for CPU tensors. For CUDA
tensors it launches its kernel from ``csrc/dense.cu`` (built by
``utils/cuda_build.py`` at first use) or raises; it never falls back.
``LAUNCHES`` counts kernel launches per wrapper.
"""
from __future__ import annotations

import ctypes

import torch

from ..utils.cuda_build import CudaLibrary, launch, stream_of
from .kernels import _check, _dist2_t8, _plain_chunk

KERNEL_NAMES = ("tile_radius_count", "tile_radius_count3", "tile_min_label",
                "tile_nearest", "tile_min_label_qd")
LAUNCHES = {name: 0 for name in KERNEL_NAMES}


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def _columns(q_t8, d_t8, ndim):
    """(first column, dist2 tile (Nq, chunk)) over all data columns."""
    n_d = d_t8.shape[1]
    chunk = _plain_chunk(q_t8.device)
    for k in range(0, n_d, chunk):
        yield k, _dist2_t8(q_t8, d_t8[:, k:k + chunk], ndim)


def count_plain(q_t8, d_t8, r2, ndim):
    out = torch.zeros(q_t8.shape[1], dtype=torch.int32, device=q_t8.device)
    for _, dist2 in _columns(q_t8, d_t8, ndim):
        out += (dist2 <= r2).sum(dim=1, dtype=torch.int32)
    return out


def count3_plain(q_t8, d_t8, levels2, ndim):
    out = torch.zeros((q_t8.shape[1], 3), dtype=torch.int32,
                      device=q_t8.device)
    for _, dist2 in _columns(q_t8, d_t8, ndim):
        for lv in range(3):
            out[:, lv] += (dist2 <= levels2[lv]).sum(dim=1, dtype=torch.int32)
    return out


def min_label_plain(pts_t8, radius2, labels, ndim, big):
    return min_label_qd_plain(pts_t8, pts_t8, radius2, radius2, labels, ndim,
                              big)


def min_label_qd_plain(q_t8, d_t8, q_r2, d_r2, labels, ndim, big):
    out = torch.full((q_t8.shape[1],), big, dtype=torch.int32,
                     device=q_t8.device)
    big_t = torch.tensor(big, dtype=torch.int32, device=q_t8.device)
    for k, dist2 in _columns(q_t8, d_t8, ndim):
        e = k + dist2.shape[1]
        # max-radius joint: HDBSCAN mutual-reachability linkage
        joint = torch.maximum(q_r2[:, None], d_r2[k:e][None, :])
        cand = torch.where(dist2 <= joint, labels[k:e][None, :], big_t)
        out = torch.minimum(out, cand.amin(dim=1))
    return out


def nearest_plain(q_t8, d_t8, ndim):
    n_q = q_t8.shape[1]
    dist = torch.full((n_q,), float("inf"), dtype=torch.float32,
                      device=q_t8.device)
    idx = torch.zeros(n_q, dtype=torch.int32, device=q_t8.device)
    for k, dist2 in _columns(q_t8, d_t8, ndim):
        # the first minimum of each tile, and a later tile only when
        # strictly nearer: the lowest index wins ties (argmin)
        best, arg = dist2.min(dim=1)
        take = best < dist
        dist = torch.where(take, best, dist)
        idx = torch.where(take, (arg + k).to(torch.int32), idx)
    return dist, idx


# ---------------------------------------------------------------------------
# the CUDA library
# ---------------------------------------------------------------------------

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# -fmad=false: every product and sum rounds on its own, as the plain
# versions' separate ops do
LIBRARY = CudaLibrary("dense.cu", {
    # q, nq, d, nd, ndim, r2, out, stream
    "dense_count": (_P, _I, _P, _I, _I, _F, _P, _P),
    # q, nq, d, nd, ndim, levels2, out, stream
    "dense_count3": (_P, _I, _P, _I, _I, _P, _P, _P),
    # pts, n, radius2, labels, ndim, big, out, stream
    "dense_min_label": (_P, _I, _P, _P, _I, _I, _P, _P),
    # q, nq, d, nd, q_r2, d_r2, labels, ndim, big, out, stream
    "dense_min_label_qd": (_P, _I, _P, _I, _P, _P, _P, _I, _I, _P, _P),
    # q, nq, d, nd, ndim, keys, dist, idx, stream
    "dense_nearest": (_P, _I, _P, _I, _I, _P, _P, _P, _P),
}, extra_flags=("-fmad=false",))


def _check_clouds(name, q_t8, d_t8, ndim):
    for arg, t in (("query", q_t8), ("data", d_t8)):
        if t.dim() != 2 or t.shape[0] != 8 or t.shape[1] == 0:
            raise ValueError(f"{name}: {arg} points must be (8, N > 0), got "
                             f"{tuple(t.shape)}")
    if ndim not in (3, 4, 5, 6):
        raise ValueError(f"{name}: ndim {ndim} not in (3, 4, 5, 6)")
    if q_t8.shape[1] >= 2 ** 31 or d_t8.shape[1] >= 2 ** 31:
        raise ValueError(f"{name}: more than 2**31 points")


def _launch(name, fn, *args):
    launch(fn, *args)
    LAUNCHES[name] += 1


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def tile_radius_count(q_t8, d_t8, r2: float, ndim: int = 3) -> torch.Tensor:
    """Per query: data points with squared distance <= ``r2`` (self
    included) -> (Nq,) int32. Replaces ``pallas_kernels.tile_radius_count``."""
    name = "tile_radius_count"
    _check_clouds(name, q_t8, d_t8, ndim)
    _check(name, {"q_t8": q_t8, "d_t8": d_t8},
           (torch.float32, torch.float32), q_t8.device)
    if not q_t8.is_cuda:
        return count_plain(q_t8, d_t8, r2, ndim)
    out = torch.zeros(q_t8.shape[1], dtype=torch.int32, device=q_t8.device)
    with torch.cuda.device(q_t8.device):
        _launch(name, LIBRARY.load().dense_count, q_t8.data_ptr(),
                q_t8.shape[1], d_t8.data_ptr(), d_t8.shape[1], ndim,
                float(r2), out.data_ptr(), stream_of(q_t8.device))
    return out


def tile_radius_count3(q_t8, d_t8, levels2, ndim: int = 3) -> torch.Tensor:
    """Counts at three squared radii ``levels2`` (3,) f32 -> (Nq, 3) int32.
    Replaces ``pallas_kernels.tile_radius_count3``."""
    name = "tile_radius_count3"
    _check_clouds(name, q_t8, d_t8, ndim)
    _check(name, {"q_t8": q_t8, "d_t8": d_t8, "levels2": levels2},
           (torch.float32, torch.float32, torch.float32), q_t8.device)
    if levels2.shape != (3,):
        raise ValueError(f"{name}: levels2 must be (3,), got "
                         f"{tuple(levels2.shape)}")
    if not q_t8.is_cuda:
        return count3_plain(q_t8, d_t8, levels2, ndim)
    out = torch.zeros((q_t8.shape[1], 3), dtype=torch.int32,
                      device=q_t8.device)
    with torch.cuda.device(q_t8.device):
        _launch(name, LIBRARY.load().dense_count3, q_t8.data_ptr(),
                q_t8.shape[1], d_t8.data_ptr(), d_t8.shape[1], ndim,
                levels2.data_ptr(), out.data_ptr(), stream_of(q_t8.device))
    return out


def tile_min_label(pts_t8, radius2, labels, ndim: int, big: int = 2 ** 30):
    """Per point: the minimum label over points within max(radius2_q,
    radius2_d), else ``big`` -> (N,) int32. Points that take no part carry
    sentinel coordinates, radius 0 and a label >= ``big``. Replaces
    ``pallas_kernels.tile_min_label`` (which carries the labels as f32,
    exact below 2**24)."""
    name = "tile_min_label"
    n = pts_t8.shape[1]
    _check_clouds(name, pts_t8, pts_t8, ndim)
    _check(name, {"pts_t8": pts_t8, "radius2": radius2, "labels": labels},
           (torch.float32, torch.float32, torch.int32), pts_t8.device)
    if radius2.shape != (n,) or labels.shape != (n,):
        raise ValueError(f"{name}: radius2 and labels must be ({n},)")
    if not pts_t8.is_cuda:
        return min_label_plain(pts_t8, radius2, labels, ndim, big)
    out = torch.full((n,), big, dtype=torch.int32, device=pts_t8.device)
    with torch.cuda.device(pts_t8.device):
        _launch(name, LIBRARY.load().dense_min_label, pts_t8.data_ptr(), n,
                radius2.data_ptr(), labels.data_ptr(), ndim, int(big),
                out.data_ptr(), stream_of(pts_t8.device))
    return out


def tile_min_label_qd(q_t8, d_t8, q_r2, d_r2, labels, ndim: int,
                      big: int = 2 ** 30):
    """Per query: the minimum label over DATA points within max(q_r2,
    d_r2), else ``big`` -> (Nq,) int32; query and data are different clouds
    (a query block and a data window of the sorted core cloud), ``labels``
    are the data's. Lanes that take no part carry sentinel coordinates,
    radius 0 and a label >= ``big``. Replaces
    ``pallas_kernels.tile_min_label_qd``, which returns the same values as
    f32 (labels carried as f32, exact below 2**24) and covers only query
    counts <= 512 or multiples of 512 and data counts in multiples of 2048;
    this wrapper takes any sizes."""
    name = "tile_min_label_qd"
    _check_clouds(name, q_t8, d_t8, ndim)
    _check(name, {"q_t8": q_t8, "d_t8": d_t8, "q_r2": q_r2, "d_r2": d_r2,
                  "labels": labels},
           (torch.float32,) * 4 + (torch.int32,), q_t8.device)
    n_q, n_d = q_t8.shape[1], d_t8.shape[1]
    if q_r2.shape != (n_q,) or d_r2.shape != (n_d,) or labels.shape != (n_d,):
        raise ValueError(f"{name}: q_r2 must be ({n_q},), d_r2 and labels "
                         f"({n_d},)")
    if not q_t8.is_cuda:
        return min_label_qd_plain(q_t8, d_t8, q_r2, d_r2, labels, ndim, big)
    out = torch.full((n_q,), big, dtype=torch.int32, device=q_t8.device)
    with torch.cuda.device(q_t8.device):
        _launch(name, LIBRARY.load().dense_min_label_qd, q_t8.data_ptr(), n_q,
                d_t8.data_ptr(), n_d, q_r2.data_ptr(), d_r2.data_ptr(),
                labels.data_ptr(), ndim, int(big), out.data_ptr(),
                stream_of(q_t8.device))
    return out


def tile_nearest(q_t8, d_t8, ndim: int = 3):
    """Per query: the nearest data point -> (dist2 (Nq,) f32, data index
    (Nq,) int32); the lowest index wins ties. Replaces
    ``pallas_kernels.tile_nearest``."""
    name = "tile_nearest"
    _check_clouds(name, q_t8, d_t8, ndim)
    _check(name, {"q_t8": q_t8, "d_t8": d_t8},
           (torch.float32, torch.float32), q_t8.device)
    if not q_t8.is_cuda:
        return nearest_plain(q_t8, d_t8, ndim)
    n_q = q_t8.shape[1]
    # 64-bit (bits(dist2) << 32 | index) keys, all ones = no candidate
    keys = torch.full((n_q,), -1, dtype=torch.int64, device=q_t8.device)
    dist = torch.empty(n_q, dtype=torch.float32, device=q_t8.device)
    idx = torch.empty(n_q, dtype=torch.int32, device=q_t8.device)
    with torch.cuda.device(q_t8.device):
        _launch(name, LIBRARY.load().dense_nearest, q_t8.data_ptr(), n_q,
                d_t8.data_ptr(), d_t8.shape[1], ndim, keys.data_ptr(),
                dist.data_ptr(), idx.data_ptr(), stream_of(q_t8.device))
    return dist, idx


PLAIN = {
    "tile_radius_count": count_plain,
    "tile_radius_count3": count3_plain,
    "tile_min_label": min_label_plain,
    "tile_nearest": nearest_plain,
    "tile_min_label_qd": min_label_qd_plain,
}
