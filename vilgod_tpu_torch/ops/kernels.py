"""The banded neighbour kernels: CUDA wrappers, plain PyTorch versions and
launch counts. The port of ``vilgod_tpu/ops/pallas_kernels.py`` for the
four banded kernels the pipeline runs.

Layout (as in the JAX package): clouds are TRANSPOSED and padded to 8
rows, ``(8, N)`` float32 with x, y, z[, f3, f4, f5] in the leading rows
and zeros below; invalid points sit at a far ``SENTINEL`` coordinate so
no radius reaches them. Each query block of ``tq`` sorted points scans
the data window ``[start, start + w)`` (``start`` clamped into
``[0, n_d - w]``), or, where a pass is given ``ends``, only the block's
true candidate span ``[start, min(end, start + w))``. Squared distances
are in difference form, ``(q - d)**2`` summed over rows 0..ndim-1 in
order, each product and sum rounded on its own (no FMA), so kernel and
plain version agree bit for bit and sit on the same side of every
threshold.

Each wrapper takes its plain version only for CPU tensors. For CUDA
tensors it launches its kernel from ``csrc/banded.cu`` (built by
``utils/cuda_build.py`` at first use) or raises; it never
falls back. ``LAUNCHES`` counts kernel launches per wrapper.
"""
from __future__ import annotations

import ctypes

import torch

from ..utils.cuda_build import CudaLibrary, launch, stream_of

# Query tiles of the JAX package (they define the banded block structure,
# hence the window starts, so the port keeps them): light kernels (count,
# nearest) use TQ, the 3-level count and the min-label pass TQ_HEAVY. TD
# is the data tile the window widths round to.
TQ = 1024
TQ_HEAVY = 512
TD = 2048
SENTINEL = 1.0e6

# one CUDA thread block holds this many queries and stages this many data
# points per shared-memory chunk; tq and every window width are multiples
_CUDA_BLOCK = 256
# the kernels cut each block's span into runs of this many 256-rank
# chunks, one run per gridDim.y index
_RUN_CHUNKS = 2

KERNEL_NAMES = ("banded_tile_count", "banded_tile_count3",
                "banded_tile_min_label", "banded_tile_nearest")
LAUNCHES = {name: 0 for name in KERNEL_NAMES}


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def prep_t8(points: torch.Tensor, mask: torch.Tensor, tile: int) -> torch.Tensor:
    """(N, F<=8) + mask -> (8, N_pad) transposed, sentinel-masked, contiguous."""
    n, f = points.shape
    pts = torch.where(mask[:, None], points.to(torch.float32),
                      torch.tensor(SENTINEL, dtype=torch.float32,
                                   device=points.device))
    pad_n = -n % tile
    out = torch.zeros((8, n + pad_n), dtype=torch.float32, device=points.device)
    out[:f, :n] = pts.T
    out[:f, n:] = SENTINEL
    return out


# ---------------------------------------------------------------------------
# plain PyTorch versions (the JAX package's XLA fallback inners)
# ---------------------------------------------------------------------------

def _dist2_t8(q_t8, d_t8, ndim):
    """(q - d)**2 summed over rows 0..ndim-1 in order, each product and
    sum rounded on its own (in-place ops, the same arithmetic)."""
    acc = q_t8[0][:, None] - d_t8[0][None, :]
    acc.mul_(acc)
    for c in range(1, ndim):
        diff = q_t8[c][:, None] - d_t8[c][None, :]
        acc.add_(diff.mul_(diff))
    return acc


def _plain_chunk(device) -> int:
    """Column chunk of the plain versions' window walk. On the CPU a 512-wide
    (tq, chunk) distance tile stays in cache (twice as fast as 2048); on the
    card the walk is launch-bound, so wider chunks mean fewer launches. Per
    pair the arithmetic is the same, and the reductions (sum, min, first
    argmin) are order-free."""
    return 512 if device.type == "cpu" else 2048


def window_spans(starts, n_d: int, w: int, ends=None):
    """(block, s, e) of every query block's span [s, e) of the sorted data:
    s is ``starts[b]`` clamped into [0, n_d - w] (as
    ``jax.lax.dynamic_slice`` clamps a window), e = s + w, or
    min(ends[b], s + w) where ``ends`` is given (e == s: an empty span).
    The one block walk of the plain versions and ``banded.banded_scan``."""
    ends = [None] * starts.numel() if ends is None else ends.tolist()
    for b, (s, e) in enumerate(zip(starts.tolist(), ends)):
        s = min(max(s, 0), n_d - w)
        yield b, s, (s + w if e is None else max(s, min(e, s + w)))


def _tiles(q_t8, d_t8, starts, tq, w, ndim, ends=None):
    """(query slice, global rank of the tile's first column, dist2 tile)
    over every query block's span (:func:`window_spans`; an empty span
    yields no tile)."""
    chunk = _plain_chunk(q_t8.device)
    for b, s, e in window_spans(starts, d_t8.shape[1], w, ends):
        qs = slice(b * tq, (b + 1) * tq)
        for k in range(s, e, chunk):
            hi = min(k + chunk, e)
            yield qs, k, hi, _dist2_t8(q_t8[:, qs], d_t8[:, k:hi], ndim)


def count_plain(q_t8, d_t8, starts, r2, tq, w, ndim, ends=None):
    out = torch.zeros(q_t8.shape[1], dtype=torch.int32, device=q_t8.device)
    for qs, _, _, dist2 in _tiles(q_t8, d_t8, starts, tq, w, ndim, ends):
        out[qs] += (dist2 <= r2).sum(dim=1, dtype=torch.int32)
    return out


def count3_plain(q_t8, d_t8, starts, levels2, tq, w, ndim, ends=None):
    out = torch.zeros((q_t8.shape[1], 3), dtype=torch.int32,
                      device=q_t8.device)
    for qs, _, _, dist2 in _tiles(q_t8, d_t8, starts, tq, w, ndim, ends):
        for lv in range(3):
            out[qs, lv] += (dist2 <= levels2[lv]).sum(dim=1, dtype=torch.int32)
    return out


def min_label_plain(pts_t8, radius2, labels, starts, tq, w, ndim, big,
                    ends=None):
    out = torch.full((pts_t8.shape[1],), big, dtype=torch.int32,
                     device=pts_t8.device)
    big_t = torch.tensor(big, dtype=torch.int32, device=pts_t8.device)
    for qs, k, e, dist2 in _tiles(pts_t8, pts_t8, starts, tq, w, ndim,
                                  ends):
        # max-radius joint: HDBSCAN mutual-reachability linkage
        joint = torch.maximum(radius2[qs][:, None], radius2[k:e][None, :])
        cand = torch.where(dist2 <= joint, labels[k:e][None, :], big_t)
        out[qs] = torch.minimum(out[qs], cand.amin(dim=1))
    return out


def nearest_plain(q_t8, d_t8, starts, tq, w, ndim, ends=None):
    n_q = q_t8.shape[1]
    dist = torch.full((n_q,), float("inf"), dtype=torch.float32,
                      device=q_t8.device)
    idx = torch.zeros(n_q, dtype=torch.int32, device=q_t8.device)
    for qs, k, _, dist2 in _tiles(q_t8, d_t8, starts, tq, w, ndim, ends):
        # min over a dim returns the FIRST minimum, and a later tile only
        # wins when strictly nearer: the lowest rank wins ties (argmin)
        best, arg = dist2.min(dim=1)
        take = best < dist[qs]
        dist[qs] = torch.where(take, best, dist[qs])
        idx[qs] = torch.where(take, (arg + k).to(torch.int32), idx[qs])
    return dist, idx


# ---------------------------------------------------------------------------
# the CUDA library
# ---------------------------------------------------------------------------

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# -fmad=false: every product and sum rounds on its own, as the plain
# versions' separate ops do
LIBRARY = CudaLibrary("banded.cu", {
    # q, nq, d, nd, starts, ends, tq, w, ndim, r2, split, run, out, stream
    "banded_count": (_P, _I, _P, _I, _P, _P, _I, _I, _I, _F, _I, _I, _P,
                     _P),
    # q, nq, d, nd, starts, ends, tq, w, ndim, levels2, split, run, out,
    # stream
    "banded_count3": (_P, _I, _P, _I, _P, _P, _I, _I, _I, _P, _I, _I, _P,
                      _P),
    # pts, n, radius2, labels, starts, ends, tq, w, ndim, big, split, run,
    # out, stream
    "banded_min_label": (_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                         _P, _P),
    # q, nq, d, nd, starts, ends, tq, w, ndim, split, run, dist, idx, keys,
    # stream
    "banded_nearest": (_P, _I, _P, _I, _P, _P, _I, _I, _I, _I, _I, _P, _P,
                       _P, _P),
}, extra_flags=("-fmad=false",))


def _check(name, tensors, dtypes, device):
    for (arg, t), dt in zip(tensors.items(), dtypes):
        if t.device != device:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected {device}")
        if t.dtype != dt:
            raise TypeError(f"{name}: {arg} has dtype {t.dtype}, expected {dt}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def _check_window(name, q_t8, n_d, starts, tq, w, ndim, ends=None):
    n_q = q_t8.shape[1]
    if q_t8.dim() != 2 or q_t8.shape[0] != 8:
        raise ValueError(f"{name}: points must be (8, N), got {tuple(q_t8.shape)}")
    if ndim not in (3, 4, 5, 6):
        raise ValueError(f"{name}: ndim {ndim} not in (3, 4, 5, 6)")
    if tq <= 0 or n_q % tq or starts.shape != (n_q // tq,):
        raise ValueError(f"{name}: {n_q} queries, tq {tq} and "
                         f"{tuple(starts.shape)} window starts disagree")
    if not 0 < w <= n_d:
        raise ValueError(f"{name}: window {w} outside (0, {n_d}]")
    if q_t8.is_cuda and (tq % _CUDA_BLOCK or w % _CUDA_BLOCK):
        raise ValueError(f"{name}: the CUDA kernel needs tq ({tq}) and w "
                         f"({w}) in multiples of {_CUDA_BLOCK}")
    if ends is not None:
        _check(name, {"ends": ends}, (torch.int32,), q_t8.device)
        if ends.shape != starts.shape:
            raise ValueError(f"{name}: ends {tuple(ends.shape)} and starts "
                             f"{tuple(starts.shape)} disagree")


def _launch(name, fn, *args):
    launch(fn, *args)
    LAUNCHES[name] += 1


def _span_split(w: int) -> tuple[int, int]:
    """(gridDim.y, run) of the banded kernels: block (b, y) scans the y-th
    run of ``max(ceil(chunks / gridDim.y), run)`` 256-rank chunks of query
    block b's span, and the runs merge with atomics (order-free) into an
    output the launcher sets first. Runs of _RUN_CHUNKS chunks keep the
    few long spans of a skewed cloud from setting the grid's tail, and
    give a grid of few query blocks enough blocks to fill the card."""
    return -(-(w // _CUDA_BLOCK) // _RUN_CHUNKS), _RUN_CHUNKS


def _check_copy16(name, n_d, tensors):
    """The banded kernels stage data rows by 16-byte copies: 4 points
    each, from 16-byte aligned rows."""
    if n_d % 4:
        raise ValueError(f"{name}: the CUDA kernel needs n_d ({n_d}) in "
                         "multiples of 4")
    for arg, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be 16-byte aligned")


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def banded_tile_count(q_t8, d_t8, starts, r2: float, tq: int, w: int,
                      ndim: int = 3, ends=None) -> torch.Tensor:
    """Per query: data points of its block's window with squared distance
    <= ``r2`` -> (Nq,) int32. Replaces ``pallas_kernels.banded_tile_count``.

    ``ends`` (NB,) int32, where given, is each query block's true candidate
    span end (``block_windows``): block b then scans exactly the data ranks
    ``[s_b, min(ends[b], s_b + w))``, ``s_b`` the clamped start (the TPU
    kernel rounds the span out to whole 2048-point tiles). On every valid
    query lane the count is the whole window's: by the band guarantee a
    point past the span lies beyond one cell, and every radius in use is
    below it. On invalid lanes it may differ; every caller masks them.
    ``ends=None`` scans the whole window (the full-width overflow pass)."""
    name = "banded_tile_count"
    _check_window(name, q_t8, d_t8.shape[1], starts, tq, w, ndim, ends)
    _check(name, {"q_t8": q_t8, "d_t8": d_t8, "starts": starts},
           (torch.float32, torch.float32, torch.int32), q_t8.device)
    if not q_t8.is_cuda:
        return count_plain(q_t8, d_t8, starts, r2, tq, w, ndim, ends)
    _check_copy16(name, d_t8.shape[1], {"d_t8": d_t8})
    n_q = q_t8.shape[1]
    out = torch.empty(n_q, dtype=torch.int32, device=q_t8.device)
    with torch.cuda.device(q_t8.device):
        _launch(name, LIBRARY.load().banded_count, q_t8.data_ptr(), n_q,
                d_t8.data_ptr(), d_t8.shape[1], starts.data_ptr(),
                0 if ends is None else ends.data_ptr(), tq, w, ndim,
                float(r2), *_span_split(w), out.data_ptr(),
                stream_of(q_t8.device))
    return out


def banded_tile_count3(q_t8, d_t8, starts, levels2, tq: int, w: int,
                       ndim: int = 3, ends=None) -> torch.Tensor:
    """Counts at three squared radii ``levels2`` (3,) f32 -> (Nq, 3) int32.
    Replaces ``pallas_kernels.banded_tile_count3``. ``ends`` as in
    :func:`banded_tile_count`: equal to the whole window's counts on every
    valid query lane (every level is below the cell)."""
    name = "banded_tile_count3"
    _check_window(name, q_t8, d_t8.shape[1], starts, tq, w, ndim, ends)
    _check(name, {"q_t8": q_t8, "d_t8": d_t8, "starts": starts,
                  "levels2": levels2},
           (torch.float32, torch.float32, torch.int32, torch.float32),
           q_t8.device)
    if levels2.shape != (3,):
        raise ValueError(f"{name}: levels2 must be (3,), got {tuple(levels2.shape)}")
    if not q_t8.is_cuda:
        return count3_plain(q_t8, d_t8, starts, levels2, tq, w, ndim, ends)
    _check_copy16(name, d_t8.shape[1], {"d_t8": d_t8})
    n_q = q_t8.shape[1]
    out = torch.empty((n_q, 3), dtype=torch.int32, device=q_t8.device)
    with torch.cuda.device(q_t8.device):
        _launch(name, LIBRARY.load().banded_count3, q_t8.data_ptr(), n_q,
                d_t8.data_ptr(), d_t8.shape[1], starts.data_ptr(),
                0 if ends is None else ends.data_ptr(), tq, w, ndim,
                levels2.data_ptr(), *_span_split(w),
                out.data_ptr(), stream_of(q_t8.device))
    return out


def banded_tile_min_label(pts_t8, radius2, labels, starts, tq: int, w: int,
                          ndim: int, big: int, ends=None) -> torch.Tensor:
    """Per query: the minimum label over window points within
    max(radius2_q, radius2_d), else ``big`` -> (N,) int32. Replaces
    ``pallas_kernels.banded_tile_min_label``.

    ``ends`` as in :func:`banded_tile_count`: block b scans exactly
    ``[s_b, min(ends[b], s_b + w))``; equal to the whole window's label on
    every valid query lane (every radius is below the cell), possibly not
    on invalid lanes, which every caller masks."""
    name = "banded_tile_min_label"
    n = pts_t8.shape[1]
    _check_window(name, pts_t8, n, starts, tq, w, ndim, ends)
    _check(name, {"pts_t8": pts_t8, "radius2": radius2, "labels": labels,
                  "starts": starts},
           (torch.float32, torch.float32, torch.int32, torch.int32),
           pts_t8.device)
    if radius2.shape != (n,) or labels.shape != (n,):
        raise ValueError(f"{name}: radius2 and labels must be ({n},)")
    if not pts_t8.is_cuda:
        return min_label_plain(pts_t8, radius2, labels, starts, tq, w, ndim,
                               big, ends)
    _check_copy16(name, n, {"pts_t8": pts_t8, "radius2": radius2,
                            "labels": labels})
    out = torch.empty(n, dtype=torch.int32, device=pts_t8.device)
    with torch.cuda.device(pts_t8.device):
        _launch(name, LIBRARY.load().banded_min_label, pts_t8.data_ptr(), n,
                radius2.data_ptr(), labels.data_ptr(), starts.data_ptr(),
                0 if ends is None else ends.data_ptr(), tq, w, ndim,
                int(big), *_span_split(w), out.data_ptr(),
                stream_of(pts_t8.device))
    return out


def banded_tile_nearest(q_t8, d_t8, starts, tq: int, w: int, ndim: int = 3,
                        ends=None):
    """Per query: the nearest window point -> (dist2 (Nq,) f32, global data
    rank (Nq,) int32); the lowest rank wins ties; (inf, 0) where the
    window is empty. Replaces ``pallas_kernels.banded_tile_nearest``.

    ``ends`` as in :func:`banded_tile_count`: block b scans exactly
    ``[s_b, min(ends[b], s_b + w))``. On every valid query lane whose
    nearest window point lies within one cell the result is the whole
    window's (a point past the span lies beyond the cell); beyond the cell
    it may differ, as the JAX package's does, and every caller thresholds
    it at a radius below the cell."""
    name = "banded_tile_nearest"
    _check_window(name, q_t8, d_t8.shape[1], starts, tq, w, ndim, ends)
    _check(name, {"q_t8": q_t8, "d_t8": d_t8, "starts": starts},
           (torch.float32, torch.float32, torch.int32), q_t8.device)
    if not q_t8.is_cuda:
        return nearest_plain(q_t8, d_t8, starts, tq, w, ndim, ends)
    _check_copy16(name, d_t8.shape[1], {"d_t8": d_t8})
    n_q = q_t8.shape[1]
    split, run = _span_split(w)
    dist = torch.empty(n_q, dtype=torch.float32, device=q_t8.device)
    idx = torch.empty(n_q, dtype=torch.int32, device=q_t8.device)
    # the splits' 64-bit (bits(dist2) << 32 | rank) keys
    keys = (torch.empty(n_q, dtype=torch.int64, device=q_t8.device)
            if split > 1 else None)
    with torch.cuda.device(q_t8.device):
        _launch(name, LIBRARY.load().banded_nearest, q_t8.data_ptr(), n_q,
                d_t8.data_ptr(), d_t8.shape[1], starts.data_ptr(),
                0 if ends is None else ends.data_ptr(), tq, w, ndim, split,
                run, dist.data_ptr(), idx.data_ptr(),
                0 if keys is None else keys.data_ptr(),
                stream_of(q_t8.device))
    return dist, idx


PLAIN = {
    "banded_tile_count": count_plain,
    "banded_tile_count3": count3_plain,
    "banded_tile_min_label": min_label_plain,
    "banded_tile_nearest": nearest_plain,
}
