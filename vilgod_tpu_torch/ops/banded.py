"""Banded (cell-sorted) drivers for the pairwise-distance passes; the port
of ``vilgod_tpu/ops/banded.py``.

Points are sorted once by a coarse row-major 2-D cell id; all neighbours
of a query within ``r < CELL`` then lie within +-1 cell, which is a
contiguous window of the sorted rank space. Each query block of ``tq``
sorted points scans only its ``[start, start + w)`` window of the sorted
data. When some block's true span exceeds the static band ``w``, the
caller re-runs the SAME pass at full width (``starts = 0``,
``w = w_full``): identical arithmetic, exhaustive window.

The four banded ops below hand the window math to the CUDA kernels of
:mod:`.kernels` (plain PyTorch versions on CPU tensors). Without ``ends``
they scan exactly ``[start, start + w)`` with ``start`` clamped into
``[0, n_d - w]`` as ``jax.lax.dynamic_slice`` does in the JAX package's
XLA fallback, so the results equal that fallback everywhere, padded and
invalid rows included. With ``ends``, each block's true span end from
:func:`block_windows` (the JAX package's Pallas kernels take the same),
they scan only ``[start, min(end, start + w))``, which gives the same
results on every valid query row (the nearest: wherever it lies within a
cell; see :func:`.kernels.banded_tile_count` and
:func:`.kernels.banded_tile_nearest`).
"""
from __future__ import annotations

import torch

from . import kernels

# Cell side (m): every pipeline radius (entropy 0.3, eps_cap 0.3, label
# transfer sqrt(0.2)) is below it, which the band guarantee needs.
CELL = 0.5
# Cells per axis, relative to a per-cloud origin: 2048 * 0.5 m = 1024 m of
# extent. Points beyond clamp into border cells (still correct, the bands
# only widen).
GRID = 2048
_INVALID_CID = GRID * GRID


def cell_origin(xy: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Lattice-snapped lower corner of a cloud: the default ``origin`` for
    :func:`cell_ids`."""
    big = torch.tensor(1e9, dtype=xy.dtype, device=xy.device)
    mn = torch.where(mask[:, None], xy[:, :2], big).amin(dim=0)
    mn = torch.where(mn >= big, torch.zeros_like(mn), mn)  # empty cloud
    return (torch.floor(mn / CELL) - 1.0) * CELL


def page_origins(xy: torch.Tensor, mask: torch.Tensor, pages: torch.Tensor,
                 n_pages: int) -> torch.Tensor:
    """Per-page :func:`cell_origin` (n_pages, 2) for paged clouds."""
    big = torch.tensor(1e9, dtype=xy.dtype, device=xy.device)
    seg = torch.where(mask, pages.long(), n_pages)
    vals = torch.where(mask[:, None], xy[:, :2], big)
    mins = torch.full((n_pages + 1, 2), 1e9, dtype=xy.dtype, device=xy.device)
    mins = mins.scatter_reduce(0, seg[:, None].expand(-1, 2), vals, "amin",
                               include_self=True)[:n_pages]
    mins = torch.where(mins >= big, torch.zeros_like(mins), mins)
    return (torch.floor(mins / CELL) - 1.0) * CELL


def cell_ids(xy: torch.Tensor, mask: torch.Tensor,
             origin: torch.Tensor | None = None) -> torch.Tensor:
    """Row-major 2-D cell id per point (int32); invalid points sort last.

    ``origin`` ((2,) or per-point (N, 2)) anchors the grid; clouds whose
    ids are compared against each other must share it."""
    if origin is None:
        origin = cell_origin(xy, mask)
    rel = xy[:, :2] - origin
    cx = torch.clamp(torch.floor(rel[:, 0] / CELL).to(torch.int32), 0, GRID - 1)
    cy = torch.clamp(torch.floor(rel[:, 1] / CELL).to(torch.int32), 0, GRID - 1)
    return torch.where(mask, cx * GRID + cy,
                       torch.tensor(_INVALID_CID, dtype=torch.int32,
                                    device=xy.device))


def sort_by_cell(points: torch.Tensor, mask: torch.Tensor,
                 origin: torch.Tensor | None = None):
    """Stable sort of a cloud by cell id. Returns (order, cid_sorted)."""
    cid = cell_ids(points[:, :2], mask, origin=origin)
    order = torch.argsort(cid, stable=True)
    return order, cid[order]


def block_windows(cid_q_sorted: torch.Tensor, cid_d_sorted: torch.Tensor,
                  tq: int, w_band: int, invalid_cid: int = _INVALID_CID):
    """Per query block of ``tq`` sorted points: the start of a
    ``w_band``-wide window of sorted data ranks that holds every data
    point within +-1 cell of any valid query of the block.

    Returns (starts (NB,) int32, ends (NB,) int32, overflow 0-dim bool).
    ``[starts[b], ends[b])`` is block b's true span; ``overflow`` is True
    when some span exceeds ``w_band`` and the caller must re-run the pass
    at full width."""
    n_q = cid_q_sorted.shape[0]
    nb = n_q // tq
    blocks = cid_q_sorted.reshape(nb, tq)
    valid = blocks < invalid_cid
    lo_cid = torch.where(valid, blocks, invalid_cid).amin(dim=1) - GRID - 1
    hi_cid = torch.where(valid, blocks, -1).amax(dim=1) + GRID + 1
    lo = torch.searchsorted(cid_d_sorted, lo_cid.to(cid_d_sorted.dtype))
    hi = torch.searchsorted(cid_d_sorted, hi_cid.to(cid_d_sorted.dtype),
                            right=True)
    lo, hi = lo.to(torch.int32), hi.to(torch.int32)
    any_valid = valid.any(dim=1)
    width = torch.where(any_valid, hi - lo, 0)
    n_d = cid_d_sorted.shape[0]
    starts = torch.clamp(lo, 0, max(n_d - w_band, 0))
    ends = torch.where(any_valid, hi, starts)
    overflow = (width > w_band).any()
    return starts, ends, overflow


def band_width(n_data: int, tile: int = 2048, frac: int = 8,
               floor: int = 4096) -> int:
    """Static band width: n/frac rounded to a tile multiple (>= floor)."""
    w = max(floor, n_data // frac)
    w = -(-w // tile) * tile
    return min(w, -(-n_data // tile) * tile)


def full_width(n_data: int) -> int:
    """The full-pass window: every data rank, in whole TD tiles."""
    return -(-n_data // kernels.TD) * kernels.TD


def banded_scan(q_t8, d_t8, starts, tq: int, w_band: int, inner):
    """Scan query blocks against their data windows.

    q_t8/d_t8: (8, N) transposed sentinel-masked clouds (``prep_t8``
    layout); ``inner(q_block (8, tq), d_window (8, w_band), start)`` ->
    pytree of (tq, ...) tensors, ``start`` the window's first data rank
    (``starts[b]`` clamped into [0, n_d - w_band], where the window
    lies). Returns the pytree with leading axis N, in sorted query order.
    The blocks are walked as the plain versions walk them
    (:func:`.kernels.window_spans`), one ``inner`` call a block."""
    from torch.utils import _pytree

    outs = [inner(q_t8[:, b * tq:(b + 1) * tq], d_t8[:, s:e], s)
            for b, s, e in kernels.window_spans(starts, d_t8.shape[1],
                                                w_band)]
    leaves, spec = zip(*map(_pytree.tree_flatten, outs))
    return _pytree.tree_unflatten(
        [torch.cat(parts) for parts in zip(*leaves)], spec[0])


# ---------------------------------------------------------------------------
# banded ops over PRE-SORTED clouds (results follow the sorted query order)
# ---------------------------------------------------------------------------

def banded_radius_count(q_t8, d_t8, starts, r2: float, tq: int, w_band: int,
                        ndim: int = 3, ends=None) -> torch.Tensor:
    return kernels.banded_tile_count(q_t8, d_t8, starts, r2, tq, w_band, ndim,
                                     ends)


def banded_radius_count3(q_t8, d_t8, starts, levels2: torch.Tensor, tq: int,
                         w_band: int, ndim: int = 3,
                         ends=None) -> torch.Tensor:
    return kernels.banded_tile_count3(q_t8, d_t8, starts, levels2, tq,
                                      w_band, ndim, ends)


def banded_min_label(pts_t8, radius2_row, labels_row, starts, tq: int,
                     w_band: int, ndim: int, big: int,
                     ends=None) -> torch.Tensor:
    """One min-label propagation pass over the sorted core cloud.
    radius2_row (N,) f32 and labels_row (N,) int32 align with pts_t8."""
    # the JAX package carries labels as f32 lanes, exact only below 2**24;
    # the port carries int32 but keeps the same limit so both packages
    # accept the same inputs
    assert pts_t8.shape[1] < 2 ** 24, (
        f"banded_min_label: {pts_t8.shape[1]} points exceeds the float32 "
        "label-lane exactness limit (2**24); split into more pages")
    return kernels.banded_tile_min_label(pts_t8, radius2_row, labels_row,
                                         starts, tq, w_band, ndim, big, ends)


def banded_nearest(q_t8, d_t8, starts, tq: int, w_band: int, ndim: int = 3,
                   ends=None):
    """Nearest data point per query within the band -> (dist2, global
    data rank). Exact for every consumer that thresholds the result at a
    radius < CELL."""
    assert d_t8.shape[1] < 2 ** 24, (
        f"banded_nearest: {d_t8.shape[1]} data points exceeds the float32 "
        "index-lane exactness limit (2**24); split into more pages")
    return kernels.banded_tile_nearest(q_t8, d_t8, starts, tq, w_band, ndim,
                                       ends)
