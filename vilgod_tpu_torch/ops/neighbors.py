"""Neighbour search: radius counts, nearest neighbours and label transfer;
the port of ``vilgod_tpu/ops/neighbors.py``.

Large tile-multiple clouds with a radius below the cell side take the
banded passes (``ops/banded.py``); the rest take the dense all-pairs
kernels of ``ops/dense_kernels.py`` (the JAX package's Pallas branches of
``_radius_count_dense`` and ``knn``), as does the label transfer when a
band overflows.
"""
from __future__ import annotations

import numpy as np
import torch

from .banded import (CELL, GRID, band_width, banded_nearest,
                     banded_radius_count, block_windows, cell_ids,
                     cell_origin, full_width, page_origins, sort_by_cell)
from . import dense_kernels
from .kernels import TD, TQ, prep_t8

# isolation spacing of the page column of the paged passes (shared with
# ops/cluster.py): pages sit PAGE_ISO apart in feature space, far beyond
# any radius, so no pass connects them
PAGE_ISO = 1.0e4


def radius2_threshold(radius) -> float:
    """The ONE squared-radius threshold every neighbour pass uses:
    computed in f64, nudged up by half a 5 mm-lattice step (2.5e-5 / 2)
    and rounded to f32 once, so pairs sitting exactly on the lattice value
    r**2 resolve the same way in every implementation."""
    return float(np.float32(np.float64(radius) ** 2 + 1.25e-5))


def _dist_threshold(dist_threshold: float) -> float:
    """The nudged f32 cutoff of the label transfer (squared distances)."""
    return float(np.float32(np.float64(dist_threshold) + 1.25e-5))


def _bandable(nq: int, nd: int, radius) -> bool:
    """The banded cell-sorted path applies (radius below the cell side,
    tile-multiple buffers)."""
    return (isinstance(radius, (int, float)) and float(radius) < CELL
            and nq >= 4096 and nd >= 4096
            and nq % 1024 == 0 and nd % 2048 == 0)


def _radius_count_banded(query, query_mask, data, data_mask, radius,
                         max_count):
    """Cell-sorted banded radius count; on window overflow the SAME pass
    runs at full width (identical arithmetic)."""
    nq, nd = query.shape[0], data.shape[0]
    # cross-cloud windows compare cell ids -> both grids share an origin
    og = torch.minimum(cell_origin(query[:, :2], query_mask),
                       cell_origin(data[:, :2], data_mask))
    oq, cq = sort_by_cell(query[:, :3], query_mask, origin=og)
    od, cd = sort_by_cell(data[:, :3], data_mask, origin=og)
    q_t8 = prep_t8(query[oq, :3], query_mask[oq], 1)
    d_t8 = prep_t8(data[od, :3], data_mask[od], 1)
    tq = min(TQ, nq)
    w_band = band_width(nd, tile=TD)
    starts, ends, ovf = block_windows(cq, cd, tq, w_band)
    w_full = full_width(nd)
    if w_full != w_band and bool(ovf):
        starts, ends, w_band = torch.zeros_like(starts), None, w_full
    c = banded_radius_count(q_t8, d_t8, starts, radius2_threshold(radius),
                            tq, w_band, ends=ends)
    out = torch.zeros(nq, dtype=torch.int32, device=query.device)
    out[oq] = c[:nq]
    return torch.clamp(torch.where(query_mask, out, 0), max=max_count)


def radius_count(query, query_mask, data, data_mask, radius: float,
                 max_count: int = 1000) -> torch.Tensor:
    """Count data points within ``radius`` of each query (int32 (Q,)),
    clipped at ``max_count``; invalid queries count 0."""
    if _bandable(query.shape[0], data.shape[0], radius):
        return _radius_count_banded(query, query_mask, data, data_mask,
                                    radius, max_count)
    return _radius_count_dense(query, query_mask, data, data_mask, radius,
                               max_count)


def _radius_count_dense(query, query_mask, data, data_mask, radius,
                        max_count):
    """All-pairs radius count (the JAX package's Pallas branch)."""
    q_t8 = prep_t8(query[:, :3], query_mask, TQ)
    d_t8 = prep_t8(data[:, :3], data_mask, TD)
    counts = dense_kernels.tile_radius_count(q_t8, d_t8,
                                             radius2_threshold(radius))
    counts = torch.where(query_mask, counts[:query.shape[0]], 0)
    return torch.clamp(counts, max=max_count)


def radius_count_self(points, mask, radius: float,
                      max_count: int = 1000) -> torch.Tensor:
    """Self-neighbour counts, excluding the point itself."""
    c = radius_count(points, mask, points, mask, radius, max_count + 1)
    return torch.clamp(torch.clamp(c - 1, min=0), max=max_count)


def knn(query, query_mask, data, data_mask, k: int = 1):
    """Nearest neighbour: (Q, 3) vs (D, 3) -> (squared dists (Q, 1) f32,
    indices (Q, 1) int32 into the caller's data order, clamped to D - 1).
    Invalid queries get +inf; invalid data points never win over a valid
    one (they sit at the far sentinel)."""
    if k != 1:
        raise NotImplementedError(
            "knn with k > 1 (the JAX package's blockwise top-k) is not "
            "ported: no stage calls it (ROADMAP queue 1)")
    nq, nd = query.shape[0], data.shape[0]
    q_t8 = prep_t8(query[:, :3], query_mask, TQ)
    d_t8 = prep_t8(data[:, :3], data_mask, TD)
    bd, bi = dense_kernels.tile_nearest(q_t8, d_t8)
    bd = torch.where(query_mask, bd[:nq], float("inf"))
    bi = torch.clamp(bi[:nq], max=nd - 1)
    return bd[:, None], bi[:, None]


def chamfer_distance(points_1, mask_1, points_2, mask_2,
                     threshold: float = 0.2):
    """Symmetric thresholded chamfer distance (squared distances below
    ``threshold`` averaged each way, then the mean of the two)."""
    d12, _ = knn(points_1, mask_1, points_2, mask_2)
    d21, _ = knn(points_2, mask_2, points_1, mask_1)

    def masked_mean(d, m):
        sel = m & (d[:, 0] < threshold)
        total = torch.where(sel, d[:, 0], torch.zeros_like(d[:, 0])).sum()
        return total / torch.clamp(sel.sum(), min=1)

    return (masked_mean(d12, mask_1) + masked_mean(d21, mask_2)) / 2.0


def _transfer(labels, probabilities, d2, idx0, query_mask, dist_threshold):
    point_labels = labels[idx0]
    point_labels = torch.where(d2 > _dist_threshold(dist_threshold), -1,
                               point_labels)
    point_labels = torch.where(query_mask, point_labels, -1)
    # probabilities only travel with a transferred label: beyond the cutoff
    # the "nearest" is whatever the banded pass happened to see
    point_probs = None
    if probabilities is not None:
        point_probs = torch.where(point_labels >= 0, probabilities[idx0],
                                  torch.zeros((), dtype=probabilities.dtype,
                                              device=probabilities.device))
    return point_labels, point_probs


def knn_labels(query, query_mask, data, data_mask, labels,
               probabilities=None, dist_threshold: float = 0.2):
    """Nearest-neighbour label transfer with a squared-distance cutoff:
    label -1 beyond ``dist_threshold``. Banded where the clouds allow it
    (any nearest neighbour outside the band is farther than
    sqrt(dist_threshold) < CELL); the dense :func:`knn` otherwise and when
    a band overflows."""
    nq, nd = query.shape[0], data.shape[0]

    def dense():
        dists, idx = knn(query, query_mask, data, data_mask)
        return _transfer(labels, probabilities, dists[:, 0], idx[:, 0].long(),
                         query_mask, dist_threshold)

    if not _bandable(nq, nd, float(np.sqrt(dist_threshold))):
        return dense()
    og = torch.minimum(cell_origin(query[:, :2], query_mask),
                       cell_origin(data[:, :2], data_mask))
    oq, cq = sort_by_cell(query[:, :3], query_mask, origin=og)
    od, cd = sort_by_cell(data[:, :3], data_mask, origin=og)
    q_t8 = prep_t8(query[oq, :3], query_mask[oq], 1)
    d_t8 = prep_t8(data[od, :3], data_mask[od], 1)
    tq = min(TQ, nq)
    w_band = band_width(nd, tile=TD)
    starts, _, ovf = block_windows(cq, cd, tq, w_band)
    if bool(ovf):
        # a window wider than the band: the dense knn over the original
        # orders, as the JAX package does (a band as wide as the data
        # never overflows)
        return dense()
    bd, bi = banded_nearest(q_t8, d_t8, starts, tq, w_band)
    bd, bi = bd[:nq], torch.clamp(bi[:nq], max=nd - 1)
    # query rank -> original query row, data rank -> original data row
    d2 = torch.zeros(nq, dtype=torch.float32, device=query.device)
    d2[oq] = bd
    idx0 = torch.zeros(nq, dtype=torch.int64, device=query.device)
    idx0[oq] = od[bi.long()]
    return _transfer(labels, probabilities, d2, idx0, query_mask,
                     dist_threshold)


def knn_labels_paged(query, query_mask, q_pages, data, data_mask, d_pages,
                     n_pages: int, labels, probabilities=None,
                     dist_threshold: float = 0.2, d_presorted=None,
                     origins=None):
    """:func:`knn_labels` over many independent page pairs in one pass:
    query page p takes labels only from data page p. Both clouds sort by a
    paged cell id (page * GRID**2 + cell) so windows never cross a page
    gap, and a 4th ``page * PAGE_ISO`` coordinate keeps pages out of reach
    even at full width.

    ``origins`` (n_pages, 2): the per-page grid origin shared by query and
    data; when ``d_presorted`` comes from ``paged_cell_sort`` it must be
    the origins that sort used."""
    nq, nd = query.shape[0], data.shape[0]
    assert nq % TQ == 0 and nd % TD == 0, (
        f"knn_labels_paged: flattened sizes (nq={nq}, nd={nd}) must be "
        f"multiples of (TQ={TQ}, TD={TD}); pad the page capacity")
    page_span = GRID * GRID
    # paged cell ids are int32: the invalid id n_pages * GRID**2 must fit
    # (the check paged_cell_sort makes, which the JAX version of this
    # function lacks)
    assert n_pages * page_span < 2 ** 31, (
        f"knn_labels_paged: {n_pages} pages x GRID^2 overflows int32 ids")
    if origins is None:
        assert d_presorted is None, (
            "knn_labels_paged: a presorted data cloud requires the origins "
            "its sort used (cell ids must share the grid)")
        origins = torch.minimum(
            page_origins(query[:, :2], query_mask, q_pages, n_pages),
            page_origins(data[:, :2], data_mask, d_pages, n_pages))
    invalid = n_pages * page_span
    q_pages = q_pages.to(torch.int32)
    cq = torch.where(query_mask,
                     q_pages * page_span + cell_ids(
                         query[:, :2], query_mask,
                         origin=origins[q_pages.long()]),
                     invalid)
    oq = torch.argsort(cq, stable=True)
    if d_presorted is None:
        d_pages = d_pages.to(torch.int32)
        cd = torch.where(data_mask,
                         d_pages * page_span + cell_ids(
                             data[:, :2], data_mask,
                             origin=origins[d_pages.long()]),
                         invalid)
        od = torch.argsort(cd, stable=True)
        cd_sorted = cd[od]
    else:
        od, cd_sorted = d_presorted
    q4 = torch.cat([query[:, :3],
                    (q_pages.to(query.dtype) * PAGE_ISO)[:, None]], 1)
    d4 = torch.cat([data[:, :3],
                    (d_pages.to(data.dtype) * PAGE_ISO)[:, None]], 1)
    q_t8 = prep_t8(q4[oq], query_mask[oq], 1)
    d_t8 = prep_t8(d4[od], data_mask[od], 1)
    tq = min(TQ, nq)
    # static band = capacity for one page's cell-row structure
    per_page = nd // n_pages
    w_band = max(8192, -(-int(per_page * 0.35) // TD) * TD)
    w_full = full_width(nd)
    w_band = min(w_band, w_full)
    cq_sorted = cq[oq]
    starts, _, ovf = block_windows(cq_sorted, cd_sorted, tq, w_band,
                                   invalid_cid=invalid)
    w2 = min(2 * w_band, w_full)
    if w_full != w_band and bool(ovf):
        if w2 == w_full:
            starts, w_band = torch.zeros_like(starts), w_full
        else:
            # middle tier at 2x band before the quadratic full pass: one
            # locally dense cell row must not make every page pay O(nq*nd)
            starts2, _, ovf2 = block_windows(cq_sorted, cd_sorted, tq, w2,
                                             invalid_cid=invalid)
            if bool(ovf2):
                starts, w_band = torch.zeros_like(starts), w_full
            else:
                starts, w_band = starts2, w2
    bd, bi = banded_nearest(q_t8, d_t8, starts, tq, w_band, ndim=4)
    bd, bi = bd[:nq], torch.clamp(bi[:nq], max=nd - 1)
    d2 = torch.full((nq,), float("inf"), dtype=torch.float32,
                    device=query.device)
    d2[oq] = bd
    idx0 = torch.zeros(nq, dtype=torch.int64, device=query.device)
    idx0[oq] = od[bi.long()].long()
    return _transfer(labels, probabilities, d2, idx0, query_mask,
                     dist_threshold)
