"""Neighbour search: radius counts and nearest-neighbour label transfer.
The port of the banded branches of ``vilgod_tpu/ops/neighbors.py``.

The dense (non-banded) paths of the JAX package (``_radius_count_dense``
and the blockwise ``knn``) are small-input and overflow fallbacks the
pipeline's shapes do not reach (ng buckets are multiples of 8192, cluster
inputs multiples of 2048); they are not ported yet and raise.
"""
from __future__ import annotations

import numpy as np
import torch

from .banded import (CELL, GRID, band_width, banded_nearest,
                     banded_radius_count, block_windows, cell_ids,
                     cell_origin, full_width, page_origins, sort_by_cell)
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


def _dense_not_ported(what: str):
    return NotImplementedError(
        f"{what}: the dense (non-banded) path of vilgod_tpu is not ported "
        "(ROADMAP queue 2, kernels 6-9); the pipeline's bucketed shapes "
        "always take the banded path")


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
    starts, _, ovf = block_windows(cq, cd, tq, w_band)
    w_full = full_width(nd)
    if w_full != w_band and bool(ovf):
        starts, w_band = torch.zeros_like(starts), w_full
    c = banded_radius_count(q_t8, d_t8, starts, radius2_threshold(radius),
                            tq, w_band)
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
    raise _dense_not_ported("radius_count")


def radius_count_self(points, mask, radius: float,
                      max_count: int = 1000) -> torch.Tensor:
    """Self-neighbour counts, excluding the point itself."""
    c = radius_count(points, mask, points, mask, radius, max_count + 1)
    return torch.clamp(torch.clamp(c - 1, min=0), max=max_count)


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
    label -1 beyond ``dist_threshold``. Banded: any nearest neighbour
    outside the band is farther than sqrt(dist_threshold) < CELL."""
    nq, nd = query.shape[0], data.shape[0]
    if not _bandable(nq, nd, float(np.sqrt(dist_threshold))):
        raise _dense_not_ported("knn_labels")
    og = torch.minimum(cell_origin(query[:, :2], query_mask),
                       cell_origin(data[:, :2], data_mask))
    oq, cq = sort_by_cell(query[:, :3], query_mask, origin=og)
    od, cd = sort_by_cell(data[:, :3], data_mask, origin=og)
    q_t8 = prep_t8(query[oq, :3], query_mask[oq], 1)
    d_t8 = prep_t8(data[od, :3], data_mask[od], 1)
    tq = min(TQ, nq)
    w_band = band_width(nd, tile=TD)
    starts, _, ovf = block_windows(cq, cd, tq, w_band)
    w_full = full_width(nd)
    if w_full != w_band and bool(ovf):
        # the SAME kernel at full width. (The JAX package runs its dense
        # matmul-form knn here; the exact difference form can only differ
        # from it where that form's rounding reorders near-ties.)
        starts, w_band = torch.zeros_like(starts), w_full
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
