"""Neighbour search: radius counts, nearest neighbours and label transfer;
the port of ``vilgod_tpu/ops/neighbors.py``.

Large tile-multiple clouds with a radius below the cell side take the
banded passes (``ops/banded.py``, whose ``pass_window`` alone decides how
wide each runs); the rest take the dense all-pairs kernels of
``ops/dense_kernels.py`` (the JAX package's Pallas branches of
``_radius_count_dense`` and ``knn``), as does the label transfer when a
band overflows.
"""
from __future__ import annotations

import numpy as np
import torch

from .banded import (GRID, band_width, bandable, banded_nearest,
                     banded_radius_count, page_band_width, page_origins,
                     paged_cell_sort, pass_window, sort_pair)
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


def _radius_count_banded(query, query_mask, data, data_mask, radius,
                         max_count):
    """Cell-sorted banded radius count; on window overflow the SAME pass
    runs at full width (identical arithmetic)."""
    nq, nd = query.shape[0], data.shape[0]
    (q_t8, oq, cq), (d_t8, _, cd) = sort_pair(query, query_mask, data,
                                              data_mask)
    tq = min(TQ, nq)
    starts, w, ends = pass_window(cq, cd, tq, band_width(nd, tile=TD))
    c = banded_radius_count(q_t8, d_t8, starts, radius2_threshold(radius),
                            tq, w, ends=ends)
    out = torch.zeros(nq, dtype=torch.int32, device=query.device)
    out[oq] = c[:nq]
    return torch.clamp(torch.where(query_mask, out, 0), max=max_count)


def radius_count(query, query_mask, data, data_mask, radius: float,
                 max_count: int = 1000) -> torch.Tensor:
    """Count data points within ``radius`` of each query (int32 (Q,)),
    clipped at ``max_count``; invalid queries count 0."""
    if bandable(query.shape[0], data.shape[0], radius, 1024):
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


# data points per block of the k > 1 search (the JAX package's default)
KNN_BLOCK = 4096


def knn(query, query_mask, data, data_mask, k: int = 1):
    """Brute-force k nearest neighbours: (Q, 3) vs (D, 3) -> (squared
    dists (Q, k) f32 ascending, indices (Q, k) int32). Invalid queries get
    +inf; invalid data points sit at +inf and never win over a valid one.

    k = 1 is the dense nearest kernel (indices into the caller's data
    order, clamped to D - 1). k > 1 is a blockwise top-k in plain torch:
    per data block the squared distances in difference form (x, y, z
    each differenced and squared, summed in that order), packed with
    their index into one int64 key, so equal distances go to the lower
    index as ``jax.lax.top_k`` gives them; the block's k best merge with
    the running k best. An entry at +inf (past the valid data) takes
    index 0, as the JAX package's merge with its initial list gives it."""
    nq, nd = query.shape[0], data.shape[0]
    if k == 1:
        q_t8 = prep_t8(query[:, :3], query_mask, TQ)
        d_t8 = prep_t8(data[:, :3], data_mask, TD)
        bd, bi = dense_kernels.tile_nearest(q_t8, d_t8)
        bd = torch.where(query_mask, bd[:nq], float("inf"))
        bi = torch.clamp(bi[:nq], max=nd - 1)
        return bd[:, None], bi[:, None]
    dev = query.device
    # the running list starts at +inf (f32 bits 0x7F800000) with index 0
    best = torch.full((nq, k), 0x7F800000 << 32, dtype=torch.int64,
                      device=dev)
    for b0 in range(0, nd, KNN_BLOCK):
        d, m = data[b0:b0 + KNN_BLOCK], data_mask[b0:b0 + KNN_BLOCK]
        dist2 = None
        for c in range(3):
            diff = query[:, c:c + 1] - d[None, :, c]
            dist2 = diff * diff if dist2 is None else dist2 + diff * diff
        dist2 = torch.where(m[None, :], dist2, float("inf"))
        idx = torch.arange(b0, b0 + d.shape[0], dtype=torch.int64, device=dev)
        keys = (dist2.view(torch.int32).to(torch.int64) << 32) | idx
        kb = min(k, d.shape[0])
        blk = torch.topk(keys, kb, dim=1, largest=False, sorted=True).values
        best = torch.topk(torch.cat([best, blk], dim=1), k, dim=1,
                          largest=False, sorted=True).values
    dists = (best >> 32).to(torch.int32).view(torch.float32)
    idx = torch.where(torch.isinf(dists), 0,
                      (best & 0xFFFFFFFF).to(torch.int32))
    dists = torch.where(query_mask[:, None], dists, float("inf"))
    return dists, idx


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

    if not bandable(nq, nd, float(np.sqrt(dist_threshold)), 1024):
        return dense()
    (q_t8, oq, cq), (d_t8, od, cd) = sort_pair(query, query_mask, data,
                                               data_mask)
    tq = min(TQ, nq)
    starts, w, ends = pass_window(cq, cd, tq, band_width(nd, tile=TD))
    if ends is None:
        # a window wider than the band: the dense knn over the original
        # orders, as the JAX package does
        return dense()
    bd, bi = banded_nearest(q_t8, d_t8, starts, tq, w, ends=ends)
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
    if origins is None:
        assert d_presorted is None, (
            "knn_labels_paged: a presorted data cloud requires the origins "
            "its sort used (cell ids must share the grid)")
        origins = torch.minimum(
            page_origins(query[:, :2], query_mask, q_pages, n_pages),
            page_origins(data[:, :2], data_mask, d_pages, n_pages))
    oq, cq_sorted = paged_cell_sort(query, query_mask, q_pages, n_pages,
                                    origins=origins)
    od, cd_sorted = (paged_cell_sort(data, data_mask, d_pages, n_pages,
                                     origins=origins)
                     if d_presorted is None else d_presorted)
    q4 = torch.cat([query[:, :3],
                    (q_pages.to(query.dtype) * PAGE_ISO)[:, None]], 1)
    d4 = torch.cat([data[:, :3],
                    (d_pages.to(data.dtype) * PAGE_ISO)[:, None]], 1)
    q_t8 = prep_t8(q4[oq], query_mask[oq], 1)
    d_t8 = prep_t8(d4[od], data_mask[od], 1)
    tq = min(TQ, nq)
    starts, w, ends = pass_window(cq_sorted, cd_sorted, tq,
                                  page_band_width(nd, n_pages),
                                  invalid_cid=n_pages * GRID * GRID,
                                  middle=True)
    bd, bi = banded_nearest(q_t8, d_t8, starts, tq, w, ndim=4, ends=ends)
    bd, bi = bd[:nq], torch.clamp(bi[:nq], max=nd - 1)
    d2 = torch.full((nq,), float("inf"), dtype=torch.float32,
                    device=query.device)
    d2[oq] = bd
    idx0 = torch.zeros(nq, dtype=torch.int64, device=query.device)
    idx0[oq] = od[bi.long()].long()
    return _transfer(labels, probabilities, d2, idx0, query_mask,
                     dist_threshold)
