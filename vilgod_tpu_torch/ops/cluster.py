"""Density clustering over the banded passes; the port of the banded
branches of ``vilgod_tpu/ops/cluster.py``.

Radius-graph connected components with DBSCAN-style core/border
semantics and HDBSCAN's mutual-reachability linkage (see the JAX module):

1. three-level neighbour counts give each point a quantised core radius
   in [eps, eps_cap]; points holding ``min_samples`` within eps_cap are
   core;
2. core points compact to the front of the rank space and link when their
   distance fits the larger endpoint radius: min-label propagation with a
   Shiloach-Vishkin hook and one pointer jump per round, until no label
   changes (a host loop, one device sync per round);
3. border points take the label of their nearest core point within its
   radius; clusters below ``min_cluster_size`` become noise (-1).

Large tile-multiple inputs run banded kernels (``ops/kernels.py``) whose
window overflow re-runs that pass alone at full width; small or
non-tile-multiple inputs, and plain (non-adaptive) DBSCAN, run the dense
all-pairs kernels (``ops/dense_kernels.py``) of :func:`_dbscan_full`.
Also the per-cluster point table, cluster sizes and the compaction of
root labels to dense cluster ids.
"""
from __future__ import annotations

import numpy as np
import torch

from .banded import (_INVALID_CID, GRID, band_width, banded_min_label,
                     banded_nearest, banded_radius_count3, block_windows,
                     cell_ids, full_width, page_origins, sort_by_cell)
from . import dense_kernels
from .kernels import TD, TQ, TQ_HEAVY, prep_t8
from .neighbors import PAGE_ISO
from .segment import seg_count_by_label

_BIG_LABEL = 2 ** 30


def _propagate(labels, radius_min, core, n, propagation_rounds):
    """Connected components over the core-core radius graph: per round one
    banded min-label pass, a hook (scatter-min of each tree's neighbourhood
    minimum onto its root) and one pointer jump."""
    big = n

    def jump(labels):
        hop = torch.where(labels < big, labels, 0).long()
        return torch.where(labels < big, torch.minimum(labels, labels[hop]),
                           big)

    def hook(labels, nbr_min):
        root = torch.where(labels < big, labels, n).long()
        root_best = torch.full((n + 1,), big, dtype=torch.int32,
                               device=labels.device)
        root_best = root_best.scatter_reduce(0, root, nbr_min, "amin",
                                             include_self=True)
        return torch.minimum(nbr_min, root_best[torch.clamp(root, max=n - 1)])

    prev, labels = labels, jump(radius_min(labels))
    it = 0
    while it < propagation_rounds and bool((labels != prev).any()):
        nbr_min = radius_min(labels)
        new = jump(torch.where(core, hook(labels, nbr_min), big))
        prev, labels = labels, new
        it += 1
    return labels


def _dbscan_tail(labels, mask, core, radius, radius2, nearest_d2,
                 nearest_core, min_cluster_size):
    """Border attachment + cluster-size filter + probabilities."""
    n = labels.shape[0]
    big = n
    nearest_core = torch.clamp(nearest_core, max=n - 1).long()
    # a border point attaches when it sits inside its nearest core's radius
    has_core_nbr = nearest_d2 <= radius2[nearest_core]
    border = mask & ~core & has_core_nbr
    labels = torch.where(border, labels[nearest_core], labels)
    labels = torch.where(mask & ~core & ~has_core_nbr, big, labels)

    seg = torch.clamp(labels, max=big - 1).long()
    sizes = torch.zeros(n, dtype=torch.int32, device=labels.device)
    sizes.index_add_(0, seg, (labels < big).to(torch.int32))
    keep = (labels < big) & (sizes[seg] >= min_cluster_size)
    labels = torch.where(keep, labels, -1)

    one = torch.ones((), dtype=radius.dtype, device=radius.device)
    zero = torch.zeros((), dtype=radius.dtype, device=radius.device)
    probs = torch.where(core, one, torch.clamp(
        1.0 - torch.sqrt(nearest_d2) / radius[nearest_core], min=0.0))
    probs = torch.where(labels >= 0, probs, zero)
    return labels, probs


def _core_radii(counts3, mask, levels, eps_cap, min_samples):
    """Quantised core distances from the 3-level neighbour counts."""
    counts3 = torch.where(mask[:, None], torch.clamp(counts3 - 1, min=0), 0)
    enough = counts3 >= (min_samples - 1)  # counts exclude self
    first = torch.argmax(enough.to(torch.int32), dim=1)  # first True (or 0)
    radius = torch.where(enough.any(dim=1), levels[first], eps_cap)
    return radius, mask & enough[:, -1]


def _radius_count_full(points, mask, radius2):
    """Self neighbour counts within ``radius2`` over all feature columns,
    excluding self, in the difference form (the JAX package's branch is
    its XLA matmul form, with no Pallas kernel): kernel 6 for 3-6 columns,
    its plain version otherwise."""
    n, ndim = points.shape
    pts_t8 = prep_t8(points, mask, 1)
    if 3 <= ndim <= 6:
        counts = dense_kernels.tile_radius_count(pts_t8, pts_t8, radius2,
                                                 ndim)
    else:
        counts = dense_kernels.count_plain(pts_t8, pts_t8, radius2, ndim)
    return torch.where(mask, torch.clamp(counts - 1, min=0), 0)


def _dbscan_full(points, mask, levels, min_samples, min_cluster_size,
                 propagation_rounds, adaptive):
    """All-pairs DBSCAN (small inputs, sizes no tile divides, and plain
    DBSCAN): every distance pass scans the whole cloud, the min-label
    rounds over it core-first, the others in the original order.
    ``levels`` (3,) f32 as in :func:`_dbscan_banded`; plain DBSCAN uses
    ``levels[0]`` (eps) alone."""
    n, ndim = points.shape
    big = n
    pts_tq = prep_t8(points, mask, TQ)
    if adaptive:
        # the three counts include self; _core_radii removes it
        counts3 = dense_kernels.tile_radius_count3(
            pts_tq, prep_t8(points, mask, TD), levels * levels, ndim=ndim)[:n]
        radius, core = _core_radii(counts3, mask, levels, levels[2],
                                   min_samples)
    else:
        eps = levels[0]
        counts = _radius_count_full(points, mask, eps * eps)
        # counts exclude self; DBSCAN's min_samples includes the point
        core = mask & (counts >= min_samples - 1)
        radius = eps.expand(n).clone()
    radius2 = radius * radius

    # core compaction by sentinel coordinates: non-core points sit at the
    # far sentinel with radius 0 and label 2**30 on both sides of the
    # min-label pass. That pass takes the cloud core-first (a stable
    # permutation), so that few of kernel 8's query groups and data chunks
    # mix core points with sentinels and its box test skips the rest; each
    # point's minimum over a set does not depend on the set's order
    core_td = prep_t8(points, core, TD)
    perm = torch.argsort((~core).to(torch.uint8), stable=True)
    core_first = prep_t8(points[perm], core[perm], TD)
    n_td = core_td.shape[1]
    r2_first = torch.zeros(n_td, dtype=torch.float32, device=points.device)
    r2_first[:n] = torch.where(core, radius2, 0.0)[perm]
    arange = torch.arange(n, dtype=torch.int32, device=points.device)

    def radius_min(labels):
        lab_first = torch.full((n_td,), _BIG_LABEL, dtype=torch.int32,
                               device=points.device)
        lab_first[:n] = torch.where(core, labels, _BIG_LABEL)[perm]
        best = torch.empty_like(labels)
        best[perm] = dense_kernels.tile_min_label(core_first, r2_first,
                                                  lab_first, ndim,
                                                  _BIG_LABEL)[:n]
        best = torch.clamp(best, max=big)
        return torch.where(core, torch.minimum(labels, best), big)

    labels = _propagate(torch.where(core, arange, big), radius_min, core, n,
                        propagation_rounds)
    # border points: the nearest core point, an index in the original order
    nearest_d2, nearest_core = dense_kernels.tile_nearest(pts_tq, core_td,
                                                          ndim=ndim)
    return _dbscan_tail(labels, mask, core, radius, radius2,
                        nearest_d2[:n], nearest_core[:n], min_cluster_size)


def _dbscan_banded(points, mask, cid_sorted, levels, min_samples,
                   min_cluster_size, propagation_rounds, w_band=None,
                   invalid_cid=_INVALID_CID):
    """Banded DBSCAN over a CELL-SORTED cloud. ``levels`` (3,) f32 are the
    core-radius levels [eps, eps*sqrt(f), eps*f]. Overflow is handled per
    pass: a pass whose windows overflow re-runs at full width."""
    n, ndim = points.shape
    w_full = full_width(n)
    w_band = min(band_width(n, tile=TD) if w_band is None else w_band,
                 w_full)
    tq_l, tq_h = min(TQ, n), min(TQ_HEAVY, n)

    def window(cid_q, cid_d, tq):
        """(starts, width, ends) of one pass: banded with each block's span
        end, or full width (ends None) on overflow."""
        starts, ends, ovf = block_windows(cid_q, cid_d, tq, w_band,
                                          invalid_cid=invalid_cid)
        if w_band == w_full or bool(ovf):
            return torch.zeros_like(starts), w_full, None
        return starts, w_band, ends

    pts_t8 = prep_t8(points, mask, 1)
    s_h, w_h, e_h = window(cid_sorted, cid_sorted, tq_h)
    counts3 = banded_radius_count3(pts_t8, pts_t8, s_h, levels * levels,
                                   tq_h, w_h, ndim=ndim, ends=e_h)[:n]
    radius, core = _core_radii(counts3, mask, levels, levels[2], min_samples)
    radius2 = radius * radius
    big = n

    # core compaction: only core points take part in the propagation
    # passes and as the nearest pass's data side; the compaction keeps
    # the cell order (and page isolation)
    arange = torch.arange(n, dtype=torch.int32, device=points.device)
    core_pos = torch.cumsum(core.to(torch.int32), 0, dtype=torch.int32) - 1
    core_src = torch.full((n + 1,), n, dtype=torch.int32, device=points.device)
    core_src[torch.where(core, core_pos, n).long()] = arange
    core_src = core_src[:n]
    valid_c = core_src < n
    src_cl = torch.clamp(core_src, max=n - 1).long()
    pts_c = points[src_cl]
    cid_c = torch.where(valid_c, cid_sorted[src_cl], invalid_cid)
    r2_c = torch.where(valid_c, radius2[src_cl], 0.0).to(torch.float32)
    core_t8 = prep_t8(pts_c, valid_c, 1)
    s_p, w_p, e_p = window(cid_c, cid_c, tq_h)

    # propagation runs in compacted space with compacted label values:
    # the compaction is order-preserving, so the minima are the same
    labels_c0 = torch.where(valid_c, arange, big)

    def radius_min(labels_c):
        lab = torch.where(valid_c, labels_c, _BIG_LABEL).to(torch.int32)
        best = banded_min_label(core_t8, r2_c, lab, s_p, tq_h, w_p, ndim,
                                _BIG_LABEL, ends=e_p)[:n]
        best = torch.clamp(best, max=big)
        return torch.where(valid_c, torch.minimum(labels_c, best), big)

    labels_c = _propagate(labels_c0, radius_min, valid_c, n,
                          propagation_rounds)
    # compacted label values -> original sorted ranks, expanded to the full
    # rank space (non-core points stay `big` until the border attach)
    lab_val = core_src[torch.clamp(labels_c, max=n - 1).long()]
    labels = torch.full((n + 1,), n, dtype=torch.int32, device=points.device)
    labels[torch.where(valid_c, src_cl, n)] = torch.where(valid_c, lab_val,
                                                          big)
    labels = labels[:n]

    # nearest-within-band is exact for border attachment: anything outside
    # the band is farther than eps_cap < CELL. The query blocks and the
    # compacted data both have to fit the band.
    s_l, _, ovf_l = block_windows(cid_sorted, cid_sorted, tq_l, w_band,
                                  invalid_cid=invalid_cid)
    s_n, w_n, e_n = window(cid_sorted, cid_c, tq_l)
    if w_n != w_full and bool(ovf_l):
        s_n, w_n, e_n = torch.zeros_like(s_n), w_full, None
    nearest_d2, nc = banded_nearest(pts_t8, core_t8, s_n, tq_l, w_n,
                                    ndim=ndim, ends=e_n)
    nearest_d2 = nearest_d2[:n]
    nearest_core = core_src[torch.clamp(nc[:n], max=n - 1).long()]

    return _dbscan_tail(labels, mask, core, radius, radius2, nearest_d2,
                        nearest_core, min_cluster_size)


def dbscan_labels(points, mask, eps: float = 0.15, min_samples: int = 15,
                  min_cluster_size: int = 15, propagation_rounds: int = 64,
                  adaptive: bool = True, eps_cap_factor: float = 2.0):
    """Cluster ``points`` (N, F) -> (labels (N,) int32, probabilities (N,)).

    Distances use all F feature columns (the pipeline clusters 5-D [xyz,
    entropy, 0.1*frame] features). Labels are roots with -1 noise
    (compact them per frame): sorted ranks on the banded path, original
    indices on the dense one."""
    n = points.shape[0]
    # the JAX function traces eps and eps_cap_factor, so its levels come
    # from f32 arithmetic
    e = torch.tensor(eps, dtype=torch.float32)
    f = torch.tensor(eps_cap_factor, dtype=torch.float32)
    levels = torch.stack([e, e * f ** 0.5, e * f]).to(points.device)
    if not adaptive or n < 4096 or n % 2048 != 0:
        return _dbscan_full(points, mask, levels, min_samples,
                            min_cluster_size, propagation_rounds, adaptive)
    order, cid_sorted = sort_by_cell(points, mask)
    labels_s, probs_s = _dbscan_banded(points[order], mask[order], cid_sorted,
                                       levels, min_samples, min_cluster_size,
                                       propagation_rounds)
    labels = torch.full((n,), -1, dtype=torch.int32, device=points.device)
    labels[order] = labels_s
    probs = torch.zeros(n, dtype=points.dtype, device=points.device)
    probs[order] = probs_s
    return labels, probs


def paged_cell_sort(points, mask, pages, n_pages: int, origins=None):
    """The paged cell-id sort shared by :func:`dbscan_labels_paged` and the
    data side of ``knn_labels_paged``: (order, cid_sorted).

    ``origins`` (n_pages, 2): per-page grid origin (default: each page's
    own corner)."""
    page_span = GRID * GRID
    assert n_pages * page_span < 2 ** 31, (
        f"paged_cell_sort: {n_pages} pages x GRID^2 overflows int32 ids")
    if origins is None:
        origins = page_origins(points[:, :2], mask, pages, n_pages)
    pages = pages.to(torch.int32)
    cell = cell_ids(points[:, :2], mask, origin=origins[pages.long()])
    cid = torch.where(mask, pages * page_span + cell, n_pages * page_span)
    order = torch.argsort(cid, stable=True)
    return order, cid[order]


def dbscan_labels_paged(points, mask, pages, n_pages: int, eps: float = 0.15,
                        min_samples: int = 15, min_cluster_size: int = 15,
                        propagation_rounds: int = 64,
                        eps_cap_factor: float = 2.0, presorted=None,
                        origins=None):
    """Cluster many independent point sets ("pages", one per frame window)
    in one pass: clusters never cross pages. Pages sort by a paged cell id
    (page * GRID**2 + cell) and carry a ``page * PAGE_ISO`` feature column,
    so neither a window nor a full-width re-run reaches across pages.
    Returns labels in sorted-rank value space."""
    n = points.shape[0]
    assert n % max(TD, TQ, TQ_HEAVY) == 0, (
        f"dbscan_labels_paged: flattened size {n} must be a multiple of "
        f"{max(TD, TQ, TQ_HEAVY)} (pages x 2048-multiple page capacity)")
    iso = (pages.to(points.dtype) * PAGE_ISO)[:, None]
    pts_iso = torch.cat([points, iso], dim=1)
    if presorted is None:
        presorted = paged_cell_sort(points, mask, pages, n_pages,
                                    origins=origins)
    order, cid_sorted = presorted
    # static arguments in the JAX function: levels from f64 arithmetic
    levels = torch.tensor(np.array(
        [eps, eps * (eps_cap_factor ** 0.5), eps * eps_cap_factor],
        np.float32), device=points.device)
    # band sized for a page's cell-row structure, not the page length
    per_page = n // n_pages
    w_band = max(8192, -(-int(per_page * 0.35) // TD) * TD)
    labels_s, probs_s = _dbscan_banded(
        pts_iso[order], mask[order], cid_sorted, levels, min_samples,
        min_cluster_size, propagation_rounds, w_band=w_band,
        invalid_cid=n_pages * GRID * GRID)
    labels = torch.full((n,), -1, dtype=torch.int32, device=points.device)
    labels[order] = labels_s
    probs = torch.zeros(n, dtype=points.dtype, device=points.device)
    probs[order] = probs_s
    return labels, probs


def build_cluster_table(labels, mask, num_clusters: int, capacity: int):
    """Per-cluster point indices in a padded table: labels (N,) compact in
    [0, num_clusters) or -1 -> (table (C, P) int32 indices into the cloud,
    -1 past each cluster's points; table_mask (C, P)). A cluster keeps its
    first ``capacity`` points in index order."""
    n = labels.shape[0]
    dev = labels.device
    valid = mask & (labels >= 0) & (labels < num_clusters)
    sort_key = torch.where(valid, labels, num_clusters)
    # stable: ascending point order within each cluster
    order = torch.argsort(sort_key, stable=True)
    sorted_labels = sort_key[order].contiguous()
    starts = torch.searchsorted(
        sorted_labels, torch.arange(num_clusters, dtype=sorted_labels.dtype,
                                    device=dev))
    pos = (torch.arange(n, device=dev)
           - starts[torch.clamp(sorted_labels, max=num_clusters - 1).long()])
    in_table = (sorted_labels < num_clusters) & (pos < capacity)
    flat = torch.where(in_table, sorted_labels * capacity + pos,
                       num_clusters * capacity).long()
    table = torch.full((num_clusters * capacity + 1,), -1, dtype=torch.int32,
                       device=dev)
    table[flat] = torch.where(in_table, order.to(torch.int32), -1)
    table = table[:num_clusters * capacity].reshape(num_clusters, capacity)
    return table, table >= 0


def cluster_sizes(labels, mask, num_clusters: int) -> torch.Tensor:
    """Points per cluster, int32 (num_clusters,): labels -1, masked points
    and labels at or past ``num_clusters`` count nowhere (JAX's
    segment_sum drops out-of-range segments)."""
    return seg_count_by_label(labels, mask & (labels < num_clusters),
                              num_clusters)


def compact_labels(labels, max_clusters: int) -> torch.Tensor:
    """Map labels in [0, N) to dense ids in ascending label order (the
    reference's np.sort(unique) order); -1 stays -1, ids past
    ``max_clusters`` become -1. int32 (N,)."""
    n = labels.shape[0]
    dev = labels.device
    present = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    present[torch.where(labels >= 0, labels, n).long()] = 1
    new_ids = torch.cumsum(present[:n], 0, dtype=torch.int32) - 1
    compact = torch.where(labels >= 0,
                          new_ids[torch.clamp(labels, 0, n - 1).long()], -1)
    return torch.where(compact >= max_clusters, -1, compact).to(torch.int32)


def compact_labels_any(labels, max_clusters: int) -> torch.Tensor:
    """Like :func:`compact_labels` for any non-negative label values (the
    paged clustering's global sorted-rank roots exceed the page length):
    distinct values ranked ascending. int32 (N,)."""
    n = labels.shape[0]
    big = torch.tensor(_BIG_LABEL, dtype=labels.dtype, device=labels.device)
    sorted_lab = torch.sort(torch.where(labels >= 0, labels, big)).values
    is_first = torch.cat([
        sorted_lab[:1] < big,
        (sorted_lab[1:] != sorted_lab[:-1]) & (sorted_lab[1:] < big)])
    ranks = torch.cumsum(is_first.to(torch.int32), 0, dtype=torch.int32) - 1
    pos = torch.searchsorted(sorted_lab, torch.clamp(labels, min=0))
    compact = torch.where(labels >= 0,
                          ranks[torch.clamp(pos, max=n - 1)], -1)
    return torch.where(compact >= max_clusters, -1, compact).to(torch.int32)
