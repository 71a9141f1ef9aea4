"""Geometry stages 1-4 (ground masking, entropy, clustering, filter); the
port of ``vilgod_tpu/pipeline/stages_geometry.py``.

Each stage is ``stage(state, cfg, **args)`` over the device-resident
buffers of a :class:`SequenceState`; derived per-point buffers are born on
the state's device and only the per-detection tables reach the host.
Where the state's device has local peers (``parallel.local_devices``) each
stage shards its frames over them under the JAX package's gate and
``cfg.parallel`` switches, and gathers the result back to the state's
device.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import parallel
from ..ground.patchwork import (ground_config_from_cfg, segment_sequence,
                               segment_sequence_chained)
from ..ops import random as jrandom
from ..ops import segment as seg_ops
from ..ops.banded import CELL
from ..ops.cluster import dbscan_labels, dbscan_labels_paged, paged_cell_sort
from ..ops.entropy import entropy_sequence
from ..ops.neighbors import (knn_labels, knn_labels_paged,
                             radius_count_self_paged)
from ..ops.plane import _dot3, fit_ground_plane
from ..ops.select_kernels import page_keys, select_keep, window_frames
from ..ops.transforms import apply_transform
from ..utils import trace
from .state import SequenceState


# pages (frame windows) of a clustering chunk at most, and frames of a
# group of the selection statistics' paged counts
CHUNK_PAGES = 32


def frame_bucket(n_frames: int, bucket: int = 8) -> int:
    """Round the frame count up to a multiple of 8 (>= 8), the JAX
    package's whole-sequence shape bucket (it fixes the padded frame count
    and so the clustering chunk)."""
    return max(-(-n_frames // bucket) * bucket, bucket)


def _transforms_to_ref(state: SequenceState, f_pad: int) -> torch.Tensor:
    t = np.stack([state.transform_to_ref(f) for f in range(state.n_frames)])
    if f_pad > state.n_frames:
        t = np.concatenate([t, np.tile(np.eye(4, dtype=t.dtype),
                                       (f_pad - state.n_frames, 1, 1))])
    return torch.from_numpy(t.astype(np.float32)).to(state.torch_device)


# ---------------------------------------------------------------------------
# Stage 1: mask_ground_points
# ---------------------------------------------------------------------------

def _compact_sequence(points, mask, ground, transforms, cap_ng: int):
    """Compact every frame's non-ground points into the front of a fixed
    buffer, in world ("ref") coordinates. Returns (ng_xyz (F, N, 3),
    ng_mask (F, N), ng_src (F, N), counts (F,))."""
    f, p = mask.shape
    dev = mask.device
    keep = mask & ~ground
    cnt = torch.clamp(keep.sum(dim=1, dtype=torch.int32), max=cap_ng)
    pos = torch.where(keep, torch.cumsum(keep.to(torch.int32), 1,
                                         dtype=torch.int32) - 1, cap_ng)
    pos = torch.clamp(pos, max=cap_ng).long()
    idx = torch.arange(p, dtype=torch.int32, device=dev).expand(f, p)
    src = torch.full((f, cap_ng + 1), -1, dtype=torch.int32, device=dev)
    src.scatter_(1, pos, torch.where(keep, idx, -1))
    src = src[:, :cap_ng]
    valid = src >= 0
    pts_ref = apply_transform(points[..., :3], transforms)
    gathered = torch.gather(pts_ref, 1, torch.clamp(src, min=0).long()
                            [..., None].expand(f, cap_ng, 3))
    ng_xyz = torch.where(valid[..., None], gathered, 0.0)
    return ng_xyz, valid, src, cnt


def stage_mesh(state: SequenceState) -> parallel.Mesh:
    """The mesh a stage of ``state`` may shard over: every local device
    of the state's, the state's first (one shard on the CPU)."""
    return parallel.make_mesh(
        devices=parallel.local_devices(state.torch_device))


def ground_chains(cfg, f_pad: int) -> int:
    """The chains of the ground scan: ``parallel.ground_chains`` where it
    divides the padded frames into chunks of at least 8 (the adaptive
    thresholds settle from frame 2), else 1; the JAX package's gate."""
    chains = int(cfg.get("parallel", {}).get("ground_chains", 1))
    if chains > 1 and f_pad % chains == 0 and f_pad // chains >= 8:
        return chains
    return 1


def mask_ground_points(state: SequenceState, cfg, min_range: float = 1.5,
                       z_offset: float = 1.723, **_):
    """Patchwork++-style ground segmentation scanned over the frames, then
    the non-ground compaction. Only the (F,) occupancy counts reach the
    host (they pick the shape bucket of the later stages). With D > 1
    local devices, ``F_pad / D >= 8`` frames a shard (the adaptive
    thresholds settle from frame 2) and ``parallel.shard_frames`` and
    ``shard_ground`` on, each device scans its own frame chunk
    (``parallel.sharded_ground``). Otherwise, with
    ``parallel.ground_chains`` = k (:func:`ground_chains`) the scan runs k
    frame chunks side by side on one device (``segment_sequence_chained``).
    Both differ from the single scan at the chunk heads."""
    if state.done.get("mask_ground_points"):
        return
    gcfg = ground_config_from_cfg(cfg, min_range=min_range)
    f_total = state.n_frames
    f_pad = frame_bucket(f_total)
    n_pts = state.points_bucket()
    cap_ng = state.caps.max_ng_points
    points = state.device("points", f_pad, n_pts)
    mask = state.device("points_mask", f_pad, n_pts)
    par = cfg.get("parallel", {})
    mesh = stage_mesh(state)
    n_dev = mesh.shape["dp"]
    chains = ground_chains(cfg, f_pad)
    if (n_dev > 1 and f_pad % n_dev == 0 and f_pad // n_dev >= 8
            and par.get("shard_frames", True)
            and par.get("shard_ground", True)):
        ground = parallel.sharded_ground(mesh, points, mask, gcfg, z_offset)
        ground = ground.to(state.torch_device) & mask
    elif chains > 1:
        ground = segment_sequence_chained(points, mask, gcfg, z_offset,
                                          chains) & mask
    else:
        ground = segment_sequence(points, mask, gcfg, z_offset)[0] & mask
    with trace.span("ground.compact"):
        ng_xyz, ng_mask, ng_src, cnts = _compact_sequence(
            points, mask, ground, _transforms_to_ref(state, f_pad), cap_ng)
    state.put_device("ground_mask", ground, f_pad, n_pts)
    state.put_device("ng_xyz", ng_xyz, f_pad, cap_ng)
    state.put_device("ng_mask", ng_mask, f_pad, cap_ng)
    state.put_device("ng_src", ng_src, f_pad, cap_ng)
    state._ng_counts = cnts[:f_total].cpu().numpy()
    state.done["mask_ground_points"] = True


def rebuild_ng_buffers(state: SequenceState):
    """Recompute the non-ground buffers from the raw frames and the
    (checkpoint-loaded) ground masks."""
    f_total = state.n_frames
    f_pad = frame_bucket(f_total)
    n_pts = state.points_bucket()
    cap_ng = state.caps.max_ng_points
    ng_xyz, ng_mask, ng_src, cnts = _compact_sequence(
        state.device("points", f_pad, n_pts),
        state.device("points_mask", f_pad, n_pts),
        state.device("ground_mask", f_pad, n_pts),
        _transforms_to_ref(state, f_pad), cap_ng)
    state.put_device("ng_xyz", ng_xyz, f_pad, cap_ng)
    state.put_device("ng_mask", ng_mask, f_pad, cap_ng)
    state.put_device("ng_src", ng_src, f_pad, cap_ng)
    state._ng_counts = cnts[:f_total].cpu().numpy()


# ---------------------------------------------------------------------------
# Stage 2: calculate_entropy_scores
# ---------------------------------------------------------------------------

def _frame_valid(f_total: int, f_pad: int, device) -> torch.Tensor:
    fv = torch.zeros(f_pad, dtype=torch.bool, device=device)
    fv[:f_total] = True
    return fv


def calculate_entropy_scores(state: SequenceState, cfg,
                             n_neighbouring_frames: int = 15,
                             skip_frames: int = 1,
                             max_neighbor_point_dist: float = 0.3,
                             max_neighbor_points: int = 1000,
                             include_ground_points: bool = False,
                             force: bool = False, **_):
    """MODEST-style ephemerality scores over a sliding frame window.
    ``include_ground_points`` fills the neighbour window with the FULL
    world-frame cloud; scored points stay the non-ground set (one device
    only). Otherwise, with D > 1 local devices dividing the padded frames
    into chunks of at least the window that also hold the padded tail's
    clamped windows, and ``parallel.shard_frames`` on, the frames shard
    over the devices with a halo (``parallel.sharded_entropy``)."""
    if state.done.get("calculate_entropy_scores") and not force:
        return
    f_total = state.n_frames
    f_pad = frame_bucket(f_total)
    n_ng = state.ng_bucket()
    window = min(n_neighbouring_frames, f_total)
    kw = dict(window=window, skip_frames=skip_frames,
              radius=max_neighbor_point_dist,
              max_neighbor_points=max_neighbor_points)
    frames = state.device("ng_xyz", f_pad, n_ng)
    masks = state.device("ng_mask", f_pad, n_ng)
    fv = _frame_valid(f_total, f_pad, state.torch_device)
    mesh = stage_mesh(state)
    n_dev = mesh.shape["dp"]
    use_mesh = (n_dev > 1 and f_pad % n_dev == 0
                and f_pad // n_dev >= window
                and (f_pad - f_total) + window <= f_pad // n_dev
                and cfg.get("parallel", {}).get("shard_frames", True))
    if include_ground_points:
        n_pts = state.points_bucket()
        full_ref = apply_transform(state.device("points", f_pad, n_pts)[..., :3],
                                   _transforms_to_ref(state, f_pad))
        scores = entropy_sequence(
            frames, masks, fv, data_frames=full_ref,
            data_masks=state.device("points_mask", f_pad, n_pts), **kw)
    elif use_mesh:
        scores = parallel.sharded_entropy(mesh, frames, masks,
                                          f_real=f_total, **kw)
        scores = scores.to(state.torch_device)
    else:
        scores = entropy_sequence(frames, masks, fv, **kw)
    state.put_device("ng_entropy", scores, f_pad, n_ng)
    state.done["calculate_entropy_scores"] = True


# ---------------------------------------------------------------------------
# Stage 3: spatial_clustering
# ---------------------------------------------------------------------------

def frame_select_stats_all(ng_xyz, ng_mask, ng_entropy, f_real: int):
    """Per-frame selection inputs, computed once per frame:
    (has_neighbor (F, N), dense_moving (F, N), entropy_mask (F, N)), all
    False from frame ``f_real`` (the real frame count) on.

    Points with no same-cloud neighbour within 0.2 m drop out; moving
    points (entropy < 0.6) re-admit only with >= 2 moving neighbours
    within sqrt(0.1) m. The real frames count in groups of at most
    ``CHUNK_PAGES``, each group one paged banded count a radius
    (:func:`~..ops.neighbors.radius_count_self_paged`, equal to each
    frame's own count)."""
    out = [torch.zeros(ng_mask.shape, dtype=torch.bool, device=ng_mask.device)
           for _ in range(3)]
    for g0 in range(0, f_real, CHUNK_PAGES):
        g = slice(g0, min(g0 + CHUNK_PAGES, f_real))
        xyz, m = ng_xyz[g], ng_mask[g]
        counts = radius_count_self_paged(xyz, m, 0.2, max_count=100)
        entropy_mask = m & (ng_entropy[g] < 0.6)
        moving = radius_count_self_paged(xyz, entropy_mask,
                                         float(np.sqrt(0.1)), max_count=4)
        for acc, v in zip(out, (counts >= 1, moving >= 2, entropy_mask)):
            acc[g] = v
    return tuple(out)


def select_cluster_input(ng_xyz, ng_mask, ng_entropy, f_real: int, f0: int,
                         chunk: int, seed: int, stats, n_frames_window: int,
                         cap_in: int):
    """The compacted n-frame 5-D cluster inputs [xyz, entropy, 0.1 * frame
    offset] of pages (frames) ``f0 .. f0 + chunk - 1``, as batched device
    work with no host read. The 1/n subsample is a Bernoulli(1/n) draw per
    point from the JAX package's threefry keys (bit-identical draws), made
    with the keep rule by ``ops/select_kernels.select_keep`` (one launch
    on the card). Each page's buffer holds its kept points first, in
    window-frame and row order, then the others as filler: the slots of
    ``argsort(~keep, stable=True)[:cap_in]``. Returns (features (chunk,
    cap_in, 5), mask (chunk, cap_in), src_frame, src_index (chunk,
    cap_in))."""
    n_frames, n = ng_mask.shape
    dev = ng_xyz.device
    nfw = n_frames_window
    keep = select_keep(page_keys(seed, f0, chunk, nfw), ng_mask, *stats, f0,
                       nfw, f_real)
    lo, frames, _ = window_frames(f0, chunk, nfw, f_real, n_frames, dev)
    # a kept point's slot: the kept before it; another's: all kept, then
    # the others before it (a permutation of each page's nfw * n rows)
    kept = keep.sum(dim=1)
    before = torch.cumsum(keep, dim=1)
    rows = torch.arange(nfw * n, device=dev).expand(chunk, -1)
    slot = torch.where(keep, before - 1, kept[:, None] + rows - before)
    order = torch.empty_like(slot).scatter_(1, slot, rows)[:, :cap_in]
    rel, src_index = order // n, order % n
    flat = torch.gather(frames, 1, rel) * n + src_index
    offset = (torch.arange(nfw, dtype=torch.float32, device=dev)
              * torch.full((), 0.1, dtype=torch.float32, device=dev))
    features = torch.cat([ng_xyz.reshape(-1, 3)[flat],
                          ng_entropy.reshape(-1)[flat][..., None],
                          offset[rel][..., None]], dim=2)
    feat_mask = torch.arange(cap_in, device=dev) < kept[:, None]
    # provenance per slot: which (frame, ng row) it came from
    src_frame = (lo[:, None] + rel).to(torch.int32)
    return features, feat_mask, src_frame, src_index.to(torch.int32)


def _post(lab_raw_in, probs, ngm, xyz, ent, prob_threshold, ephe_percentile,
          ephe_min_score, max_clusters, capacity):
    """One frame's label compaction, gather table and detection stats from
    ONE stable argsort of the raw labels."""
    dev = lab_raw_in.device
    lab_raw = torch.where(probs < prob_threshold, -1, lab_raw_in)
    n_pts = lab_raw.shape[0]
    valid0 = ngm & (lab_raw >= 0)
    big = 2 ** 30
    key_raw = torch.where(valid0, lab_raw, big)
    order = torch.argsort(key_raw, stable=True)
    key_s = key_raw[order]
    is_first = torch.cat([key_s[:1] < big,
                          (key_s[1:] != key_s[:-1]) & (key_s[1:] < big)])
    ranks = (torch.cumsum(is_first.to(torch.int32), 0) - 1).to(torch.int32)
    kept = (key_s < big) & (ranks < max_clusters)
    # compact ids follow the ascending raw root; clusters past
    # max_clusters and noise stay -1
    lab = torch.full((n_pts,), -1, dtype=torch.int32, device=dev)
    lab[order] = torch.where(kept, ranks, -1)
    search_key = torch.where(kept, ranks, max_clusters).contiguous()
    seg_ids = torch.arange(max_clusters, dtype=torch.int32, device=dev)
    starts = torch.searchsorted(search_key, seg_ids).to(torch.int32)
    ends = torch.searchsorted(search_key, seg_ids, right=True).to(torch.int32)
    cnt = ends - starts
    pos = (torch.arange(n_pts, dtype=torch.int32, device=dev)
           - starts[torch.clamp(search_key, max=max_clusters - 1).long()])
    in_table = kept & (pos < capacity)
    flat = torch.where(in_table, search_key * capacity + pos,
                       max_clusters * capacity).long()
    table = torch.full((max_clusters * capacity + 1,), -1, dtype=torch.int32,
                       device=dev)
    table[flat] = torch.where(in_table, order.to(torch.int32), -1)
    table = table[: max_clusters * capacity].reshape(max_clusters, capacity)
    valid = ngm & (lab >= 0)
    det_center = seg_ops.seg_median_by_label(xyz, lab, valid, max_clusters,
                                             runs=(starts, cnt))
    p = seg_ops.seg_percentile_by_label(ent, lab, valid, max_clusters,
                                        ephe_percentile, runs=(starts, cnt))
    det_static = p > ephe_min_score
    return lab, probs, cnt, det_center, det_static, table


def window_origins(ng_xyz, ng_mask, f_real: int, f0: int, chunk: int,
                   n_frames_window: int) -> torch.Tensor:
    """Each page's grid origin (chunk, 2): the corner of its frame WINDOW,
    which covers the selected data and the frame's full query cloud, so
    the label transfer reuses the data's sort with a shared grid. One
    masked minimum over every page's window frames."""
    _, frames, valid = window_frames(f0, chunk, n_frames_window, f_real,
                                     ng_xyz.shape[0], ng_xyz.device)
    m = ng_mask[frames] & valid[..., None]
    mn = torch.where(m[..., None], ng_xyz[..., :2][frames],
                     1e9).amin(dim=(1, 2))
    mn = torch.where(mn >= 1e9, 0.0, mn)
    return (torch.floor(mn / CELL) - 1.0) * CELL


def cluster_frames_chunk(ng_xyz, ng_mask, ng_entropy, f_real: int, stats,
                         f0: int, seed: int, chunk: int = 8,
                         n_frames_window: int = 2, cap_in: int = 65536,
                         eps: float = 0.15, min_samples: int = 5,
                         min_cluster_size: int = 15,
                         prob_threshold: float = 0.3,
                         ephe_percentile: float = 30.0,
                         ephe_min_score: float = 0.5,
                         max_clusters: int = 256, capacity: int = 4096,
                         direct_transfer: bool = True):
    """Cluster ``chunk`` consecutive frames of the ``f_real`` real ones.
    Big pages (``cap_in >= 16384``) run ONE paged clustering and ONE paged
    label transfer for the whole chunk; small pages cluster frame by
    frame. Returns the per-frame (labels, probs, det_n, det_center,
    det_static, table), each stacked over the chunk."""
    with trace.span("cluster.select"):
        feats, fmask, src_f, src_i = select_cluster_input(
            ng_xyz, ng_mask, ng_entropy, f_real, f0, chunk, seed, stats,
            n_frames_window, cap_in)
    n_ng = ng_xyz.shape[1]
    dev = ng_xyz.device
    chunk_xyz = ng_xyz[f0:f0 + chunk]
    chunk_ngm = ng_mask[f0:f0 + chunk]
    chunk_ent = ng_entropy[f0:f0 + chunk]
    if cap_in >= 16384:
        flat_feats = feats.reshape(chunk * cap_in, 5)
        flat_mask = fmask.reshape(chunk * cap_in)
        page_ids = torch.arange(chunk, dtype=torch.int32, device=dev)
        pages = page_ids.repeat_interleave(cap_in)
        orig = window_origins(ng_xyz, ng_mask, f_real, f0, chunk,
                              n_frames_window)
        presorted = paged_cell_sort(flat_feats, flat_mask, pages, chunk,
                                    origins=orig)
        with trace.span("cluster.dbscan"):
            raw_labels, raw_probs = dbscan_labels_paged(
                flat_feats, flat_mask, pages, chunk, eps=eps,
                min_samples=min_samples, min_cluster_size=min_cluster_size,
                presorted=presorted)
        # a selected point's nearest data point is itself at distance 0, so
        # its label/probability copy back through the selection provenance
        # and only the unselected remainder runs the kNN pass
        nq = chunk * n_ng
        if direct_transfer:
            page_of_src = (src_f - f0).reshape(-1)
            direct = fmask.reshape(-1) & (page_of_src == pages)
            tgt = torch.where(direct, page_of_src * n_ng + src_i.reshape(-1),
                              nq).long()
            lab_direct = torch.full((nq + 1,), -1, dtype=torch.int32,
                                    device=dev)
            lab_direct[tgt] = torch.where(direct, raw_labels, -1)
            prob_direct = torch.zeros(nq + 1, dtype=raw_probs.dtype,
                                      device=dev)
            prob_direct[tgt] = torch.where(direct, raw_probs, 0.0)
            covered = torch.zeros(nq + 1, dtype=torch.bool, device=dev)
            covered[tgt] = direct
            lab_direct, prob_direct = lab_direct[:nq], prob_direct[:nq]
            covered = covered[:nq]
        else:  # reference formulation: every point goes through the kNN
            covered = torch.zeros(nq, dtype=torch.bool, device=dev)
        q_pages = page_ids.repeat_interleave(n_ng)
        q_mask = chunk_ngm.reshape(nq) & ~covered
        labels_k, probs_k = knn_labels_paged(
            chunk_xyz.reshape(nq, 3), q_mask, q_pages, flat_feats[:, :3],
            flat_mask, pages, chunk, raw_labels, raw_probs,
            dist_threshold=0.2, d_presorted=presorted, origins=orig)
        if direct_transfer:
            labels_k = torch.where(covered, lab_direct, labels_k)
            probs_k = torch.where(covered, prob_direct, probs_k)
        labels = labels_k.reshape(chunk, n_ng)
        probs = probs_k.reshape(chunk, n_ng)
    else:
        # small pages: per-frame clustering and label transfer
        lp = []
        for i in range(chunk):
            with trace.span("cluster.dbscan"):
                raw_l, raw_p = dbscan_labels(
                    feats[i], fmask[i], eps=eps, min_samples=min_samples,
                    min_cluster_size=min_cluster_size)
            lp.append(knn_labels(chunk_xyz[i], chunk_ngm[i], feats[i][:, :3],
                                 fmask[i], raw_l, raw_p, dist_threshold=0.2))
        labels = torch.stack([x[0] for x in lp])
        probs = torch.stack([x[1] for x in lp])

    outs = [_post(labels[i], probs[i], chunk_ngm[i], chunk_xyz[i],
                  chunk_ent[i], prob_threshold, ephe_percentile,
                  ephe_min_score, max_clusters, capacity)
            for i in range(chunk)]
    return [torch.stack(x) for x in zip(*outs)]


def chunk_starts(f_pad: int, chunk: int) -> list[int]:
    """First frames of the clustering stage's chunks of ``chunk`` frames
    over ``f_pad``: a full-size final chunk is anchored at the bucket end
    (pages are independent, so the overlap recomputes identical
    frames)."""
    starts = list(range(0, f_pad - chunk + 1, chunk))
    if starts[-1] + chunk < f_pad:
        starts.append(f_pad - chunk)
    return starts


def spatial_clustering(state: SequenceState, cfg, n_frames: int = 2,
                       force: bool = False, **_):
    """Spatio-temporal density clustering + detection tables over chunks of
    frames of the resident buffers. With D > 1 local devices dividing the
    chunk and ``parallel.shard_cluster`` on, each device clusters its
    share of the chunk's frame windows (``parallel.sharded_cluster_chunk``;
    pages are independent, so the outputs are the single device's)."""
    if state.done.get("spatial_clustering") and not force:
        return
    caps = state.caps
    f_total = state.n_frames
    pre = cfg.get("preprocessor", {})
    model = pre.get("clustering", {}).get("model", {})
    ent_f = pre.get("clustering", {}).get("entropy_score_filter", {})
    cap_in = cfg.get("capacity", {}).get("max_cluster_input", 65536)

    f_pad = frame_bucket(f_total)
    n_ng = state.ng_bucket()
    dev_args = (state.device("ng_xyz", f_pad, n_ng),
                state.device("ng_mask", f_pad, n_ng),
                state.device("ng_entropy", f_pad, n_ng), f_total)
    seed = cfg.get("random_seed", 666)

    with trace.span("cluster.stats"):
        stats = frame_select_stats_all(*dev_args)
    # the cluster input holds ~1/n_frames of each window frame: bounded by
    # one frame's occupancy bucket
    cap_in = min(cap_in, max(4096, -(-n_ng // 2048) * 2048))
    # all frame windows are pages of one chunk
    chunk = min(f_pad, CHUNK_PAGES)
    kernel_kw = dict(
        n_frames_window=n_frames, cap_in=cap_in,
        eps=model.get("cluster_selection_epsilon", 0.15),
        min_samples=model.get("min_samples", 5),
        min_cluster_size=model.get("min_cluster_size", 15),
        prob_threshold=pre.get("clustering", {}).get("propability_threshold",
                                                     0.3),
        ephe_percentile=float(ent_f.get("percentile", 30)),
        ephe_min_score=ent_f.get("min_percentile_pp_score", 0.5),
        max_clusters=caps.max_clusters, capacity=caps.max_cluster_points)

    mesh = stage_mesh(state)
    n_dev = mesh.shape["dp"]
    if (n_dev > 1 and chunk % n_dev == 0
            and cfg.get("parallel", {}).get("shard_cluster", True)):
        def run_chunk(f0):
            return [a.to(state.torch_device) for a in
                    parallel.sharded_cluster_chunk(
                        mesh, cluster_frames_chunk, dev_args, stats, f0,
                        seed, chunk=chunk, **kernel_kw)]
    else:
        def run_chunk(f0):
            return cluster_frames_chunk(*dev_args, stats, f0, seed,
                                        chunk=chunk, **kernel_kw)

    outs, prev_end = [], 0
    for f0 in chunk_starts(f_pad, chunk):
        with trace.span("cluster.chunk"):
            o = run_chunk(f0)
        outs.append([a[prev_end - f0:] for a in o])
        prev_end = f0 + chunk
    stacked = [torch.cat([o[i] for o in outs]) for i in range(6)]
    state.put_device("labels", stacked[0], f_pad, n_ng)
    state.put_device("probs", stacked[1], f_pad, n_ng)
    tables = stacked[5]
    state._dev[("det_tables", f_pad, n_ng)] = (tables, tables >= 0)
    with trace.span("cluster.download"):
        state.det_n[...] = stacked[2][:f_total].cpu().numpy()
        state.det_center[...] = stacked[3][:f_total].cpu().numpy()
        state.det_static[...] = stacked[4][:f_total].cpu().numpy()
    state.det_valid[...] = state.det_n > 0
    state.done["spatial_clustering"] = True


# ---------------------------------------------------------------------------
# Stage 4: filter_detections
# ---------------------------------------------------------------------------

def _filter_metrics_frame(pts_raw, pts_mask, gnd_mask, t, xyz, ent, lab,
                          nmask, fnr: int, seed: int, ephe_percentile: float,
                          ransac_iters: int, max_clusters: int) -> dict:
    """Per-detection filter metrics of ONE frame: the RANSAC ground plane
    (keyed by the frame's global index) and, by label straight from the
    flat cloud, each cluster's z extent, bbox spans, signed plane
    distances, hull area and entropy percentile."""
    with trace.span("filter.plane", device=True):
        pts_ref = apply_transform(pts_raw[:, :3], t)
        gmask = gnd_mask & pts_mask
        gmask = torch.where(gmask.sum() >= 3, gmask, pts_mask)
        key = jrandom.fold_in(jrandom.PRNGKey(seed), fnr)
        plane = fit_ground_plane(pts_ref, gmask, key, iters=ransac_iters)
    with trace.span("filter.segments", device=True):
        valid = nmask & (lab >= 0)
        pmin = seg_ops.seg_min_by_label(xyz, lab, valid, max_clusters)
        pmax = seg_ops.seg_max_by_label(xyz, lab, valid, max_clusters)
        n = plane[:3]
        d = (_dot3(xyz, n) + plane[3]) / torch.sqrt(_dot3(n, n))
        return {
            "plane": plane,
            "height": pmax[:, 2] - pmin[:, 2],
            "size": pmax - pmin,
            "dmin": seg_ops.seg_min_by_label(d, lab, valid, max_clusters,
                                             fill=1e9),
            "dmax": seg_ops.seg_max_by_label(d, lab, valid, max_clusters,
                                             fill=-1e9),
            "hull_area": seg_ops.hull_area_by_label(xyz[:, :2], lab, valid,
                                                    max_clusters),
            "ephe_p": seg_ops.seg_percentile_by_label(ent, lab, valid,
                                                      max_clusters,
                                                      ephe_percentile),
        }


def filter_metrics_all(points, points_mask, ground_mask, transforms, ng_xyz,
                       ng_entropy, labels, ng_mask, seed: int,
                       ephe_percentile: float, ransac_iters: int = 100,
                       max_clusters: int = 256):
    """Filter metrics of every frame, each field stacked over frames."""
    per = [_filter_metrics_frame(points[f], points_mask[f], ground_mask[f],
                                 transforms[f], ng_xyz[f], ng_entropy[f],
                                 labels[f], ng_mask[f], f, seed,
                                 ephe_percentile, ransac_iters, max_clusters)
           for f in range(points.shape[0])]
    return {k: torch.stack([m[k] for m in per]) for k in per[0]}


def _combine_filters(filters, active, metrics: dict,
                     n_pts: np.ndarray) -> np.ndarray:
    """The reference's combinator over the host metrics and the point
    counts (F, C): valid = (all(and) or any(or)) and all(and + required)
    and n > 0."""
    height = metrics["height"]
    size = metrics["size"]           # (F, C, 3)
    dmin, dmax = metrics["dmin"], metrics["dmax"]
    hull_area = metrics["hull_area"]

    and_v, or_v, req_v = [], [], []
    for flt in filters:
        name = flt["name"]
        if name not in active:
            continue
        args = flt.get("args", {})
        if name == "filter_by_number_points":
            valid = (n_pts >= args.get("min_points", 0)) & (
                n_pts <= args.get("max_points", 999999))
        elif name == "filter_by_height":
            valid = (height >= args["min_height"]) & (height <= args["max_height"])
        elif name == "filter_by_plane_distance":
            # signed directional distance
            valid = (dmin <= args["max_min_height"]) & (dmax >= args["min_max_height"])
        elif name == "filter_by_aspect_ratio":
            mx = np.maximum(size[..., 0], size[..., 1])
            mn = np.maximum(np.minimum(size[..., 0], size[..., 1]), 1e-9)
            ar = mx / mn
            valid = (ar <= args["max_aspect_ratio"]) & (
                (ar >= args["min_aspect_ratio"])
                | (size[..., 0] < 1.0) | (size[..., 1] < 1.0))
        elif name in ("filter_by_volume", "filter_by_area"):
            vol = name == "filter_by_volume"
            metric = hull_area * height if vol else hull_area
            lo = args.get("min_volume" if vol else "min_area", 0.0)
            valid = (metric >= lo) & (n_pts >= 3)
            hi = args.get("max_volume" if vol else "max_area")
            if hi is not None:
                valid &= metric <= hi
        elif name == "filter_by_ephemeral_score":
            valid = ~(metrics["ephe_p"] > args["min_percentile_pp_score"])
        else:
            continue  # unknown filters are skipped, as in the reference
        if args.get("logic") == "and" and args.get("required", False):
            req_v.append(valid)
        elif args.get("logic") == "and":
            and_v.append(valid)
        elif args.get("logic") == "or":
            or_v.append(valid)
    shape = n_pts.shape
    all_and = np.all(and_v, axis=0) if and_v else np.ones(shape, bool)
    any_or = np.any(or_v, axis=0) if or_v else np.zeros(shape, bool)
    all_req = np.all(req_v, axis=0) if req_v else np.ones(shape, bool)
    return (all_and | any_or) & all_req & (n_pts > 0)


def filter_detections(state: SequenceState, cfg, force: bool = False, **_):
    """Apply the configured cluster filters to every detection, with the
    reference's combinator: valid = (all(and) or any(or)) and
    all(and + required). The metrics run on the device; the combinator
    stays on the host over (F, C) boolean arrays. With D > 1 local devices
    dividing the padded frames and ``parallel.shard_filter`` on, the
    frames shard over them (``parallel.sharded_filter_metrics``, every
    padded frame computed, as in the JAX package)."""
    if state.done.get("filter_detections") and not force:
        return
    pre = cfg.get("preprocessor", {})
    filters = pre.get("clustering", {}).get("filters", [])
    active = pre.get("clustering", {}).get("filters_active", [])
    caps = state.caps
    f_total = state.n_frames
    f_pad = frame_bucket(f_total)

    ephe_percentile = 20.0
    for flt in filters:
        if flt["name"] == "filter_by_ephemeral_score" and flt["name"] in active:
            ephe_percentile = float(flt.get("args", {}).get("percentile", 20))

    n_pts = state.points_bucket()
    n_ng = state.ng_bucket()
    metric_args = (
        *(state.device(k, f_pad, n_pts)
          for k in ("points", "points_mask", "ground_mask")),
        _transforms_to_ref(state, f_pad),
        *(state.device(k, f_pad, n_ng)
          for k in ("ng_xyz", "ng_entropy", "labels", "ng_mask")))
    kw = dict(ransac_iters=cfg.get("capacity", {}).get("ransac_iters", 100),
              max_clusters=caps.max_clusters)
    seed = cfg.get("random_seed", 666)
    mesh = stage_mesh(state)
    n_dev = mesh.shape["dp"]
    if (n_dev > 1 and f_pad % n_dev == 0
            and cfg.get("parallel", {}).get("shard_filter", True)):
        per_frame = parallel.sharded_filter_metrics(
            mesh, *metric_args, seed, ephe_percentile, **kw)
        per_frame = {k: v[:f_total].to(state.torch_device)
                     for k, v in per_frame.items()}
    else:
        # the real frames only (JAX also computes the padded ones, unread)
        per_frame = filter_metrics_all(*(a[:f_total] for a in metric_args),
                                       seed, ephe_percentile, **kw)
    # one download for all fields
    with trace.span("filter.download"):
        packed = torch.cat([v.reshape(f_total, -1).to(torch.float32)
                            for v in per_frame.values()],
                           dim=1).cpu().numpy()
    metrics, col = {}, 0
    for k, v in per_frame.items():
        width = v[0].numel()
        metrics[k] = packed[:, col:col + width].reshape(v.shape)
        col += width
    state.plane_ref[...] = metrics["plane"]

    with trace.span("filter.combine"):
        state.det_valid[...] = _combine_filters(filters, active, metrics,
                                                state.det_n)
    state.done["filter_detections"] = True
