"""Ephemerality / entropy motion scores (MODEST-style); the port of
``vilgod_tpu/ops/entropy.py``: the score from window counts, one frame's
scores against a window (``entropy_scores_window``) and a whole
sequence's (``entropy_sequence``). The width of each banded pair count is
``ops/banded.pass_window``'s decision, as for every banded pass."""
from __future__ import annotations

import torch

from .banded import (CELL, band_width, bandable, banded_radius_count,
                     pass_window, sort_by_cell)
from .kernels import TD, TQ, prep_t8
from .neighbors import radius2_threshold, radius_count


def entropy_from_counts(counts: torch.Tensor) -> torch.Tensor:
    """counts: (P, W) neighbour counts across W window frames -> (P,)
    score H = -sum(p log p) / log(W), p = count / sum(count). Low score =>
    ephemeral / moving."""
    w = counts.shape[1]
    total = counts.sum(dim=1, keepdim=True).to(torch.float32)
    p = counts.to(torch.float32) / (total + 1e-8)
    # log(W) as an f32 scalar, the way jnp.log(float(w)) evaluates it
    log_w = torch.log(torch.tensor(float(w), dtype=torch.float32))
    terms = -p * torch.log(p + 1e-8)
    # summed left to right over the W frames, the order of the JAX CPU
    # reduce, so a card and a CPU run give the same bits
    h = terms[:, 0]
    for k in range(1, w):
        h = h + terms[:, k]
    return h / log_w.to(counts.device)


def entropy_scores_window(query, query_mask, window, window_mask, seek,
                          radius: float = 0.3,
                          max_neighbor_points: int = 1000,
                          exclude_self_frame: bool = True) -> torch.Tensor:
    """Entropy scores of one frame's ``query`` (P, 3) against a window of
    frames (W, Pw, 3) with masks (W, Pw): per window frame one
    :func:`radius_count` (banded, kernel 1, for large tile-multiple clouds
    with a radius below the cell side; else the dense count, kernel 6),
    clipped at ``max_neighbor_points``. ``seek`` is the query frame's index
    in the window: its own count drops the query point itself. Invalid
    queries score 1."""
    seek = int(seek)
    counts = []
    for w in range(window.shape[0]):
        c = radius_count(query, query_mask, window[w], window_mask[w], radius,
                         max_count=max_neighbor_points + 1)
        if exclude_self_frame and w == seek:
            c = torch.clamp(c - 1, min=0)
        counts.append(torch.clamp(c, max=max_neighbor_points))
    h = entropy_from_counts(torch.stack(counts, dim=1))
    return torch.where(query_mask, h, torch.ones_like(h))


def entropy_sequence(frames, masks, frame_valid, window: int = 15,
                     skip_frames: int = 1, radius: float = 0.3,
                     max_neighbor_points: int = 1000, data_frames=None,
                     data_masks=None) -> torch.Tensor:
    """Entropy scores for a whole sequence.

    frames: (F, N, 3) world-frame non-ground clouds; masks (F, N);
    frame_valid (F,) marks real frames. ``data_frames``/``data_masks``
    (F, Nd, 3)/(F, Nd), when given, replace the neighbour window (the
    ``include_ground_points`` option); queries stay the non-ground points.

    Window start ``clamp(f, 0, F_real - W)`` with every ``skip_frames +
    1``-th frame sampled; the counts of each (frame, window frame) pair
    come from :func:`pair_counter`.
    """
    f_total = frames.shape[0]
    f_real = int(frame_valid.sum())
    w = min(window, f_total)
    sampled = list(range(w))[::skip_frames + 1]
    pair_counts = pair_counter(frames, masks, radius, max_neighbor_points,
                               data_frames, data_masks)
    return torch.stack([
        frame_scores(pair_counts, masks[fnr], fnr,
                     min(max(fnr, 0), max(f_real - w, 0)), sampled,
                     max_neighbor_points)
        for fnr in range(f_total)])


def pair_counter(frames, masks, radius: float, max_neighbor_points: int,
                 data_frames=None, data_masks=None):
    """``pair_counts(frame, window frame)``: each point of ``frames[frame]``
    counts the points of the window frame within ``radius``, clipped at
    ``max_neighbor_points + 1``; invalid points count 0.

    Large clouds with a radius below the cell side are cell-sorted once
    per frame against one grid origin over all ``frames``, and each pair
    is one banded count (kernel 1), re-run at full width when its windows
    overflow; otherwise each pair is one :func:`radius_count` (the dense
    all-pairs count, kernel 6, for such a radius).
    """
    f_total, n = frames.shape[:2]
    d_frames = frames if data_frames is None else data_frames
    d_masks = masks if data_masks is None else data_masks
    n_d = d_frames.shape[1]

    if not bandable(n, n_d, radius, 2048):
        def pair_counts(fnr, wf):
            return radius_count(frames[fnr], masks[fnr], d_frames[wf],
                                d_masks[wf], radius,
                                max_count=max_neighbor_points + 1)
        return pair_counts

    # ONE origin for all frames: frames' cell ids are compared against
    # other frames' ids inside the window passes
    big = torch.tensor(1e9, dtype=frames.dtype, device=frames.device)
    mn = torch.where(masks[..., None], frames[..., :2], big).amin(dim=(0, 1))
    if data_frames is not None:
        mn = torch.minimum(mn, torch.where(
            d_masks[..., None], d_frames[..., :2], big).amin(dim=(0, 1)))
    mn = torch.where(mn >= big, torch.zeros_like(mn), mn)
    seq_origin = (torch.floor(mn / CELL) - 1.0) * CELL

    def prep(pts, msk):
        order, cid = sort_by_cell(pts, msk, origin=seq_origin)
        return prep_t8(pts[order], msk[order], 1), cid, order

    sorted_q = [prep(frames[f], masks[f]) for f in range(f_total)]
    sorted_d = (sorted_q if data_frames is None else
                [prep(d_frames[f], d_masks[f]) for f in range(f_total)])
    w_band = band_width(n_d, tile=TD)
    tq = min(TQ, n)
    r2 = radius2_threshold(radius)

    def pair_counts(fnr, wf):
        q_t8, cq, order = sorted_q[fnr]
        d_t8, cd, _ = sorted_d[wf]
        starts, w, ends = pass_window(cq, cd, tq, w_band)
        c = banded_radius_count(q_t8, d_t8, starts, r2, tq, w, ends=ends)[:n]
        c_un = torch.zeros(n, dtype=torch.int32, device=frames.device)
        c_un[order] = c
        return torch.clamp(torch.where(masks[fnr], c_un, 0),
                           max=max_neighbor_points + 1)

    return pair_counts


def frame_scores(pair_counts, mask, fnr: int, start: int, sampled,
                 max_neighbor_points: int) -> torch.Tensor:
    """Frame ``fnr``'s entropy scores over the window frames ``start + s``
    for ``s`` in ``sampled``, from ``pair_counts`` (:func:`pair_counter`);
    the frame's own count drops the query point itself. Points outside
    ``mask`` score 1."""
    seek = fnr - start
    counts = []
    for s in sampled:
        c = pair_counts(fnr, start + s)
        if s == seek:
            c = torch.clamp(c - 1, min=0)
        counts.append(torch.clamp(c, max=max_neighbor_points))
    h = entropy_from_counts(torch.stack(counts, dim=1))
    return torch.where(mask, h, torch.ones_like(h))
