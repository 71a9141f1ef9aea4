"""Per-label statistics straight from the flat cloud; the port of the
by-label median and percentile of ``vilgod_tpu/ops/segment.py``."""
from __future__ import annotations

import torch


def _label_runs(labels: torch.Tensor, valid: torch.Tensor, num_segments: int):
    """Sorted-run bookkeeping shared by the by-label statistics:
    (sort key with invalid -> num_segments, per-segment start, count)."""
    key = torch.where(valid, labels, num_segments).to(torch.int32)
    seg_ids = torch.arange(num_segments, dtype=torch.int32, device=key.device)
    key_sorted = torch.sort(key).values
    starts = torch.searchsorted(key_sorted, seg_ids).to(torch.int32)
    ends = torch.searchsorted(key_sorted, seg_ids, right=True).to(torch.int32)
    return key, starts, ends - starts


def _values_by_label(values, labels, valid, num_segments):
    """Values sorted by (label, value) lexicographically: two stable sorts,
    least significant key first (``jax.lax.sort`` with num_keys=2)."""
    key = torch.where(valid, labels, num_segments).to(torch.int32)
    vals = values.to(torch.float32)
    by_val = torch.argsort(vals, stable=True)
    by_key = torch.argsort(key[by_val], stable=True)
    return vals[by_val[by_key]]


def _take(values, idx):
    """Gather with indices clamped into range, as an XLA gather clamps
    (empty segments start at N; their result is masked afterwards)."""
    return values[torch.clamp(idx, 0, values.shape[0] - 1).long()]


def seg_median_by_label(values, labels, valid, num_segments: int,
                        runs=None) -> torch.Tensor:
    """Per-label masked median (numpy's: the mean of the two middle
    elements for even counts) over ALL of a label's points. values (N,) or
    (N, F). ``runs``: precomputed ``(starts, cnt)`` of :func:`_label_runs`."""
    if values.dim() == 2:
        return torch.stack(
            [seg_median_by_label(values[:, f], labels, valid, num_segments,
                                 runs=runs)
             for f in range(values.shape[1])], dim=-1)
    if runs is None:
        _, starts, cnt = _label_runs(labels, valid, num_segments)
    else:
        starts, cnt = runs
    val_sorted = _values_by_label(values, labels, valid, num_segments)
    lo = starts + torch.clamp(cnt - 1, min=0) // 2
    hi = starts + torch.clamp(cnt, min=1) // 2
    med = 0.5 * (_take(val_sorted, lo) + _take(val_sorted, hi))
    return torch.where(cnt > 0, med, torch.zeros_like(med))


def seg_percentile_by_label(values, labels, valid, num_segments: int,
                            q: float, runs=None) -> torch.Tensor:
    """Per-label masked percentile (numpy's linear interpolation) straight
    from the flat cloud; see :func:`seg_median_by_label`."""
    if runs is None:
        _, starts, cnt = _label_runs(labels, valid, num_segments)
    else:
        starts, cnt = runs
    val_sorted = _values_by_label(values, labels, valid, num_segments)
    # (q / 100) * count in f32, as the JAX package's weak-typed product
    q_f32 = torch.tensor(q / 100.0, dtype=torch.float32, device=cnt.device)
    pos = q_f32 * torch.clamp(cnt - 1, min=0).to(torch.float32)
    lo = torch.floor(pos).to(torch.int32)
    hi = torch.minimum(lo + 1, torch.clamp(cnt - 1, min=0))
    frac = pos - lo.to(torch.float32)
    out = (_take(val_sorted, starts + lo) * (1 - frac)
           + _take(val_sorted, starts + hi) * frac)
    return torch.where(cnt > 0, out, torch.zeros_like(out))
