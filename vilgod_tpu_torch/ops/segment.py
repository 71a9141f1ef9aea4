"""Per-cluster statistics; the port of ``vilgod_tpu/ops/segment.py``.

Over a padded (C, P) gather table: the gather itself, count, mean, min,
max, median and percentile per row. Straight from the flat cloud by
label: median, percentile, min, max, count and the support-function hull
area, which also gives one point set's hull (``convex_hull_area_bev``)."""
from __future__ import annotations

import math

import torch

from ..utils.common import fma32


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


_POS = 1e9
_NEG = -1e9


def gather_cluster_points(points, table, table_mask):
    """points (N, F), table (C, P) of indices -> (C, P, F), rows past a
    cluster's points zeroed."""
    gathered = points[torch.clamp(table, min=0).long()]
    return torch.where(table_mask[..., None], gathered, 0.0)


def seg_count(table_mask) -> torch.Tensor:
    """Valid entries per table row, int32."""
    return table_mask.sum(dim=-1, dtype=torch.int32)


def _row_mask(values, table_mask):
    return table_mask[..., None] if values.dim() == 3 else table_mask


def seg_mean(values, table_mask):
    """Mean over each row's valid entries; values (C, P) or (C, P, F)."""
    m = _row_mask(values, table_mask)
    cnt = torch.clamp(m.sum(dim=1), min=1)
    return torch.where(m, values, 0.0).sum(dim=1) / cnt


def seg_min(values, table_mask):
    """Minimum over each row's valid entries (1e9 for an empty row)."""
    return torch.where(_row_mask(values, table_mask), values,
                       _POS).amin(dim=1)


def seg_max(values, table_mask):
    """Maximum over each row's valid entries (-1e9 for an empty row)."""
    return torch.where(_row_mask(values, table_mask), values,
                       _NEG).amax(dim=1)


def _sorted_rows(values, table_mask):
    """Each row sorted with its invalid entries pushed to the end, and its
    valid count."""
    v = torch.sort(torch.where(table_mask, values, _POS), dim=1).values
    return v, table_mask.sum(dim=1)


def seg_median(values, table_mask):
    """Masked per-row median over a (C, P) table (numpy's: the mean of the
    two middle elements for even counts) -> (C,); values (C, P, F) give
    (C, F)."""
    if values.dim() == 3:
        return torch.stack([seg_median(values[..., f], table_mask)
                            for f in range(values.shape[-1])], dim=-1)
    v, cnt = _sorted_rows(values, table_mask)
    lo = torch.clamp(cnt - 1, min=0) // 2
    hi = torch.clamp(cnt, min=1) // 2
    med = 0.5 * (torch.gather(v, 1, lo[:, None])[:, 0]
                 + torch.gather(v, 1, hi[:, None])[:, 0])
    return torch.where(cnt > 0, med, 0.0)


def seg_percentile(values, table_mask, q: float):
    """Masked per-row percentile of a (C, P) table, numpy's linear
    interpolation; q in [0, 100]."""
    v, cnt = _sorted_rows(values, table_mask)
    # (q / 100) * count in f32, as the JAX package's weak-typed product
    q_f32 = torch.tensor(q / 100.0, dtype=torch.float32, device=cnt.device)
    pos = q_f32 * torch.clamp(cnt - 1, min=0).to(torch.float32)
    lo = torch.floor(pos).to(torch.int64)
    hi = torch.minimum(lo + 1, torch.clamp(cnt - 1, min=0))
    frac = pos - lo.to(torch.float32)
    out = (torch.gather(v, 1, lo[:, None])[:, 0] * (1 - frac)
           + torch.gather(v, 1, hi[:, None])[:, 0] * frac)
    return torch.where(cnt > 0, out, 0.0)


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


def _spare_row_index(labels, valid, num_segments):
    return torch.where(valid & (labels >= 0), labels, num_segments).long()


def _by_label_index(values, labels, valid, num_segments):
    """Scatter index (invalid points and label -1 -> the spare row
    ``num_segments``, where JAX's wrapped index -1 lands), expanded to the
    shape of ``values``."""
    idx = _spare_row_index(labels, valid, num_segments)
    if values.dim() == 2:
        idx = idx[:, None].expand(-1, values.shape[1])
    return idx


def _seg_extreme_by_label(values, labels, valid, num_segments, fill, reduce):
    start = float("inf") if reduce == "amin" else float("-inf")
    vmask = valid[:, None] if values.dim() == 2 else valid
    v = torch.where(vmask, values.to(torch.float32), start)
    out = torch.full((num_segments + 1,) + tuple(values.shape[1:]), start,
                     dtype=torch.float32, device=values.device)
    out.scatter_reduce_(0, _by_label_index(values, labels, valid,
                                           num_segments), v, reduce=reduce)
    out = out[:num_segments]
    return torch.where(torch.isfinite(out), out, fill)


def seg_min_by_label(values, labels, valid, num_segments: int,
                     fill: float = 0.0) -> torch.Tensor:
    """Per-label masked minimum by scatter-min; ``fill`` where a label has
    no point. values (N,) or (N, F)."""
    return _seg_extreme_by_label(values, labels, valid, num_segments, fill,
                                 "amin")


def seg_max_by_label(values, labels, valid, num_segments: int,
                     fill: float = 0.0) -> torch.Tensor:
    """Per-label masked maximum; see :func:`seg_min_by_label`."""
    return _seg_extreme_by_label(values, labels, valid, num_segments, fill,
                                 "amax")


def seg_count_by_label(labels, valid, num_segments: int) -> torch.Tensor:
    """Exact per-label point counts (not capped at a table capacity)."""
    idx = _spare_row_index(labels, valid, num_segments)
    cnt = torch.zeros(num_segments + 1, dtype=torch.int64,
                      device=labels.device)
    cnt.scatter_add_(0, idx, torch.ones_like(idx))
    return cnt[:num_segments].to(torch.int32)


def linspace0(stop: float, num: int, endpoint: bool = True,
              device=None) -> torch.Tensor:
    """``jnp.linspace(0, stop, num, endpoint)`` in float32 as XLA compiles
    it: the division by the step count becomes a product with its f32
    reciprocal, folded into ``stop``, so point i is ``i * f32(stop *
    f32(1 / div))``, and ``stop`` itself is appended exactly."""
    f32 = torch.float32
    div = num - 1 if endpoint else num
    recip = torch.tensor(1.0, dtype=f32) / torch.tensor(float(div), dtype=f32)
    delta = torch.tensor(stop, dtype=f32) * recip
    out = torch.arange(div, dtype=f32) * delta
    if endpoint:
        out = torch.cat([out, torch.tensor([stop], dtype=f32)])
    return out.to(device)


def hull_directions(n_angles: int, device=None) -> torch.Tensor:
    """(A, 2) unit directions at ``jnp.linspace(0, 2 pi, A,
    endpoint=False)``: f32 angles as XLA builds them, their cosine and sine
    taken in float64 and rounded once."""
    ang = linspace0(2 * math.pi, n_angles, endpoint=False).double()
    return torch.stack([torch.cos(ang), torch.sin(ang)],
                       dim=1).to(torch.float32).to(device)


def hull_area_by_label(points_xy, labels, valid, num_segments: int,
                       n_angles: int = 720, chunk: int = 90) -> torch.Tensor:
    """Per-label convex-hull area via support functions straight from the
    flat cloud: the (N, A) projections stream in ``chunk``-angle slices
    scatter-maxed into a (C, A) support table, and the polygon of
    consecutive support-line intersections gives the area. The projections
    are ``x cos + y sin`` with the second product fused into the sum, as
    XLA's dot rounds them, and the polygon sum accumulates in float64, so
    the card and the CPU agree."""
    dev = points_xy.device
    dirs = hull_directions(n_angles, dev)
    pts = torch.where(valid[:, None], points_xy.to(torch.float32), 0.0)
    idx = _spare_row_index(labels, valid, num_segments)
    h = torch.empty((num_segments, n_angles), dtype=torch.float32, device=dev)
    for a0 in range(0, n_angles, chunk):
        d = dirs[a0:a0 + chunk]
        # XLA's dot: x cos, then y sin fused into it (one rounding)
        proj = fma32(pts[:, 1:2], d[None, :, 1], pts[:, 0:1] * d[None, :, 0])
        proj = torch.where(valid[:, None], proj, float("-inf"))
        sup = torch.full((num_segments + 1, d.shape[0]), float("-inf"),
                         dtype=torch.float32, device=dev)
        sup.scatter_reduce_(0, idx[:, None].expand_as(proj), proj,
                            reduce="amax")
        h[:, a0:a0 + chunk] = sup[:num_segments]
    h_next = torch.roll(h, -1, dims=1)
    d1, d2 = dirs, torch.roll(dirs, -1, dims=0)
    det = d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0]
    vx = (h * d2[:, 1] - h_next * d1[:, 1]) / det
    vy = (h_next * d1[:, 0] - h * d2[:, 0]) / det
    terms = vx * torch.roll(vy, -1, dims=1) - torch.roll(vx, -1, dims=1) * vy
    area = 0.5 * torch.abs(terms.to(torch.float64).sum(dim=1)).to(torch.float32)
    cnt = seg_count_by_label(labels, valid, num_segments)
    return torch.where((cnt >= 3) & torch.isfinite(area), area, 0.0)


def convex_hull_area_bev(points_xy, mask, n_angles: int = 720):
    """Support-polygon convex-hull area of one masked 2-D point set (P, 2)
    -> scalar: :func:`hull_area_by_label` with every point under one
    label (the same polygon; its sum runs in float64, the JAX package's
    in float32). Under three valid points the area is 0."""
    labels = torch.zeros(points_xy.shape[0], dtype=torch.int32,
                         device=points_xy.device)
    return hull_area_by_label(points_xy, labels, mask, 1, n_angles)[0]
