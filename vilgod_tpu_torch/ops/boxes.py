"""Box geometry, batched over clusters; the port of
``vilgod_tpu/ops/boxes.py``.

The rectangle fits take ``(B, P, 2)`` point sets with ``(B, P)`` masks and
fit all B at once (the JAX package vmaps its per-cluster functions); the
angle sweep runs over chunks of the batch so the ``(B, A, P)`` projections
stay small. Box layout everywhere: ``[cx, cy, cz, l, w, h, yaw]`` with z
the box centre.

Parity with XLA's CPU arithmetic where an ``argmin``/``argmax`` or a
threshold follows: the sweep angles are constants there, so XLA folds
their cosine and sine at compile time to the correctly rounded float32
values (here: float64 and one rounding), and it fuses one product of each
projection into the sum (``x c + y s`` keeps ``x c`` unrounded, ``-x s +
y c`` keeps ``y c``), which :func:`~vilgod_tpu_torch.utils.common.fma32`
reproduces. Cosines of data-dependent angles (the chosen heading, a box's
yaw) come from XLA's own float32 routine, which is not correctly rounded;
the port rounds correctly and agrees within the tolerances its tests
state.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..utils.common import fma32

_NEG = -1e9
_POS = 1e9
# batch rows per sweep chunk: keeps the (rows, angles, P) projections of a
# 4096-point table near 100 M elements
_SWEEP_ROWS = 128


def _cos_sin(angle: torch.Tensor):
    """float32 cosine and sine, correctly rounded (float64 and one
    rounding), so the card and the CPU give the same bits."""
    a = angle.double()
    return torch.cos(a).float(), torch.sin(a).float()


def _project(x, y, c, s):
    """XLA's rounding of the rotated coordinates ``(x c + y s, -x s + y c)``:
    the first product of the first and the second product of the second
    fused into its sum."""
    return fma32(x, c, y * s), fma32(y, c, (-x) * s)


def _sweep_angles(step_deg: float, device) -> torch.Tensor:
    """``jnp.arange(0, 90 + step, step) * (pi / 180)`` in float32."""
    deg = np.arange(0.0, 90.0 + step_deg, step_deg).astype(np.float32)
    rad = deg * np.float32(math.pi / 180.0)
    return torch.from_numpy(rad).to(device)


def _masked_minmax(v, mask):
    lo = torch.where(mask, v, _POS).amin(dim=-1)
    hi = torch.where(mask, v, _NEG).amax(dim=-1)
    return lo, hi


def _spans(px, py, mask):
    min_x, max_x = _masked_minmax(px, mask)
    min_y, max_y = _masked_minmax(py, mask)
    return min_x, max_x, min_y, max_y


def _corners_from_spans(min_x, max_x, min_y, max_y, angle):
    """Corner order of the reference fits: [[max_x, min_y], [min_x, min_y],
    [min_x, max_y], [max_x, max_y]] rotated back by ``angle`` -> (B, 4, 2)."""
    c, s = _cos_sin(angle)
    rx = torch.stack([max_x, min_x, min_x, max_x], dim=-1)
    ry = torch.stack([min_y, min_y, max_y, max_y], dim=-1)
    c, s = c[..., None], s[..., None]
    return torch.stack([rx * c - ry * s, rx * s + ry * c], dim=-1)


def _take(v, idx):
    """v (B, A), idx (B,) -> (B,)."""
    return torch.gather(v, 1, idx[:, None])[:, 0]


def _sweep(points_xy, mask, angles, score_fn=None):
    """Per batch chunk: the spans of every sweep angle (B, A) each and,
    with ``score_fn(px, py, spans, mask)``, its (B, A) score."""
    c, s = _cos_sin(angles)
    outs = []
    for b0 in range(0, points_xy.shape[0], _SWEEP_ROWS):
        p = points_xy[b0:b0 + _SWEEP_ROWS]
        m = mask[b0:b0 + _SWEEP_ROWS, None, :]
        x, y = p[:, None, :, 0], p[:, None, :, 1]
        px, py = _project(x, y, c[None, :, None], s[None, :, None])
        spans = _spans(px, py, m)
        outs.append(spans + ((score_fn(px, py, spans, m),)
                             if score_fn else ()))
    return [torch.cat(parts) for parts in zip(*outs)]


def _refit(points_xy, mask, angle):
    """Corners and area of the rectangle at ``angle`` (B,)."""
    c, s = _cos_sin(angle)
    x, y = points_xy[..., 0], points_xy[..., 1]
    px, py = _project(x, y, c[:, None], s[:, None])
    mn_x, mx_x, mn_y, mx_y = _spans(px, py, mask)
    corners = _corners_from_spans(mn_x, mx_x, mn_y, mx_y, angle)
    return corners, (mx_x - mn_x) * (mx_y - mn_y)


def min_area_rect(points_xy, mask, step_deg: float = 0.5):
    """Minimum-area bounding rectangle by a dense sweep over [0, 90] deg.
    Fewer than 3 valid points give a 0.1 m box at the mean.

    points_xy (B, P, 2), mask (B, P) -> (corners (B, 4, 2), angle (B,),
    area (B,))."""
    angles = _sweep_angles(step_deg, points_xy.device)
    min_x, max_x, min_y, max_y = _sweep(points_xy, mask, angles)
    areas = (max_x - min_x) * (max_y - min_y)
    best = torch.argmin(areas, dim=1)          # the first minimum
    angle = angles[best]
    corners = _corners_from_spans(_take(min_x, best), _take(max_x, best),
                                  _take(min_y, best), _take(max_y, best),
                                  angle)
    n_valid = mask.sum(dim=1)
    mean = (torch.where(mask[..., None], points_xy, 0.0).sum(dim=1)
            / torch.clamp(n_valid, min=1)[:, None])
    offsets = torch.tensor([[-0.05, -0.05], [0.05, -0.05], [0.05, 0.05],
                            [-0.05, 0.05]], dtype=points_xy.dtype,
                           device=points_xy.device)
    degenerate = n_valid < 3
    corners = torch.where(degenerate[:, None, None], mean[:, None, :] + offsets,
                          corners)
    angle = torch.where(degenerate, 0.0, angle)
    area = torch.where(degenerate, 0.0, _take(areas, best))
    return corners, angle, area


def _side_distances(px, py, spans):
    min_x, max_x, min_y, max_y = (v[..., None] for v in spans)
    dx = torch.minimum(px - min_x, max_x - px)
    dy = torch.minimum(py - min_y, max_y - py)
    return dx, dy


def _long_side_fit(points_xy, mask, angles, spans, score):
    """The best-scoring sweep angle turned so the long side lies along x,
    and the rectangle refit there."""
    best = torch.argmax(score, dim=1)          # the first maximum
    min_x, max_x, min_y, max_y = (_take(v, best) for v in spans)
    angle = angles[best]
    angle = torch.where((max_x - min_x) < (max_y - min_y),
                        angle + np.float32(math.pi / 2), angle)
    corners, area = _refit(points_xy, mask, angle)
    return corners, angle, area


def closeness_rect(points_xy, mask, delta_deg: float = 2.0,
                   delta_zero: float = 1e-2):
    """Closeness-score rectangle: per angle, the sum over points of
    1 / max(distance to the nearer side, ``delta_zero``); the best angle
    turned long side along x."""
    angles = _sweep_angles(delta_deg, points_xy.device)

    def score(px, py, spans, m):
        dx, dy = _side_distances(px, py, spans)
        beta = 1.0 / torch.clamp(torch.minimum(dx, dy), min=delta_zero)
        return torch.where(m, beta, 0.0).sum(dim=-1)

    *spans, sc = _sweep(points_xy, mask, angles, score)
    return _long_side_fit(points_xy, mask, angles, spans, sc)


def variance_rect(points_xy, mask, delta_deg: float = 1.0):
    """Variance-criterion rectangle: per angle, minus the variances of the
    distances to the nearer x and y sides."""
    angles = _sweep_angles(delta_deg, points_xy.device)

    def neg_var(values, sel):
        cnt = sel.sum(dim=-1)
        mean = (torch.where(sel, values, 0.0).sum(dim=-1)
                / torch.clamp(cnt, min=1))
        var = (torch.where(sel, (values - mean[..., None]) ** 2, 0.0)
               .sum(dim=-1) / torch.clamp(cnt, min=1))
        return torch.where(cnt > 0, -var, 0.0)

    def score(px, py, spans, m):
        dx, dy = _side_distances(px, py, spans)
        return neg_var(dx, m & (dx < dy)) + neg_var(dy, m & (dy < dx))

    *spans, sc = _sweep(points_xy, mask, angles, score)
    return _long_side_fit(points_xy, mask, angles, spans, sc)


def pca_rect(points_xy, mask):
    """Rectangle along the principal axis of the (B, P, 2) points."""
    n = torch.clamp(mask.sum(dim=1), min=1).to(points_xy.dtype)
    mean = torch.where(mask[..., None], points_xy, 0.0).sum(dim=1) / n[:, None]
    centered = torch.where(mask[..., None], points_xy - mean[:, None], 0.0)
    cov = (centered.transpose(1, 2) @ centered
           / torch.clamp(n - 1, min=1)[:, None, None])
    _, vecs = torch.linalg.eigh(cov)
    major = vecs[..., 1]                        # the largest eigenvalue's
    angle = torch.atan2(major[:, 1], major[:, 0])
    corners, area = _refit(points_xy, mask, angle)
    return corners, angle, area


# ---------------------------------------------------------------------------
# corners and membership
# ---------------------------------------------------------------------------

def box_corners_bev(boxes):
    """(..., 7) -> (..., 4, 2) BEV corners."""
    cx, cy = boxes[..., 0], boxes[..., 1]
    l, w = boxes[..., 3], boxes[..., 4]
    dx = torch.stack([l / 2, -l / 2, -l / 2, l / 2], dim=-1)
    dy = torch.stack([-w / 2, -w / 2, w / 2, w / 2], dim=-1)
    c, s = _cos_sin(boxes[..., 6])
    c, s = c[..., None], s[..., None]
    return torch.stack([cx[..., None] + dx * c - dy * s,
                        cy[..., None] + dx * s + dy * c], dim=-1)


def box_corners_3d(boxes):
    """(..., 7) -> (..., 8, 3): the BEV corners at the bottom, then at the
    top (z is the box centre)."""
    bev = box_corners_bev(boxes)
    low = (boxes[..., 2] - boxes[..., 5] / 2)[..., None].expand(bev.shape[:-1])
    high = (boxes[..., 2] + boxes[..., 5] / 2)[..., None].expand(bev.shape[:-1])
    z = torch.cat([low, high], dim=-1)
    return torch.cat([torch.cat([bev, bev], dim=-2), z[..., None]], dim=-1)


def points_in_boxes(points, boxes, point_mask=None, box_mask=None):
    """Per point, the index of the first box that contains it, else -1.
    points (P, 3+), boxes (B, 7) -> (P,) int64."""
    local = points[:, None, :3] - boxes[None, :, :3]
    c, s = _cos_sin(boxes[:, 6])
    lx, ly = _project(local[..., 0], local[..., 1], c[None], s[None])
    inside = ((lx.abs() <= boxes[None, :, 3] / 2)
              & (ly.abs() <= boxes[None, :, 4] / 2)
              & (local[..., 2].abs() <= boxes[None, :, 5] / 2))
    if box_mask is not None:
        inside &= box_mask[None, :]
    if point_mask is not None:
        inside &= point_mask[:, None]
    first = torch.argmax(inside.to(torch.uint8), dim=1)
    return torch.where(inside.any(dim=1), first, -1)


def get_box_heights(points, boxes, point_mask=None):
    """Each box's z centre and height re-derived from the points it holds
    (boxes without points unchanged). points (P, 3+), boxes (B, 7)."""
    idx = points_in_boxes(points, boxes, point_mask=point_mask)
    onehot = idx[:, None] == torch.arange(boxes.shape[0],
                                          device=boxes.device)[None, :]
    z = points[:, 2:3]
    zmin = torch.where(onehot, z, _POS).amin(dim=0)
    zmax = torch.where(onehot, z, _NEG).amax(dim=0)
    has = onehot.any(dim=0)
    h = zmax - zmin
    out = boxes.clone()
    out[:, 2] = torch.where(has, zmin + h / 2, boxes[:, 2])
    out[:, 5] = torch.where(has, h, boxes[:, 5])
    return out


# ---------------------------------------------------------------------------
# rotated IoU (BEV and 3D)
# ---------------------------------------------------------------------------

def _corners_inside(corners, boxes, eps: float = 1e-6):
    """corners (..., 4, 2) inside the BEV rectangles ``boxes`` (..., 7)."""
    local = corners - boxes[..., None, :2]
    c, s = _cos_sin(boxes[..., 6])
    lx, ly = _project(local[..., 0], local[..., 1], c[..., None],
                      s[..., None])
    return ((lx.abs() <= boxes[..., None, 3] / 2 + eps)
            & (ly.abs() <= boxes[..., None, 4] / 2 + eps))


def _overlap_bev(boxes_a, boxes_b):
    """Areas of the rotated BEV intersections of box pairs: ``boxes_a`` and
    ``boxes_b`` (..., 7) broadcast against each other.

    Candidate vertices: the corners of each box inside the other and the
    16 edge-edge intersections; the valid ones sorted by angle around their
    centroid (invalid slots pinned to the first valid vertex) and summed by
    the shoelace formula."""
    ba, bb = torch.broadcast_tensors(boxes_a, boxes_b)
    shape = ba.shape[:-1]
    ba, bb = ba.reshape(-1, 7), bb.reshape(-1, 7)
    ca, cb = box_corners_bev(ba), box_corners_bev(bb)      # (N, 4, 2)
    p = ca[:, :, None, :]
    r = (torch.roll(ca, -1, dims=1) - ca)[:, :, None, :]
    q = cb[:, None, :, :]
    s = (torch.roll(cb, -1, dims=1) - cb)[:, None, :, :]
    denom = r[..., 0] * s[..., 1] - r[..., 1] * s[..., 0]   # (N, 4, 4)
    qp = q - p
    safe = torch.where(denom == 0, 1.0, denom)
    t = (qp[..., 0] * s[..., 1] - qp[..., 1] * s[..., 0]) / safe
    u = (qp[..., 0] * r[..., 1] - qp[..., 1] * r[..., 0]) / safe
    inter_valid = ((denom.abs() > 1e-12) & (t >= 0) & (t <= 1) & (u >= 0)
                   & (u <= 1))
    inter = p + t[..., None] * r
    n_pairs = ba.shape[0]
    pts = torch.cat([ca, cb, inter.reshape(n_pairs, 16, 2)], dim=1)
    valid = torch.cat([_corners_inside(ca, bb), _corners_inside(cb, ba),
                       inter_valid.reshape(n_pairs, 16)], dim=1)
    n = valid.sum(dim=1)
    centroid = (torch.where(valid[..., None], pts, 0.0).sum(dim=1)
                / torch.clamp(n, min=1)[:, None])
    ang = torch.atan2(pts[..., 1] - centroid[:, None, 1],
                      pts[..., 0] - centroid[:, None, 0])
    ang = torch.where(valid, ang, _POS)
    order = torch.argsort(ang, dim=1, stable=True)
    pts_sorted = torch.gather(pts, 1, order[..., None].expand_as(pts))
    valid_sorted = torch.gather(valid, 1, order)
    closed = torch.where(valid_sorted[..., None], pts_sorted,
                         pts_sorted[:, :1])
    nxt = torch.roll(closed, -1, dims=1)
    cross = closed[..., 0] * nxt[..., 1] - nxt[..., 0] * closed[..., 1]
    area = 0.5 * cross.sum(dim=1).abs()
    return torch.where(n >= 3, area, 0.0).reshape(shape)


def iou3d_pairs(boxes_a, boxes_b):
    """Rotated 3D IoU of box pairs, ``boxes_a`` and ``boxes_b`` (..., 7)
    broadcast against each other -> (...)."""
    overlap = _overlap_bev(boxes_a, boxes_b)
    za_max = boxes_a[..., 2] + boxes_a[..., 5] / 2
    za_min = boxes_a[..., 2] - boxes_a[..., 5] / 2
    zb_max = boxes_b[..., 2] + boxes_b[..., 5] / 2
    zb_min = boxes_b[..., 2] - boxes_b[..., 5] / 2
    z_overlap = torch.clamp(torch.minimum(za_max, zb_max)
                            - torch.maximum(za_min, zb_min), min=0.0)
    inter = overlap * z_overlap
    vol_a = boxes_a[..., 3] * boxes_a[..., 4] * boxes_a[..., 5]
    vol_b = boxes_b[..., 3] * boxes_b[..., 4] * boxes_b[..., 5]
    return inter / torch.clamp(vol_a + vol_b - inter, min=1e-9)


def iou_bev_matrix(boxes_a, boxes_b):
    """(A, 7), (B, 7) -> (A, B) rotated BEV IoU."""
    overlap = _overlap_bev(boxes_a[:, None], boxes_b[None, :])
    area_a = (boxes_a[:, 3] * boxes_a[:, 4])[:, None]
    area_b = (boxes_b[:, 3] * boxes_b[:, 4])[None, :]
    return overlap / torch.clamp(area_a + area_b - overlap, min=1e-9)


def iou3d_matrix(boxes_a, boxes_b):
    """(A, 7), (B, 7) -> (A, B) rotated 3D IoU (pcdet ``boxes_iou3d_gpu``)."""
    return iou3d_pairs(boxes_a[:, None], boxes_b[None, :])


def bin_angles(angles, mask, n_bins: int = 45):
    """Orientation histogram over [0, pi): (counts (n_bins,), the mean
    angle of the fullest bin)."""
    two_pi = np.float32(2 * math.pi)
    pi = np.float32(math.pi)
    norm = torch.remainder(angles, two_pi)
    norm = torch.where(norm > pi, torch.remainder(norm, pi), norm)
    bins = torch.clamp((norm / np.float32(math.pi / n_bins)).to(torch.int64),
                       0, n_bins - 1)
    counts = torch.zeros(n_bins, dtype=torch.int64, device=angles.device)
    counts.index_add_(0, bins, mask.to(torch.int64))
    best = torch.argmax(counts)
    sel = mask & (bins == best)
    mean = (torch.where(sel, norm, 0.0).sum()
            / torch.clamp(sel.sum(), min=1))
    return counts, mean
