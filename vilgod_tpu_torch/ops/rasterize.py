"""Multi-view depth-image rendering of point clusters (PointCLIPv2-style);
the port of ``vilgod_tpu/ops/rasterize.py:30-195``.

The whole cluster batch renders in one pass of batched torch ops:

  normalize -> 4-view rotate -> 112^3 grid scatter-max -> 5x5 maxpool
  densify -> 3x3 Gaussian smooth -> depth-max -> invert -> resize(224)

Three-term dot products (the view normalisation and the view rotations)
are evaluated as XLA's CPU backend evaluates them, a chain of fused
multiply-adds in coordinate order (emulated in float64), because a point's
grid cell is a ``ceil`` of them: one ulp can move a point to the next cell.
The constant view rotations are taken in float64 and rounded once.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.common import fma32
from .segment import linspace0

# The 4 fixed views of the reference: identity, x -18 deg, y +/- 6 deg.
VIEW_ANGLES = np.array(
    [
        [0.0, 0.0, 0.0],
        [-np.pi / 10, 0.0, 0.0],
        [0.0, np.pi / 30, 0.0],
        [0.0, -np.pi / 30, 0.0],
    ],
    dtype=np.float32,
)
NUM_VIEWS = 4
_BIG = 1e9


def _rotations_f64(angles: np.ndarray) -> np.ndarray:
    """R = Rx @ Ry @ Rz of float32 Euler angles (..., 3), in float64."""
    a = angles.astype(np.float64)
    c, s = np.cos(a), np.sin(a)
    z, o = np.zeros_like(c[..., 0]), np.ones_like(c[..., 0])

    def m(rows):
        return np.stack([np.stack(r, -1) for r in rows], -2)

    rx = m([[o, z, z], [z, c[..., 0], -s[..., 0]], [z, s[..., 0], c[..., 0]]])
    ry = m([[c[..., 1], z, s[..., 1]], [z, o, z], [-s[..., 1], z, c[..., 1]]])
    rz = m([[c[..., 2], -s[..., 2], z], [s[..., 2], c[..., 2], z], [z, z, o]])
    return rx @ ry @ rz


def view_rotations(device=None) -> torch.Tensor:
    """(V, 3, 3) float32 rotations of :data:`VIEW_ANGLES`."""
    return torch.from_numpy(_rotations_f64(VIEW_ANGLES).astype(np.float32)
                            ).to(device)


def _remap(device) -> torch.Tensor:
    """Rx(pi) @ Rz(pi/2) at float32 angles: the axis remap to image
    coordinates."""
    ang = np.array([np.float32(np.pi), 0.0, np.float32(np.pi / 2)],
                   np.float32)
    return torch.from_numpy(_rotations_f64(ang).astype(np.float32)).to(device)


def _fma_dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """float32 sum of a[..., k] * b[..., k] over k = 0, 1, 2 as a fused
    multiply-add chain: ((a0 b0) + a1 b1) + a2 b2, one rounding a step."""
    acc = a[..., 0] * b[..., 0]
    for k in (1, 2):
        acc = fma32(a[..., k], b[..., k], acc)
    return acc


def _rotate(points: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """``points @ rot.T`` for points (..., P, 3) and rot (..., 3, 3)."""
    return torch.stack([_fma_dot3(points, rot[..., None, j, :])
                        for j in range(3)], dim=-1)


def _masked_median(v: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """numpy's median of each row's masked entries (B, P) -> (B,)."""
    srt = torch.sort(torch.where(mask, v, _BIG), dim=1).values
    cnt = mask.sum(dim=1)
    lo = torch.clamp(cnt - 1, min=0) // 2
    hi = torch.clamp(cnt, min=1) // 2
    take = lambda i: torch.gather(srt, 1, i[:, None])[:, 0]  # noqa: E731
    return 0.5 * (take(lo) + take(hi))


def cluster_to_origin(points: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """View-normalise a batch of clusters (ego frame) for rendering:
    median-centre xy, yaw-align to the ego ray, shift 1 m in x, remap the
    axes to image coordinates via Rx(pi) @ Rz(pi/2) after a [z, y, x] swap.
    points (B, P, 3) masked by ``mask`` (B, P)."""
    from .transforms import rot_z

    center = torch.stack([_masked_median(points[..., a], mask)
                          for a in range(3)], dim=1)            # (B, 3)
    angle = torch.atan2(center[:, 1], center[:, 0])
    pts = torch.cat([points[..., :2] - center[:, None, :2], points[..., 2:]],
                    dim=-1)
    pts = _rotate(pts, rot_z(-angle))
    pts = torch.stack([pts[..., 2], pts[..., 1], pts[..., 0] - 1.0], dim=-1)
    pts = _rotate(pts, _remap(points.device))
    return torch.where(mask[..., None], pts, 0.0)


def _points_to_grid(points, mask, resolution: int, depth: int,
                    obj_ratio: float, depth_bias: float) -> torch.Tensor:
    """Quantise (view-rotated) clusters to z-buffer grids: points (N, P, 3)
    -> (N, depth, res, res), image rows = x, cols = y."""
    n = points.shape[0]
    pmax = torch.where(mask[..., None], points, -_BIG).amax(dim=1)
    pmin = torch.where(mask[..., None], points, _BIG).amin(dim=1)
    pcent = (pmax + pmin) / 2
    prange = torch.clamp((pmax - pmin).amax(dim=1), min=1e-6)
    p = (points - pcent[:, None]) / prange[:, None, None] * 2.0
    p = torch.cat([p[..., :2] * obj_ratio, p[..., 2:]], dim=-1)

    x = torch.ceil((p[..., 0] + 1) / 2 * resolution)
    y = torch.ceil((p[..., 1] + 1) / 2 * resolution)
    z = ((p[..., 2] + 1) / 2 + depth_bias) / (1 + depth_bias) * (depth - 2)
    z_int = torch.clamp(torch.ceil(z), 1, depth - 2).long()
    x = torch.clamp(x, 1, resolution - 2).long()
    y = torch.clamp(y, 1, resolution - 2).long()
    z_val = torch.clamp(z, 1.0, float(depth - 2))

    size = depth * resolution * resolution
    coords = z_int * resolution * resolution + y * resolution + x
    coords = torch.where(mask, coords, size)
    # one (size + 1) buffer per cluster; the spare cell takes masked points
    flat = coords + torch.arange(n, device=points.device)[:, None] * (size + 1)
    grid = torch.zeros(n * (size + 1), dtype=points.dtype,
                       device=points.device)
    grid.scatter_reduce_(0, flat.reshape(-1),
                         torch.where(mask, z_val, 0.0).reshape(-1),
                         reduce="amax")
    grid = grid.reshape(n, size + 1)[:, :size]
    grid = grid.reshape(n, depth, resolution, resolution)
    return grid.transpose(2, 3)


def _gaussian_taps(ksize: int, sigma: float) -> np.ndarray:
    """The normalised 1-D Gaussian of the separable smoothing, computed in
    float32 exactly as the JAX module does (numpy)."""
    xs = np.arange(ksize, dtype=np.float32) - ksize // 2
    k1 = np.exp(-(xs**2) / (2 * sigma**2))
    return (k1 / k1.sum()).astype(np.float32)


def _grid_to_image(grid: torch.Tensor, ksize: int = 3,
                   sigma: float = 3.0) -> torch.Tensor:
    """(B, D, H, W) z-buffer -> (B, H-2, W-2) depth image in [0, 1]: 5x5
    max-pool densify (padding 1, -inf fill), separable 3x3 Gaussian per
    depth slice (a shift-add with zero padding), max over depth,
    normalise, invert."""
    b, d, h, w = grid.shape
    pooled = F.max_pool2d(grid.reshape(b * d, 1, h, w), kernel_size=5,
                          stride=1, padding=1).reshape(b, d, h - 2, w - 2)
    k1 = _gaussian_taps(ksize, sigma)
    pad = ksize // 2

    def sep(x, axis):
        widths = [0, 0] * (x.dim() - 1 - axis) + [pad, pad]
        xp = F.pad(x, widths)
        n = x.shape[axis]
        out = float(k1[0]) * xp.narrow(axis, 0, n)
        for t in range(1, ksize):
            out = out + float(k1[t]) * xp.narrow(axis, t, n)
        return out

    smoothed = sep(sep(pooled, 2), 3)
    img = smoothed.amax(dim=1)
    peak = img.amax(dim=(1, 2), keepdim=True)
    return 1.0 - img / torch.clamp(peak, min=1e-9)


def _resize_bilinear_align_corners(img: torch.Tensor, out_h: int,
                                   out_w: int) -> torch.Tensor:
    """Bilinear resize with align_corners=True (the reference's
    ``interpolate``), written out as the JAX module does. img (..., H, W)."""
    h, w = img.shape[-2], img.shape[-1]
    ys = linspace0(h - 1.0, out_h, device=img.device)
    xs = linspace0(w - 1.0, out_w, device=img.device)
    y0 = torch.clamp(torch.floor(ys).long(), 0, h - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    x0 = torch.clamp(torch.floor(xs).long(), 0, w - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    wy = (ys - y0).to(img.dtype)
    wx = (xs - x0).to(img.dtype)
    r0, r1 = img[..., y0, :], img[..., y1, :]
    top = r0[..., :, x0] * (1 - wy)[:, None] + r1[..., :, x0] * wy[:, None]
    bottom = r0[..., :, x1] * (1 - wy)[:, None] + r1[..., :, x1] * wy[:, None]
    return top * (1 - wx)[None, :] + bottom * wx[None, :]


def render_cluster_views(points: torch.Tensor, mask: torch.Tensor,
                         resolution: int = 112, depth: int = 8,
                         obj_ratio: float = 0.8, depth_bias: float = 0.2,
                         image_size: int = 224) -> torch.Tensor:
    """Render a batch of ego-frame clusters to CLIP-ready images.

    points (B, P, 3) cluster points in the ego frame, mask (B, P).
    Returns (B, V, image_size, image_size) single-channel depth images in
    [0, 1], rows and columns in the reference's final orientation."""
    normed = cluster_to_origin(points, mask)                    # (B, P, 3)
    rots = view_rotations(points.device)                        # (V, 3, 3)
    # points @ R.T per view
    viewed = _rotate(normed[:, None], rots[None])             # (B, V, P, 3)
    b, v = viewed.shape[:2]
    flat_pts = viewed.reshape(b * v, -1, 3)
    flat_mask = mask[:, None, :].expand(b, v, mask.shape[1]).reshape(b * v, -1)
    grids = _points_to_grid(flat_pts, flat_mask, resolution, depth,
                            obj_ratio, depth_bias)
    imgs = _grid_to_image(grids)
    imgs = _resize_bilinear_align_corners(imgs, image_size, image_size)
    # the reference's final permute transposes H and W
    imgs = imgs.transpose(-1, -2)
    return imgs.reshape(b, v, image_size, image_size)
