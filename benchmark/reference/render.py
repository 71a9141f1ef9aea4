"""Multi-view depth images of a point cluster (PointCLIPv2's projection as
ViLGOD configures it: 4 views, a 112 x 112 x 8 grid, 5 x 5 max-pool
densify, 3 x 3 Gaussian of sigma 3, depth max, inversion, bilinear resize
to 224 with aligned corners), in plain float32 tensor operations."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# identity, x -18 deg, y +6 deg, y -6 deg (Euler x, y, z)
VIEW_ANGLES = ((0.0, 0.0, 0.0), (-math.pi / 10, 0.0, 0.0),
               (0.0, math.pi / 30, 0.0), (0.0, -math.pi / 30, 0.0))


def euler(ax: float, ay: float, az: float, device) -> torch.Tensor:
    """Rx @ Ry @ Rz."""
    cx, sx, cy, sy, cz, sz = (math.cos(ax), math.sin(ax), math.cos(ay),
                              math.sin(ay), math.cos(az), math.sin(az))
    rx = torch.tensor([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = torch.tensor([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rz = torch.tensor([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return (rx.double() @ ry.double() @ rz.double()).float().to(device)


def _median(v: torch.Tensor) -> torch.Tensor:
    s = torch.sort(v).values
    n = s.shape[0]
    return 0.5 * (s[(n - 1) // 2] + s[n // 2])


def to_origin(pts: torch.Tensor) -> torch.Tensor:
    """(P, 3) ego-frame cluster -> view-normalised: median-centre x and y,
    turn the centre onto the x axis, shift 1 m, reorder to (z, y, x) and
    remap by Rx(pi) Rz(pi/2)."""
    c = torch.stack([_median(pts[:, a]) for a in range(3)])
    ang = torch.atan2(c[1], c[0])
    ca, sa = torch.cos(-ang), torch.sin(-ang)
    x, y = pts[:, 0] - c[0], pts[:, 1] - c[1]
    x, y = ca * x - sa * y, sa * x + ca * y
    p = torch.stack([pts[:, 2], y, x - 1.0], dim=1)
    return p @ euler(math.pi, 0.0, math.pi / 2, pts.device).T


def views(pts: torch.Tensor, resolution: int = 112, depth: int = 8,
          obj_ratio: float = 0.8, depth_bias: float = 0.2,
          image_size: int = 224) -> torch.Tensor:
    """(P, 3) ego-frame cluster -> (4, image_size, image_size) in [0, 1]."""
    normed = to_origin(pts)
    out = []
    for angles in VIEW_ANGLES:
        p = normed @ euler(*angles, pts.device).T
        hi, lo = p.amax(dim=0), p.amin(dim=0)
        p = (p - (hi + lo) / 2) / (hi - lo).amax().clamp(min=1e-6) * 2.0
        x = torch.ceil((p[:, 0] * obj_ratio + 1) / 2 * resolution)
        y = torch.ceil((p[:, 1] * obj_ratio + 1) / 2 * resolution)
        z = ((p[:, 2] + 1) / 2 + depth_bias) / (1 + depth_bias) * (depth - 2)
        xi = x.clamp(1, resolution - 2).long()
        yi = y.clamp(1, resolution - 2).long()
        zi = torch.ceil(z).clamp(1, depth - 2).long()
        # each cell keeps its largest depth
        grid = torch.zeros(depth * resolution * resolution, device=pts.device)
        grid.scatter_reduce_(0, (zi * resolution + xi) * resolution + yi,
                             z.clamp(1.0, depth - 2.0), reduce="amax")
        grid = grid.view(depth, resolution, resolution)
        pooled = F.max_pool2d(grid[:, None], 5, stride=1, padding=1)
        g = torch.exp(-torch.arange(-1.0, 2.0, device=pts.device) ** 2
                      / (2 * 3.0 ** 2))
        g = g / g.sum()
        smooth = F.conv2d(pooled, (g[:, None] * g[None, :])[None, None],
                          padding=1)[:, 0]
        img = smooth.amax(dim=0)
        img = 1.0 - img / img.amax().clamp(min=1e-9)
        img = F.interpolate(img[None, None], size=(image_size, image_size),
                            mode="bilinear", align_corners=True)[0, 0]
        out.append(img.T)
    return torch.stack(out)
