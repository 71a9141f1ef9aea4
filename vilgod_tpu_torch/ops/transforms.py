"""SE(3) point transforms and the multi-view rotations; the part of
``vilgod_tpu/ops/transforms.py`` the geometry stages and the renderer
use."""
from __future__ import annotations

import torch


def apply_transform(xyz: torch.Tensor, transformation: torch.Tensor) -> torch.Tensor:
    """``xyz @ R.T + t`` for xyz (..., N, 3) and transformation (..., 4, 4)
    (a batch of transforms broadcasts over the leading axes).

    Written out as products and sums in a fixed order (j = 0, 1, 2, then
    the translation) rather than a matmul, so the CPU and the card round
    identically whatever BLAS either would pick."""
    rot = transformation[..., None, :3, :3]
    trans = transformation[..., None, :3, 3]
    out = xyz[..., 0:1] * rot[..., :, 0]
    out = out + xyz[..., 1:2] * rot[..., :, 1]
    out = out + xyz[..., 2:3] * rot[..., :, 2]
    return out + trans


def _rot(c, s, rows):
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    vals = {"c": c, "s": s, "-s": -s, "0": zero, "1": one}
    return torch.stack([torch.stack([vals[k] for k in row], -1)
                        for row in rows], -2)


def rot_z(angle: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation about z."""
    return _rot(torch.cos(angle), torch.sin(angle),
                (("c", "-s", "0"), ("s", "c", "0"), ("0", "0", "1")))


def rot_x(angle: torch.Tensor) -> torch.Tensor:
    return _rot(torch.cos(angle), torch.sin(angle),
                (("1", "0", "0"), ("0", "c", "-s"), ("0", "s", "c")))


def rot_y(angle: torch.Tensor) -> torch.Tensor:
    return _rot(torch.cos(angle), torch.sin(angle),
                (("c", "0", "s"), ("0", "1", "0"), ("-s", "0", "c")))


def euler2mat(angles: torch.Tensor) -> torch.Tensor:
    """Euler (x, y, z) angles (..., 3) -> R = Rx @ Ry @ Rz (..., 3, 3), the
    reference multi-view projector's composition order."""
    return (rot_x(angles[..., 0]) @ rot_y(angles[..., 1])
            @ rot_z(angles[..., 2]))
