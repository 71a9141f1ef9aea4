"""SE(3) transforms of points and boxes, and the multi-view rotations;
the port of ``vilgod_tpu/ops/transforms.py``."""
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


def yaw_of(transformation: torch.Tensor) -> torch.Tensor:
    """Z-euler (yaw) of the rotation of (..., 4, 4) transforms."""
    return torch.atan2(transformation[..., 1, 0], transformation[..., 0, 0])


def apply_transform_boxes(boxes: torch.Tensor,
                          transformation: torch.Tensor) -> torch.Tensor:
    """Transform boxes (..., N, 7+) = [cx, cy, cz, l, w, h, yaw, ...]:
    centres by :func:`apply_transform`, yaw plus the transform's yaw,
    the other columns unchanged."""
    centers = apply_transform(boxes[..., :3], transformation)
    yaw = boxes[..., 6:7] + yaw_of(transformation)[..., None, None]
    return torch.cat([centers, boxes[..., 3:6], yaw, boxes[..., 7:]], dim=-1)


def make_se3(rotation: torch.Tensor, translation: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) from rotations (..., 3, 3) and translations (..., 3)."""
    out = torch.zeros(rotation.shape[:-2] + (4, 4), dtype=rotation.dtype,
                      device=rotation.device)
    out[..., :3, :3] = rotation
    out[..., :3, 3] = translation
    out[..., 3, 3] = 1.0
    return out


def invert_se3(transformation: torch.Tensor) -> torch.Tensor:
    """Inverse of rigid (..., 4, 4) transforms: R^T and -R^T t, the sum
    over j in order 0, 1, 2 as :func:`apply_transform` does."""
    rot_t = transformation[..., :3, :3].transpose(-1, -2)
    t = transformation[..., :3, 3]
    trans = (rot_t[..., :, 0] * t[..., 0:1] + rot_t[..., :, 1] * t[..., 1:2]
             + rot_t[..., :, 2] * t[..., 2:3])
    return make_se3(rot_t, -trans)


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
