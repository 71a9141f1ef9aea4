"""SE(3) point transforms; the part of ``vilgod_tpu/ops/transforms.py``
the ground and entropy stages use."""
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
