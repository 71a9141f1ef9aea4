"""Products in the reference's precision or in its control's."""
from __future__ import annotations

import contextlib

import torch

FP8_MAX = 448.0  # largest finite float8_e4m3fn


@contextlib.contextmanager
def tf32(enabled: bool):
    """TF32 products on (the control) or off (the reference) inside."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one per-tensor scale, back in
    float32."""
    scale = x.abs().amax().clamp(min=1e-12) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def matmul(a: torch.Tensor, b: torch.Tensor, control: bool) -> torch.Tensor:
    """``a @ b`` in float32, or with both operands in fp8 (the control)."""
    if control:
        return fp8(a) @ fp8(b)
    return a @ b
