"""Small shared utilities of the port: its device rule and the float32
fused multiply-add of XLA's CPU backend."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another one. Without a card, ``cuda`` raises instead of quietly
    running on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "vilgod_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch versions")
    return dev


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` with one rounding, as XLA's CPU backend fuses a
    product into the sum that follows it: the product of two f32 is exact
    in float64, so only the f64 sum and its f32 rounding round (double
    rounding differs from a true fused multiply-add about once in 2**29).
    The same torch ops give the same bits on the card."""
    return (a.double() * b.double() + c.double()).float()
