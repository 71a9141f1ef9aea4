"""Counter-based random numbers bit-identical to ``jax.random``.

The clustering stage's 1/n subsample draws ``jax.random.uniform`` from
keys made with ``PRNGKey`` and ``fold_in`` (vilgod_tpu/pipeline/
stages_geometry.py:325-333). The port reproduces those draws exactly:
threefry2x32 with 20 rounds, the ``jax_threefry_partitionable=True`` bit
layout (the default of jax 0.9), and the mantissa trick of ``uniform``,
so both packages keep the same points.

Keys are uint32 pairs held in int64 tensors (values in [0, 2**32)); the
arithmetic runs in int64 and masks to 32 bits, which works on every
device torch supports.
"""
from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v, r):
    return ((v << r) | (v >> (32 - r))) & _MASK


def threefry2x32(k0: int, k1: int, x0: torch.Tensor, x1: torch.Tensor):
    """The threefry2x32 block cipher (20 rounds) of key (k0, k1) over the
    counter pairs (x0, x1) -> (y0, y1), as jax's ``threefry2x32_p``."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def PRNGKey(seed: int) -> tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` for a 32- or 64-bit integer seed."""
    seed = int(seed)
    return ((seed >> 32) & _MASK, seed & _MASK)


def fold_in(key: tuple[int, int], data: int) -> tuple[int, int]:
    """``jax.random.fold_in(key, data)``: the key hashed with (0, data)."""
    y0, y1 = threefry2x32(key[0], key[1],
                          torch.tensor([0], dtype=torch.int64),
                          torch.tensor([int(data) & _MASK], dtype=torch.int64))
    return int(y0), int(y1)


def uniform(key: tuple[int, int], n: int, device=None) -> torch.Tensor:
    """``jax.random.uniform(key, (n,))`` in float32 on ``device``."""
    counts = torch.arange(n, dtype=torch.int64, device=device)
    y0, y1 = threefry2x32(key[0], key[1], torch.zeros_like(counts), counts)
    bits = y0 ^ y1
    # 23 random mantissa bits under the exponent of 1.0 -> [1, 2) - 1
    float_bits = (bits >> 9) | 0x3F800000
    floats = float_bits.to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp(floats, min=0.0)
