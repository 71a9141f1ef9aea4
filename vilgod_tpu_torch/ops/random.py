"""Counter-based random numbers bit-identical to ``jax.random``.

The clustering stage's 1/n subsample draws ``jax.random.uniform`` from
keys made with ``PRNGKey`` and ``fold_in`` (vilgod_tpu/pipeline/
stages_geometry.py:325-333), and the filter's RANSAC ground fit draws
``jax.random.gumbel`` from ``split`` keys (vilgod_tpu/ops/plane.py:48,89).
The port reproduces those draws exactly: threefry2x32 with 20 rounds, the
``jax_threefry_partitionable=True`` bit layout (the default of jax 0.9),
the mantissa trick of ``uniform``, and the float32 logarithm XLA's CPU
backend emits (:func:`xla_log`), so both packages draw the same numbers.

Keys are uint32 pairs held in int64 tensors (values in [0, 2**32)); the
arithmetic runs in int64 and masks to 32 bits, which works on every
device torch supports.
"""
from __future__ import annotations

import torch

from ..utils.common import fma32 as _fma

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


def split(key: tuple[int, int], num: int = 2) -> list[tuple[int, int]]:
    """``jax.random.split(key, num)``: the key hashed with (0, i)."""
    counts = torch.arange(num, dtype=torch.int64)
    y0, y1 = threefry2x32(key[0], key[1], torch.zeros_like(counts), counts)
    return list(zip(y0.tolist(), y1.tolist()))


def _unit_floats(key: tuple[int, int], n: int, device) -> torch.Tensor:
    """n floats in [0, 1): 23 random mantissa bits under the exponent of
    1.0, minus 1 (``jax.random._uniform``)."""
    counts = torch.arange(n, dtype=torch.int64, device=device)
    y0, y1 = threefry2x32(key[0], key[1], torch.zeros_like(counts), counts)
    float_bits = ((y0 ^ y1) >> 9) | 0x3F800000
    return float_bits.to(torch.int32).view(torch.float32) - 1.0


def uniform(key: tuple[int, int], n: int, device=None) -> torch.Tensor:
    """``jax.random.uniform(key, (n,))`` in float32 on ``device``."""
    return torch.clamp(_unit_floats(key, n, device), min=0.0)


# Cephes' log polynomial, as XLA's CPU backend evaluates it
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_LOG_Q1, _LOG_Q2 = -2.12194440e-4, 0.693359375


def xla_log(x: torch.Tensor) -> torch.Tensor:
    """The float32 natural logarithm of XLA's CPU backend, bit for bit, for
    positive finite ``x`` (read off its LLVM IR: Cephes' polynomial with
    the products fused into the following sums). ``torch.log`` differs from
    it in the last bit for about one input in seven, which would move
    ``jax.random.gumbel`` draws."""
    f32 = torch.float32
    x = torch.clamp(x.to(f32), min=1.17549435e-38)
    # every constant rounded to f32 first, as XLA holds them
    p = torch.tensor(_LOG_P, dtype=f32, device=x.device)
    q1, q2 = torch.tensor((_LOG_Q1, _LOG_Q2), dtype=f32, device=x.device)
    bits = x.view(torch.int32)
    e = 1.0 + ((bits >> 23) - 127).to(f32)
    # mantissa in [0.5, 1): the exponent bits of 0.5 under x's mantissa
    m = ((bits & 0x807FFFFF) | 0x3F000000).view(f32)
    low = m < 0.707106781186547524
    t = (m - 1.0) + torch.where(low, m, 0.0)
    e = e - low.to(f32)
    x2 = t * t
    x3 = x2 * t
    y = _fma(t, p[0], p[1])
    y1 = _fma(t, p[3], p[4])
    y2 = _fma(t, p[6], p[7])
    y = _fma(y, t, p[2])
    y1 = _fma(y1, t, p[5])
    y2 = _fma(y2, t, p[8])
    y = _fma(y, x3, y1)
    y = _fma(y, x3, y2)
    y = _fma(y, x3, e * q1)
    t = t - 0.5 * x2
    t = t + y
    return t + e * q2


def gumbel(key: tuple[int, int], shape: tuple[int, int],
           device=None) -> torch.Tensor:
    """``jax.random.gumbel(key, shape)`` (mode "low") in float32:
    ``-log(-log(u))`` with u uniform on [tiny, 1)."""
    n = 1
    for s in shape:
        n *= s
    tiny = torch.finfo(torch.float32).tiny
    # u = max(tiny, floats * (1 - tiny) + tiny); 1 - tiny rounds to 1.0
    u = torch.clamp(_unit_floats(key, n, device) + tiny, min=tiny)
    return -xla_log(-xla_log(u)).reshape(shape)
