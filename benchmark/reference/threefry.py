"""The configuration's seeded draws: threefry2x32 counters as
``jax.random`` lays them out (20 rounds, the partitionable bit layout).
The clustering's 1/n subsample and the filter's RANSAC triples are drawn
from ``random_seed``; the reference makes the same draws itself, as it
makes the same frames, so both sides sample the same points.

Keys are pairs of Python ints; counters run in int64 tensors masked to
32 bits. The Gumbel draws take their logarithms in float64: only a tie
within one float32 step among a row's three largest draws could order
them otherwise than the program, which keeps JAX's float32 logarithm.
"""
from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v, r):
    return ((v << r) | (v >> (32 - r))) & MASK


def block(k0: int, k1: int, x0: torch.Tensor, x1: torch.Tensor):
    """threefry2x32 of key (k0, k1) over counter pairs (x0, x1)."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def key(seed: int) -> tuple[int, int]:
    seed = int(seed)
    return (seed >> 32) & MASK, seed & MASK


def _hash(k: tuple[int, int], counts: torch.Tensor):
    return block(k[0], k[1], torch.zeros_like(counts), counts)


def fold_in(k: tuple[int, int], data: int) -> tuple[int, int]:
    y0, y1 = _hash(k, torch.tensor([int(data) & MASK]))
    return int(y0), int(y1)


def split(k: tuple[int, int]) -> list[tuple[int, int]]:
    y0, y1 = _hash(k, torch.arange(2))
    return list(zip(y0.tolist(), y1.tolist()))


def unit_floats(k: tuple[int, int], n: int, device) -> torch.Tensor:
    """n float32 in [0, 1): 23 random mantissa bits under 1.0's exponent,
    minus 1."""
    y0, y1 = _hash(k, torch.arange(n, device=device))
    bits = ((y0 ^ y1) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def gumbel(k: tuple[int, int], rows: int, n: int, device) -> torch.Tensor:
    """(rows, n) Gumbel draws, -log(-log(u)) with u on [tiny, 1), float64."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.clamp(unit_floats(k, rows * n, device) + tiny, min=tiny)
    return -torch.log(-torch.log(u.double())).view(rows, n)
