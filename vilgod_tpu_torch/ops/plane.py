"""Ground-plane estimation for the filter stage: fixed-iteration RANSAC
with Gumbel top-3 sampling and a least-squares (PCA) refit, and the
masked PCA plane statistics; the port of ``vilgod_tpu/ops/plane.py``.

The Gumbel draws are ``jax.random.gumbel``'s bit for bit
(:mod:`.random`), so both packages sample the same triples. Dot products
are written out in x, y, z order and the refit accumulates in float64, so
the card and the CPU agree on the inlier sets and the plane.
"""
from __future__ import annotations

import torch

from . import random as jrandom


def _dot3(p, n):
    """(..., 3) . (..., 3) -> (...), summed x, y, z in that order."""
    return p[..., 0] * n[..., 0] + p[..., 1] * n[..., 1] + p[..., 2] * n[..., 2]


def _cross(a, b):
    """jnp.cross's formula over the last axis of (..., 3) tensors."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def plane_from_triplet(p0, p1, p2) -> torch.Tensor:
    """Plane [a, b, c, d] through 3 points (batched over leading axes),
    |n| = 1 (0 if degenerate)."""
    n = _cross(p1 - p0, p2 - p0)
    norm = torch.sqrt(_dot3(n, n))
    n = n / torch.where(norm > 1e-9, norm, torch.ones_like(norm))[..., None]
    return torch.cat([n, -_dot3(n, p0)[..., None]], dim=-1)


def point_plane_distance(points, plane) -> torch.Tensor:
    """Unsigned distances; the plane normal is assumed unit."""
    return torch.abs(_dot3(points[:, :3], plane[:3]) + plane[3])


def top3_first(scores: torch.Tensor) -> torch.Tensor:
    """The indices of the three largest float32 ``scores`` of each row ->
    (rows, 3) int64, largest first, the lower index first among equal
    values (``jax.lax.top_k``'s order, -inf ties included).

    Each score becomes an order-preserving int32 key (its bits, the low 31
    flipped for negatives), packed over ``n - 1 - index`` into a unique
    int64, so the result depends on no library's tie rule. +0.0 and -0.0
    would get different keys; the RANSAC logits are +0.0 or -inf, so their
    sums with a draw are never -0.0."""
    n = scores.shape[-1]
    bits = scores.contiguous().view(torch.int32)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
    rev = torch.arange(n - 1, -1, -1, dtype=torch.int64, device=scores.device)
    top = torch.topk((key << 32) | rev, 3, dim=-1).values
    return (n - 1) - (top & 0xFFFFFFFF)


def ransac_plane(points, mask, key: tuple[int, int], threshold: float = 0.1,
                 iters: int = 100):
    """One RANSAC stage: (plane (4,), inlier mask (N,)). Index triples are
    drawn uniformly over valid points by Gumbel top-3 on masked logits;
    masked points sit at -inf, so they are drawn only when fewer than
    three valid points exist."""
    n = points.shape[0]
    gumbel = jrandom.gumbel(key, (iters, n), device=points.device)
    logits = torch.where(mask, 0.0, float("-inf"))
    triples = top3_first(logits[None, :] + gumbel)
    p = points[triples]                                   # (iters, 3, 3)
    planes = plane_from_triplet(p[:, 0], p[:, 1], p[:, 2])
    dists = torch.abs(_dot3(points[None, :, :3], planes[:, None, :3])
                      + planes[:, 3:4])
    inliers = (dists <= threshold) & mask[None, :]
    counts = inliers.sum(dim=1)
    degenerate = torch.sqrt(_dot3(planes[:, :3], planes[:, :3])) < 0.5
    counts = torch.where(degenerate, -1, counts)
    best = torch.argmax(counts)       # the first maximum, as jnp.argmax
    return planes[best], inliers[best]


def pca_plane_stats(points, mask):
    """Masked PCA plane: (normal (3,) flipped to +z, mean (3,), d,
    eigenvalues (3,) ascending and clipped at 0), the smallest eigenvector
    of the covariance as the normal and d = -normal . mean. The sums run
    in float64 and the eigenproblem too (JAX solves it in float32; the two
    differ by float32 rounding)."""
    n = torch.clamp(mask.sum(), min=1).to(torch.float64)
    pts = points[:, :3]
    mean = (torch.where(mask[:, None], pts, 0.0).to(torch.float64)
            .sum(dim=0) / n).to(torch.float32)
    centered = torch.where(mask[:, None], pts - mean, 0.0).to(torch.float64)
    cov = centered.T @ centered / torch.clamp(n - 1, min=1)
    eigvals, vecs = torch.linalg.eigh(cov)
    normal = vecs[:, 0].to(torch.float32)       # the smallest eigenvalue's
    normal = torch.where(normal[2] < 0, -normal, normal)
    return (normal, mean, -_dot3(normal, mean),
            torch.clamp(eigvals.to(torch.float32), min=0.0))


def refine_plane_lsq(points, mask) -> torch.Tensor:
    """Least-squares (PCA) plane through the masked points,
    [a, b, c, d] with a unit normal flipped to +z (:func:`pca_plane_stats`)."""
    normal, _, d, _ = pca_plane_stats(points, mask)
    return torch.cat([normal, d[None]])


def fit_ground_plane(points, mask, key: tuple[int, int],
                     threshold: float = 0.1, iters: int = 100) -> torch.Tensor:
    """Two-stage RANSAC ground fit: stage 1 over all points, stage 2 over
    the stage-1 inliers; the plane is the least-squares fit of the stage-2
    inliers, unit normal with +z. Returns [a, b, c, d]."""
    k1, k2 = jrandom.split(key)
    _, inl1 = ransac_plane(points, mask, k1, threshold, iters)
    _, inl2 = ransac_plane(points, mask & inl1, k2, threshold, iters)
    return refine_plane_lsq(points, inl2)
