"""The filter stage's reference (stage 4): each frame's ground plane by the
configured two-stage RANSAC (``iters`` Gumbel-drawn triples a stage,
inliers within 0.1 m, the first best count) and a least-squares refit of
the second stage's inliers, then each cluster's point count, height and
signed plane distances, and the configured filters' verdicts.

Float32 with TF32 off, as the configuration states, each dot product
summed x, y, z; the refit's sums and eigenproblem in float64. The
control takes the transform and every point-plane product as TF32
products.
"""
from __future__ import annotations

import numpy as np
import torch

from . import threefry
from .precision import tf32

RANSAC_THRESHOLD = 0.1


def _dot(p: torch.Tensor, n: torch.Tensor, control: bool) -> torch.Tensor:
    """(N, 3) points against (K, 3) normals -> (N, K)."""
    if control:
        with tf32(True):
            return p @ n.T
    return (p[:, None, 0] * n[None, :, 0] + p[:, None, 1] * n[None, :, 1]
            + p[:, None, 2] * n[None, :, 2])


def to_first_pose(pts: np.ndarray, t: np.ndarray, device,
                  control: bool = False) -> torch.Tensor:
    """Float32 (N, 3) of sensor points under the 4x4 ``t``."""
    p = torch.from_numpy(pts).float().to(device)
    r = torch.from_numpy(t).float().to(device)
    if control:
        with tf32(True):
            return p @ r[:3, :3].T + r[:3, 3]
    return p[:, 0:1] * r[:3, 0] + p[:, 1:2] * r[:3, 1] + p[:, 2:3] * r[:3, 2] \
        + r[:3, 3]


def _planes(p0, p1, p2):
    a, b = p1 - p0, p2 - p0
    n = torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                     a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                     a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], dim=1)
    norm = torch.sqrt(n[:, 0] * n[:, 0] + n[:, 1] * n[:, 1]
                      + n[:, 2] * n[:, 2])
    n = n / torch.where(norm > 1e-9, norm, torch.ones_like(norm))[:, None]
    d = -(n[:, 0] * p0[:, 0] + n[:, 1] * p0[:, 1] + n[:, 2] * p0[:, 2])
    return n, d


def _ransac(pts, mask, key, iters, control):
    """One stage: the inliers of the first plane with the most of them."""
    scores = threefry.gumbel(key, iters, len(pts), pts.device)
    scores = scores.masked_fill(~mask[None, :], float("-inf"))
    tri = scores.topk(3, dim=1).indices
    n, d = _planes(pts[tri[:, 0]], pts[tri[:, 1]], pts[tri[:, 2]])
    inliers = ((_dot(pts, n, control) + d[None, :]).abs().T
               <= RANSAC_THRESHOLD) & mask[None, :]
    counts = inliers.sum(dim=1)
    counts = torch.where(n.norm(dim=1) < 0.5, -1, counts)
    return inliers[int(torch.argmax(counts))]


def ground_plane(pts, mask, seed: int, fnr: int, iters: int = 100,
                 control: bool = False) -> torch.Tensor:
    """[a, b, c, d] of frame ``fnr``, unit normal towards +z. ``pts`` (N,
    3) float32 in the first pose's frame, ``mask`` the points it is fit to;
    N is the program's padded point count, which the draws index."""
    k1, k2 = threefry.split(threefry.fold_in(threefry.key(seed), fnr))
    inl1 = _ransac(pts, mask, k1, iters, control)
    inl2 = _ransac(pts, mask & inl1, k2, iters, control)
    sel = pts[inl2]
    mean = sel.double().mean(dim=0).float()
    c = (sel - mean).double()
    _, vecs = torch.linalg.eigh(c.T @ c / max(len(sel) - 1, 1))
    n = vecs[:, 0].float()
    n = -n if n[2] < 0 else n
    return torch.cat([n, -(n[0] * mean[0] + n[1] * mean[1]
                           + n[2] * mean[2])[None]])


def cluster_metrics(xyz, labels, plane, n_clusters: int, control=False):
    """Per cluster id: points, height, least and largest signed plane
    distance. ``xyz`` (N, 3) float32, ``labels`` (N,) with -1 noise."""
    keep = labels >= 0
    lab, p = labels[keep].long(), xyz[keep]
    n = plane[None, :3]
    dist = (_dot(p, n, control)[:, 0] + plane[3]) / torch.sqrt(
        _dot(n, n, False)[0, 0])
    out = {"n": torch.zeros(n_clusters, dtype=torch.int64,
                            device=xyz.device).index_add_(
        0, lab, torch.ones_like(lab))}
    for name, v, how, fill in (("zmax", p[:, 2], "amax", -1e9),
                               ("zmin", p[:, 2], "amin", 1e9),
                               ("dmax", dist, "amax", -1e9),
                               ("dmin", dist, "amin", 1e9)):
        out[name] = torch.full((n_clusters,), fill, dtype=torch.float32,
                               device=xyz.device).scatter_reduce(
            0, lab, v, how, include_self=True)
    out["height"] = out["zmax"] - out["zmin"]
    return {k: v.cpu().numpy() for k, v in out.items()}


# the filters the reference knows: (metric, argument, default, sign), a
# cluster passing where sign * (metric - threshold) >= 0
TESTS = {
    "filter_by_number_points": [("n", "min_points", 0, 1),
                                ("n", "max_points", 999999, -1)],
    "filter_by_height": [("height", "min_height", None, 1),
                         ("height", "max_height", None, -1)],
    "filter_by_plane_distance": [("dmin", "max_min_height", None, -1),
                                 ("dmax", "min_max_height", None, 1)],
}


def verdicts(m: dict, filters: list[dict], margin: float):
    """(valid, decided) per cluster id: the active filters' combinator (all
    of "and" or any of "or", and all of "and" + required) on clusters with
    points, and whether every threshold lies more than ``margin`` from the
    cluster's metric (counts are exact)."""
    size = len(m["n"])
    groups = {"and": [], "or": [], "required": []}
    decided = np.ones(size, bool)
    for flt in filters:
        args = flt.get("args", {})
        ok = np.ones(size, bool)
        for metric, arg, default, sign in TESTS[flt["name"]]:
            limit = args.get(arg, default)
            ok &= sign * (m[metric] - limit) >= 0
            if metric != "n":
                decided &= np.abs(m[metric] - limit) > margin
        logic = args.get("logic")
        groups["required" if logic == "and" and args.get("required")
               else logic].append(ok)
    ones, zeros = np.ones(size, bool), np.zeros(size, bool)
    all_and = np.all(groups["and"], axis=0) if groups["and"] else ones
    any_or = np.any(groups["or"], axis=0) if groups["or"] else zeros
    req = np.all(groups["required"], axis=0) if groups["required"] else ones
    return (all_and | any_or) & req & (m["n"] > 0), decided
