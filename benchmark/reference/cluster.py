"""The clustering stage's reference (stage 3) for one frame, by brute
force over all pairs:

1. selection: over the frame's window of ``n_window`` frames, each
   frame's non-ground points that have a neighbour within 0.2 m and win
   the configured Bernoulli(1/n) draw; points of entropy below 0.6 only
   with two such neighbours within sqrt(0.1) m; kept in frame and row
   order up to the cluster-input cap;
2. adaptive DBSCAN over the 5-D features [x, y, z, entropy, 0.1 * frame
   offset]: a point's core radius is the least of (eps, eps sqrt 2,
   2 eps) holding ``min_samples`` points, itself counted, and it is core
   where 2 eps does; core points join where their distance is within the
   larger of the two radii (connected components); a border point takes
   the cluster of its nearest core point when inside that point's radius;
   clusters under ``min_cluster_size`` are noise; a border point's
   probability is 1 - distance / radius;
3. the frame's other points take the label and probability of their
   nearest selected point within sqrt(0.2) m (3-D); labels of probability
   under the threshold become noise.

Squared distances are float32 differences summed column by column; the
control takes them as |q|^2 + |d|^2 - 2 q.d with TF32 products.
"""
from __future__ import annotations

import numpy as np
import torch
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components

from . import threefry
from .precision import tf32

BLOCK = 1024


def radius2(radius: float) -> float:
    """The squared radius of a neighbour count: r**2 in float64 plus half
    a 5 mm lattice step's square, rounded to float32 once."""
    return float(np.float32(np.float64(radius) ** 2 + 1.25e-5))


def cutoff2(d2: float) -> float:
    """The label transfer's squared-distance cutoff, nudged alike."""
    return float(np.float32(np.float64(d2) + 1.25e-5))


def _d2(q: torch.Tensor, d: torch.Tensor, control: bool) -> torch.Tensor:
    if control:
        with tf32(True):
            return ((q * q).sum(1)[:, None] + (d * d).sum(1)[None, :]
                    - 2.0 * q @ d.T)
    acc = (q[:, None, 0] - d[None, :, 0]) ** 2
    for c in range(1, q.shape[1]):
        acc = acc + (q[:, None, c] - d[None, :, c]) ** 2
    return acc


def _blocks(q, d, control):
    for i in range(0, len(q), BLOCK):
        yield i, _d2(q[i:i + BLOCK], d, control)


def _count(q, d, r2, control):
    return torch.cat([torch.zeros(0, dtype=torch.int64, device=q.device)]
                     + [(d2 <= r2).sum(1) for _, d2 in _blocks(q, d, control)])


def _nearest(q, d, control):
    best = [torch.zeros(0, device=q.device)]
    idx = [torch.zeros(0, dtype=torch.int64, device=q.device)]
    for _, d2 in _blocks(q, d, control):
        b, i = d2.min(dim=1)
        best.append(b)
        idx.append(i)
    return torch.cat(best), torch.cat(idx)


def select(clouds: list[torch.Tensor], ents: list[torch.Tensor], fnr: int,
           rel_frames: list[int], seed: int, n_rows: int, cap_in: int,
           control: bool = False):
    """The cluster input of frame ``fnr``: (features (M, 5), source frame
    offset (M,), source row (M,), the count before the cap). ``clouds[r]``
    (N_r, 3) and ``ents[r]``
    are the window's frames in order, ``rel_frames`` their offsets;
    ``n_rows`` the program's padded row count, which the draws index."""
    feats, src_rel, src_row = [], [], []
    n_window = len(rel_frames)
    for rel, xyz, ent in zip(rel_frames, clouds, ents):
        k = threefry.fold_in(threefry.fold_in(threefry.key(seed), fnr), rel)
        draw = threefry.unit_floats(k, n_rows, xyz.device)[:len(xyz)]
        has_nbr = _count(xyz, xyz, radius2(0.2), control) >= 2
        moving = ent < 0.6
        mv = xyz[moving]
        dense = torch.zeros_like(moving)
        if len(mv):
            dense[moving] = _count(mv, mv, radius2(float(np.sqrt(0.1))),
                                   control) >= 3
        keep = torch.where(moving, dense,
                           (draw.clamp(min=0.0) < 1.0 / n_window) & has_nbr)
        rows = torch.nonzero(keep)[:, 0]
        off = torch.tensor(rel, dtype=torch.float32) * torch.tensor(
            0.1, dtype=torch.float32)
        feats.append(torch.cat([xyz[rows], ent[rows, None],
                                off.to(xyz.device).expand(len(rows), 1)], 1))
        src_rel.append(torch.full_like(rows, rel))
        src_row.append(rows)
    feats = torch.cat(feats)
    return (feats[:cap_in], torch.cat(src_rel)[:cap_in],
            torch.cat(src_row)[:cap_in], len(feats))


def dbscan(x: torch.Tensor, eps: float, min_samples: int,
           min_cluster_size: int, control: bool = False):
    """(labels (M,) int64 with -1 noise, probabilities (M,) float32)."""
    labels = torch.full((len(x),), -1, dtype=torch.int64, device=x.device)
    probs = torch.zeros(len(x), dtype=torch.float32, device=x.device)
    if not len(x):
        return labels, probs
    e = torch.tensor(eps, dtype=torch.float32)
    f = torch.tensor(2.0, dtype=torch.float32)
    levels = torch.stack([e, e * f ** 0.5, e * f]).to(x.device)
    lv2 = levels * levels
    counts = torch.cat([torch.stack([(d2 <= lv2[j]).sum(1) for j in range(3)],
                                    1) for _, d2 in _blocks(x, x, control)])
    enough = counts >= min_samples
    first = torch.argmax(enough.to(torch.int32), dim=1)
    radius = torch.where(enough.any(1), levels[first], levels[2])
    r2 = radius * radius
    core = enough[:, 2]
    ci = torch.nonzero(core)[:, 0]
    xc, rc2 = x[ci], r2[ci]
    rows, cols = [], []
    for i, d2 in _blocks(xc, xc, control):
        joint = torch.maximum(rc2[i:i + BLOCK, None], rc2[None, :])
        a, b = torch.nonzero(d2 <= joint, as_tuple=True)
        rows.append((a + i).cpu().numpy())
        cols.append(b.cpu().numpy())
    n_core = len(ci)
    if n_core == 0:
        return labels, probs
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    graph = coo_matrix((np.ones(len(rows), np.int8), (rows, cols)),
                       shape=(n_core, n_core))
    _, comp = connected_components(graph, directed=False)
    labels[ci] = torch.from_numpy(comp.astype(np.int64)).to(x.device)
    probs[ci] = 1.0
    border = torch.nonzero(~core)[:, 0]
    if len(border):
        d2, j = _nearest(x[border], xc, control)
        inside = d2 <= rc2[j]
        labels[border] = torch.where(inside, labels[ci[j]], -1)
        probs[border] = torch.where(inside, torch.clamp(
            1.0 - torch.sqrt(d2) / radius[ci[j]], min=0.0), 0.0)
    sizes = torch.bincount(labels[labels >= 0])
    small = (labels >= 0) & (sizes[labels.clamp(min=0)] < min_cluster_size)
    labels[small] = -1
    probs[labels < 0] = 0.0
    return labels, probs


def frame_labels(xyz: torch.Tensor, feats, src_rel, src_row, own_rel: int,
                 labels, probs, prob_threshold: float,
                 control: bool = False) -> torch.Tensor:
    """The frame's points' labels: a selected point its own, the others
    their nearest selected point's within sqrt(0.2) m; noise where the
    probability is under ``prob_threshold``."""
    out = torch.full((len(xyz),), -1, dtype=torch.int64, device=xyz.device)
    p = torch.zeros(len(xyz), dtype=torch.float32, device=xyz.device)
    own = src_rel == own_rel
    out[src_row[own]] = labels[own]
    p[src_row[own]] = probs[own]
    rest = torch.ones(len(xyz), dtype=torch.bool, device=xyz.device)
    rest[src_row[own]] = False
    rows = torch.nonzero(rest)[:, 0]
    if len(rows) and len(feats):
        d2, j = _nearest(xyz[rows], feats[:, :3].contiguous(), control)
        near = d2 <= cutoff2(0.2)
        out[rows] = torch.where(near, labels[j], -1)
        p[rows] = torch.where(near & (labels[j] >= 0), probs[j], 0.0)
    return torch.where(p < prob_threshold, -1, out)


def mismatch_share(a: np.ndarray, b: np.ndarray) -> float:
    """The share of points labelled on either side that the best one-to-one
    matching of the two partitions' clusters does not pair."""
    either = (a >= 0) | (b >= 0)
    if not either.any():
        return 0.0
    both = (a >= 0) & (b >= 0)
    pairs, counts = np.unique(np.stack([a[both], b[both]]), axis=1,
                              return_counts=True)
    used_a, used_b, matched = set(), set(), 0
    for k in np.argsort(-counts, kind="stable"):
        x, y = pairs[0, k], pairs[1, k]
        if x not in used_a and y not in used_b:
            used_a.add(x)
            used_b.add(y)
            matched += int(counts[k])
    return 1.0 - matched / int(either.sum())
