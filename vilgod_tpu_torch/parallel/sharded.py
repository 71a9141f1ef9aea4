"""Frame-parallel stage programs over a :class:`~.mesh.Mesh`; the port of
``vilgod_tpu/parallel/sharded.py``.

Each function runs its shard bodies one after the other from this
process, each on its shard's device (every tensor a body makes is made
there, and every kernel wrapper launches on that device's stream), and
returns its per-shard outputs concatenated on the mesh's first device, as
the JAX package's stages gather them to ``devices()[0]``. The one
collective, the entropy window's halo, is a device-to-device copy of the
successor's head; ``psum`` is a sum on the first device.
"""
from __future__ import annotations

import torch

from ..ground.patchwork import segment_sequence
from ..ops.entropy import frame_scores, pair_counter
from .mesh import Mesh, frame_sharding, replicated


def _gather(mesh: Mesh, parts) -> torch.Tensor:
    first = mesh.devices[0]
    return torch.cat([p.to(first) for p in parts])


def sharded_entropy(mesh: Mesh, frames, masks, f_real: int | None = None,
                    window: int = 15, skip_frames: int = 1,
                    radius: float = 0.3, max_neighbor_points: int = 1000,
                    axis: str = "dp") -> torch.Tensor:
    """Entropy scores for all frames, frame-sharded with a halo.

    frames: (F, N, 3) world-frame padded clouds; masks: (F, N); ``f_real``
    is the number of REAL frames (<= F; the tail F - f_real frames are
    shape-bucket padding and come back masked to 1.0). Shard d holds
    frames ``[d * F/D, (d + 1) * F/D)`` and receives its successor's first
    ``window`` frames as its halo, so every local frame sees its whole
    window; the last shard's halo is invalid (its windows clamp at
    ``f_real - window`` inside its own chunk). Requirements (checked): F
    divisible by the mesh size, ``F / D >= window`` and ``F - f_real +
    window <= F / D``. Equal to :func:`~..ops.entropy.entropy_sequence`
    on the real frames. Returns (F, N) scores on the mesh's first device.
    """
    d = mesh.shape[axis]
    f_total = frames.shape[0]
    f_real = f_total if f_real is None else f_real
    chunk = f_total // d
    if chunk < window:
        raise ValueError(f"frames per device ({chunk}) < window ({window}); "
                         f"grow the frame batch or shrink the mesh")
    if f_total - f_real + window > chunk:
        raise ValueError(
            f"padded tail ({f_total - f_real}) + window ({window}) exceeds "
            f"the per-device chunk ({chunk}): tail-clamped window starts "
            f"would leave the last device's chunk")
    sampled = list(range(window))[::skip_frames + 1]
    sh = frame_sharding(mesh, axis)
    frames_c, masks_c = sh.put(frames), sh.put(masks)
    # padded tail frames (global index >= f_real) are masked out so they
    # neither receive real scores nor contribute counts
    masks_c = [m & (torch.arange(i * chunk, (i + 1) * chunk, device=m.device)
                    < f_real)[:, None] for i, m in enumerate(masks_c)]
    out = []
    for i, dev in enumerate(mesh.devices):
        if i < d - 1:
            halo_f = frames_c[i + 1][:window].to(dev)
            halo_m = masks_c[i + 1][:window].to(dev)
        else:
            halo_f = torch.zeros_like(frames_c[i][:window])
            halo_m = torch.zeros_like(masks_c[i][:window])
        ext_f = torch.cat([frames_c[i], halo_f])      # (chunk + W, N, 3)
        ext_m = torch.cat([masks_c[i], halo_m])
        pair_counts = pair_counter(ext_f, ext_m, radius, max_neighbor_points)
        scores = []
        for local_f in range(chunk):
            # the window start clamps at the REAL tail; relative to this
            # chunk it is local_f unless clamped back
            start_g = min(max(i * chunk + local_f, 0), f_real - window)
            scores.append(frame_scores(pair_counts, ext_m[local_f], local_f,
                                       start_g - i * chunk, sampled,
                                       max_neighbor_points))
        out.append(torch.stack(scores))
    return _gather(mesh, out)


def sharded_cluster_chunk(mesh: Mesh, cluster_fn, dev_args: tuple,
                          stats: tuple, f0, seed, chunk: int,
                          axis: str = "dp", **static_kw):
    """Shard a ``cluster_frames_chunk``-shaped program's frame/page axis
    over the mesh: shard d clusters the ``chunk / D`` frame windows from
    ``f0 + d * chunk / D``. Pages are distance- and cell-isolated, so each
    shard's paged launch is independent and the per-frame outputs equal
    the single-device chunk's.

    ``dev_args`` = (ng_xyz, ng_mask, ng_entropy, f_real): the three
    buffers and ``stats`` replicate across the mesh (each frame's
    selection window reads neighbouring frames, so work, not data, is
    what shards); ``f_real``, the real frame count, goes to every shard.
    Returns the per-frame outputs, each concatenated on the mesh's first
    device.
    """
    d = mesh.shape[axis]
    if chunk % d != 0:
        raise ValueError(f"chunk ({chunk}) must divide over the mesh ({d})")
    chunk_local = chunk // d
    repl = replicated(mesh)
    *buffers, f_real = dev_args
    args = [repl.put(a) for a in buffers]
    stats_r = [repl.put(s) for s in stats]
    outs = [cluster_fn(*(a[i] for a in args), f_real,
                       tuple(s[i] for s in stats_r),
                       int(f0) + i * chunk_local, seed, chunk=chunk_local,
                       **static_kw)
            for i in range(d)]
    return [_gather(mesh, parts) for parts in zip(*outs)]


def sharded_ground(mesh: Mesh, points, masks, gcfg, z_offset: float = 0.0,
                   axis: str = "dp") -> torch.Tensor:
    """Frame-sharded Patchwork++ ground segmentation: each shard scans its
    own frame chunk with a fresh A-GLE/TGR state, so the first frames of
    each chunk see the un-adapted thresholds as frame 0 of any scan does.
    Contract: equal to the per-chunk ``segment_sequence`` scans
    concatenated, NOT to the full scan.

    points: (F, N, 4+) sensor frame; masks: (F, N). F must divide over
    the mesh. Returns (F, N) bool ground masks on the mesh's first device.
    """
    d = mesh.shape[axis]
    f_total = points.shape[0]
    if f_total % d != 0:
        raise ValueError(f"frames ({f_total}) must divide over the mesh ({d})")
    sh = frame_sharding(mesh, axis)
    return _gather(mesh, [segment_sequence(p, m, gcfg, z_offset)[0]
                          for p, m in zip(sh.put(points), sh.put(masks))])


def global_detection_count(mesh: Mesh, det_valid,
                           axis: str = "dp") -> torch.Tensor:
    """The detection count across the mesh: each shard's sum on its
    device, summed on the first device (JAX's ``psum``)."""
    parts = frame_sharding(mesh, axis).put(det_valid)
    return _gather(mesh, [p.sum().reshape(1) for p in parts]).sum()


def sharded_filter_metrics(mesh: Mesh, points, points_mask, ground_mask,
                           transforms, ng_xyz, ng_entropy, labels, ng_mask,
                           seed, ephe_percentile, ransac_iters=100,
                           max_clusters=256, axis: str = "dp"):
    """Frame-sharded filter metrics (stage 4): the per-frame RANSAC plane
    and by-label cluster statistics are frame-independent, so the frame
    axis shards with no collective. Each frame keys its RANSAC by its
    GLOBAL index, so every field equals ``filter_metrics_all``'s. Returns
    the fields, each stacked over all F frames on the mesh's first device.
    """
    from ..pipeline.stages_geometry import _filter_metrics_frame

    f_total = points.shape[0]
    d = mesh.shape[axis]
    if f_total % d != 0:
        raise ValueError(f"frames ({f_total}) must divide over the mesh ({d})")
    chunk = f_total // d
    sh = frame_sharding(mesh, axis)
    shards = zip(*(sh.put(a) for a in (points, points_mask, ground_mask,
                                       transforms, ng_xyz, ng_entropy,
                                       labels, ng_mask)))
    out = []
    for i, shard in enumerate(shards):
        per = [_filter_metrics_frame(*(a[j] for a in shard), i * chunk + j,
                                     seed, ephe_percentile, ransac_iters,
                                     max_clusters)
               for j in range(chunk)]
        out.append({k: torch.stack([m[k] for m in per]) for k in per[0]})
    return {k: _gather(mesh, [o[k] for o in out]) for k in out[0]}
