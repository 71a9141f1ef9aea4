"""Runs the clustering stage's internals one step at a time on synthetic
non-ground buffers; the port of the JAX package's
``tools/debug_cluster_stepwise.py``.

    python -m vilgod_tpu_torch.tools.debug_cluster_stepwise [--frames 200]
        [--ballast GB] [--async]
    python -m vilgod_tpu_torch.tools.debug_cluster_stepwise --device cpu \\
        --frames 8 --n-ng 2048

The buffers are the JAX tool's: ``default_rng(0)``, each frame a dozen
blobs of 2000 points plus a uniform background on the 5 mm lattice, 33000
occupied of 40960 (``--n-ng`` scales all three), random entropy. The
steps: upload -> ``frame_select_stats_all`` -> ``cluster_frames_chunk``
for each chunk of 32 frames (the stage's ``chunk_starts``) -> the concat
of the 6 outputs -> pack + download, each timed on the host clock with a
``torch.cuda.synchronize`` after it where the JAX tool blocked or forced a
one-element download. ``--async`` drops the sync after each chunk (the
chunks still sync where they read a window's overflow flag on the host);
``--ballast GB`` first allocates a resident tensor of that size on the
device. On the card this splits the clustering stage's wall, which runs
at several times its device time, into its steps. The first line is the
card's name and power limit (``cpu`` on the CPU); the last ``det_n
total``. Runs on ``cuda`` unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

N_NG = 40960
OCCUPIED = 33000
BLOBS, BLOB_POINTS = 12, 2000
SEED = 666
# the clustering stage's arguments at the bench's caps
CHUNK_KW = dict(n_frames_window=2, eps=0.15, min_samples=5,
                min_cluster_size=15, prob_threshold=0.3,
                ephe_percentile=30.0, ephe_min_score=0.5, max_clusters=256,
                capacity=4096)


def step(label: str, fn, device, wait: bool = True, width: int = 40):
    """Runs ``fn``, then (with ``wait``) waits for the device; prints and
    returns (output, seconds)."""
    from .microbench import sync

    t0 = time.perf_counter()
    out = fn()
    if wait:
        sync(device)
    seconds = time.perf_counter() - t0
    print(f"  {label:{width}s} {seconds:8.2f} s", flush=True)
    return out, seconds


def make_buffers(frames: int, n_ng: int = N_NG):
    """The JAX tool's numpy non-ground buffers: (xyz (F, n_ng, 3), mask,
    entropy (F, n_ng), frame_valid (F,)); occupancy and blob sizes scale
    with ``n_ng``."""
    occ = OCCUPIED * n_ng // N_NG
    blob = BLOB_POINTS * n_ng // N_NG
    rng = np.random.default_rng(0)
    ng = np.zeros((frames, n_ng, 3), np.float32)
    msk = np.zeros((frames, n_ng), bool)
    for f in range(frames):
        pts = []
        for _ in range(BLOBS):
            c = rng.uniform(-40, 40, 3) * np.array([1, 1, 0.02])
            pts.append(c + rng.normal(scale=0.5, size=(blob, 3)))
        pts.append(rng.uniform(-45, 45, size=(occ - BLOBS * blob, 3)))
        p = np.concatenate(pts).astype(np.float32)
        p = (np.round(p / 0.005) * 0.005).astype(np.float32)
        ng[f, :occ] = p
        msk[f, :occ] = True
    ent = rng.uniform(0, 1, (frames, n_ng)).astype(np.float32)
    return ng, msk, ent, np.ones(frames, bool)


def run(frames: int = 200, n_ng: int = N_NG, sync_each: bool = True,
        ballast_gb: float | None = None, device=None) -> dict:
    """The steps; returns {steps: [(label, seconds)], det_n: the chunks'
    det_n (chunk, max_clusters) tensors, det_n_total}."""
    from ..pipeline.stages_geometry import (chunk_starts, cluster_frames_chunk,
                                            frame_select_stats_all)
    from ..utils.common import resolve_device
    from .bench import device_name

    device = resolve_device(device)
    print(device_name(device), flush=True)
    print(f"# device={device.type} frames={frames}", flush=True)
    host = make_buffers(frames, n_ng)
    steps = []

    def timed(label, fn, wait=True):
        out, seconds = step(label, fn, device, wait)
        steps.append((label, seconds))
        return out

    dev_args = timed("upload", lambda: tuple(torch.from_numpy(a).to(device)
                                             for a in host))
    stats = timed("frame_select_stats_all",
                  lambda: frame_select_stats_all(*dev_args))
    chunk = min(frames, 32)
    resident = None
    if ballast_gb is not None:
        # a resident set the size of the soak's (raw points, non-ground
        # buffers, masks): a failure only under it is memory, not a kernel
        resident = timed("ballast", lambda: torch.ones(
            int(ballast_gb * (1 << 30) / 4), dtype=torch.float32,
            device=device))
    outs = [timed(f"cluster_frames_chunk f0={f0}",
                  lambda f0=f0: cluster_frames_chunk(
                      *dev_args, stats, f0, SEED, chunk=chunk, cap_in=n_ng,
                      **CHUNK_KW), wait=sync_each)
            for f0 in chunk_starts(frames, chunk)]
    stacked = timed("concat 6 outputs",
                    lambda: [torch.cat([o[i] for o in outs])
                             for i in range(6)])
    det = timed("pack + download", lambda: stacked[2].cpu().numpy())
    del resident
    total = int(det.sum())
    print(f"# OK: det_n total={total}", flush=True)
    return {"steps": steps, "det_n": [o[2] for o in outs],
            "det_n_total": total}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--n-ng", type=int, default=N_NG,
                    help="non-ground points a frame (and the page size)")
    ap.add_argument("--ballast", type=float, default=None, metavar="GB",
                    help="allocate a resident tensor of GB on the device")
    ap.add_argument("--async", dest="sync_each", action="store_false",
                    help="no sync after each chunk")
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)
    run(args.frames, args.n_ng, args.sync_each, args.ballast, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
