"""Times the ground stage's parts as the frame count grows; the port of the
JAX package's ``tools/debug_ground_scale.py``.

    python -m vilgod_tpu_torch.tools.debug_ground_scale [--fpads 24,48,64]
    python -m vilgod_tpu_torch.tools.debug_ground_scale --device cpu \\
        --fpads 2,4 --points 4096

The soak's scene (seed 21, bench.py's scene shape) cut to its raw bucket
of 139264 points a frame. For each ``f_pad`` it times, cold (the first
call at that shape) and warm, each between ``torch.cuda.synchronize``
calls where the JAX tool forced a one-element download:

- presort: the batched patch ordering of every frame
  (``ground/patchwork._presort_frames``);
- scan: the state-threaded scan alone over the presorted frames
  (``_scan_presorted``, one chain);
- fused: the whole ``segment_sequence``.

On the card the scan is a host loop of one step a frame, each step some
hundred small launches, so its time is the host's and should grow
linearly with ``f_pad``; a superlinear row is the finding this tool
exists for. The presort and the scan run on frames moved by the ground
stage's z offset (1.723 m), as ``segment_sequence`` moves them, so the
scan's masks equal the fused run's (the tool checks it); the JAX tool
presorted and scanned the raw frames. The first line is the card's name
and power limit (``cpu`` on the CPU). Runs on ``cuda`` unless
``--device cpu``.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

N_POINTS = 139264           # the soak scene's raw bucket
FPADS = (24, 48, 64)
SEED = 21
Z_OFFSET = 1.723


def scene_frames(n_frames: int, n_points: int = N_POINTS, scene=None,
                 seed: int = SEED):
    """(points (F, N, 4) f32, mask (F, N)) of the soak's scene (``scene``:
    ``SyntheticDataset`` arguments, default the soak's), each frame cut to
    its first ``n_points`` points."""
    from ..data import SyntheticDataset
    from .soak import FULL_SCENE

    seq = SyntheticDataset(n_sequences=1, n_frames=n_frames, seed=seed,
                           **(scene or FULL_SCENE)).sequence("synth_0")
    pts = np.zeros((n_frames, n_points, 4), np.float32)
    msk = np.zeros((n_frames, n_points), bool)
    for f in range(n_frames):
        p = seq.get_lidar_points(f)
        n = min(len(p), n_points)
        pts[f, :n] = p[:n, :4]
        msk[f, :n] = True
    return pts, msk


def _cold_warm(fn, device):
    """(output, cold seconds, warm seconds) of two synchronised calls."""
    from .microbench import sync

    seconds = []
    for _ in range(2):
        sync(device)
        t0 = time.perf_counter()
        out = fn()
        sync(device)
        seconds.append(time.perf_counter() - t0)
    return out, *seconds


def run(fpads=FPADS, n_points: int = N_POINTS, device=None, scene=None):
    """Times the three parts at each ``f_pad`` on :func:`scene_frames`;
    returns (rows, masks): a row per ``f_pad`` (seconds; ``*_cold`` the
    first call) and the fused run's ground masks (f_pad, N) by ``f_pad``."""
    from ..ground.patchwork import (GroundConfig, _presort_frames,
                                    _scan_presorted, segment_sequence)
    from ..utils.common import resolve_device
    from .bench import device_name

    device = resolve_device(device)
    print(device_name(device), flush=True)
    pts, msk = scene_frames(max(fpads), n_points, scene)
    gcfg = GroundConfig()
    rows, masks = [], {}
    for fp in fpads:
        p_d = torch.from_numpy(pts[:fp]).to(device)
        m_d = torch.from_numpy(msk[:fp]).to(device)
        p_z = p_d.clone()
        p_z[..., 2] -= Z_OFFSET
        row = {"f_pad": fp}
        pre, row["presort_cold_s"], row["presort_s"] = _cold_warm(
            lambda: _presort_frames(p_z, m_d, gcfg), device)
        scanned, row["scan_cold_s"], row["scan_s"] = _cold_warm(
            lambda: _scan_presorted(p_z, m_d, pre, gcfg, 1)[0], device)
        del pre, p_z
        ground, row["fused_cold_s"], row["fused_s"] = _cold_warm(
            lambda: segment_sequence(p_d, m_d, gcfg, Z_OFFSET)[0], device)
        if not torch.equal(scanned, ground):
            raise AssertionError(f"f_pad={fp}: the scan's masks differ from "
                                 f"segment_sequence's on "
                                 f"{int((scanned != ground).sum())} points")
        row["ground_points"] = int(ground.sum())
        masks[fp] = ground
        rows.append(row)
        print(f"f_pad={fp:4d}: presort {row['presort_s'] * 1e3:8.1f} ms "
              f"(cold {row['presort_cold_s']:6.1f} s)  scan "
              f"{row['scan_s'] * 1e3:9.1f} ms (cold {row['scan_cold_s']:6.1f} "
              f"s)  fused {row['fused_s'] * 1e3:9.1f} ms (cold "
              f"{row['fused_cold_s']:6.1f} s)", flush=True)
    return rows, masks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fpads", default=",".join(map(str, FPADS)),
                    help="frame counts, comma-separated")
    ap.add_argument("--points", type=int, default=N_POINTS,
                    help="points a frame (the raw bucket)")
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)
    run(tuple(int(x) for x in args.fpads.split(",")), args.points,
        args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
