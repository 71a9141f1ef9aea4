"""Dissects the clustering stage's windows chunk by chunk on the soak's
state; the port of the JAX package's ``tools/debug_soak_cluster.py``.

    python -m vilgod_tpu_torch.tools.debug_soak_cluster [--frames 200] [--launch]
    python -m vilgod_tpu_torch.tools.debug_soak_cluster --device cpu \\
        --frames 8 --smoke --launch

Stages 1-2 with the soak's configuration (``soak.build_cfg(False)``:
the bench's full caps) over ``--frames`` frames of the soak's scene (seed
21), then, for every chunk of 32 pages the clustering stage runs (its
``chunk_starts``), the window dissection of its paged DBSCAN: the mean
selected points a page (``sel_mean``), the core points after the 3-level
count (``core``), and for four window sets the largest true span of a
block and the overflow flag at the stage's static band width:
``all_TQ`` and ``all_TQH`` (every point against every point at ``TQ``
and ``TQ_HEAVY``), ``core_prop`` (the compacted core points against
themselves: the min-label rounds) and ``core_nearest`` (every point
against the core points: the border attach). A flag that is set sends
that pass to its full-width re-run, and each flag is read on the host
(``ops/cluster.py``'s overflow syncs). ``--launch`` then runs
``cluster_frames_chunk`` on each chunk with a ``torch.cuda.synchronize``
after each. ``--smoke`` takes the soak's smoke caps and scene.

The count takes all six columns (xyz, entropy, frame offset, page), as
the paged DBSCAN does; the JAX tool counted on five, without the page
column. :func:`run` also takes a state that stages 1-2 have already
filled (``chip_smoke.py`` passes the soak's own 200-frame state). The
first line is the card's name and power limit (``cpu`` on the CPU). Runs
on ``cuda`` unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import sys

import torch

SEED = 21
CLUSTER_SEED = 666
MIN_SAMPLES = 5
# the clustering stage's chunk arguments (the soak's caps)
CHUNK_KW = dict(n_frames_window=2, eps=0.15, min_samples=MIN_SAMPLES,
                min_cluster_size=15, prob_threshold=0.3,
                ephe_percentile=30.0, ephe_min_score=0.5, max_clusters=256,
                capacity=4096)


def band_for(n: int, chunk: int) -> int:
    """The paged DBSCAN's static band width for ``n`` points in ``chunk``
    pages (``ops/cluster.dbscan_labels_paged``), cut to the full width."""
    from ..ops.banded import full_width
    from ..ops.kernels import TD

    w = max(8192, -(-int(n // chunk * 0.35) // TD) * TD)
    return min(w, full_width(n))


def dissect(dev_args, stats, f0: int, chunk: int, cap_in: int,
            seed: int = CLUSTER_SEED):
    """One chunk's window dissection: (selected points a page (chunk,),
    core points, {window set: (largest true span, overflow)})."""
    from ..ops.banded import block_windows, banded_radius_count3
    from ..ops.cluster import _core_radii
    from ..ops.kernels import TQ, TQ_HEAVY
    from ..pipeline.stages_geometry import select_cluster_input
    from .debug_band_width import band_inputs, core_levels

    sel = [select_cluster_input(*dev_args, f0 + i, seed, stats, 2, cap_in)
           for i in range(chunk)]
    feats, fmask = (torch.stack(x) for x in list(zip(*sel))[:2])
    pts_t8, cid, msk, invalid = band_inputs(feats, fmask)
    n = cid.shape[0]
    w_band = band_for(n, chunk)
    levels = core_levels(cid.device)
    tq_h, tq_l = min(TQ_HEAVY, n), min(TQ, n)
    s_h, e_h, _ = block_windows(cid, cid, tq_h, w_band, invalid_cid=invalid)
    counts3 = banded_radius_count3(pts_t8, pts_t8, s_h, levels * levels,
                                   tq_h, w_band, ndim=6, ends=e_h)[:n]
    _, core = _core_radii(counts3, msk, levels, levels[2], MIN_SAMPLES)
    # the core compaction of ops/cluster._dbscan_banded
    core_pos = torch.cumsum(core.to(torch.int32), 0, dtype=torch.int32) - 1
    core_src = torch.full((n + 1,), n, dtype=torch.int32, device=cid.device)
    core_src[torch.where(core, core_pos, n).long()] = torch.arange(
        n, dtype=torch.int32, device=cid.device)
    core_src = core_src[:n]
    valid_c = core_src < n
    cid_c = torch.where(valid_c, cid[torch.clamp(core_src, max=n - 1).long()],
                        invalid)
    spans = {}
    for key, (cq, cd, tq) in {"all_TQ": (cid, cid, tq_l),
                              "all_TQH": (cid, cid, tq_h),
                              "core_prop": (cid_c, cid_c, tq_h),
                              "core_nearest": (cid, cid_c, tq_l)}.items():
        st, en, ovf = block_windows(cq, cd, tq, w_band, invalid_cid=invalid)
        spans[key] = (int((en - st).max()), bool(ovf))
    return fmask.sum(dim=1), int(core.sum()), spans


def run(frames: int = 200, launch: bool = False, device=None, state=None,
        smoke: bool = False) -> dict:
    """The dissection of every chunk (and with ``launch`` the chunks' runs)
    on ``state``, else on stages 1-2 over ``frames`` frames of the soak's
    scene. Returns {f_pad, n_ng, cap_in, chunk, w_band, chunks: a row per
    chunk, launch_s: seconds per chunk run}."""
    from ..data import SyntheticDataset
    from ..pipeline.runner import ZeroShotDetector
    from ..pipeline.stages_geometry import (_frame_valid, chunk_starts,
                                            cluster_frames_chunk,
                                            frame_bucket,
                                            frame_select_stats_all)
    from ..utils.common import resolve_device
    from . import soak
    from .bench import device_name
    from .debug_cluster_stepwise import step

    device = resolve_device(device) if state is None else state.torch_device
    print(device_name(device), flush=True)
    if state is None:
        cfg = soak.build_cfg(smoke, soak.STAGES[:2])
        seq = SyntheticDataset(
            n_sequences=1, n_frames=frames, seed=SEED,
            **(soak.SMOKE_SCENE if smoke else soak.FULL_SCENE)
        ).sequence("synth_0")
        for f in range(frames):        # making the scene is not the stages
            seq.get_lidar_points(f)
        zsd = ZeroShotDetector(seq, "synth_0", cfg, device=device)
        step("ground+entropy", zsd.process, device, width=44)
        state = zsd.state
    f_pad, n_ng = frame_bucket(state.n_frames), state.ng_bucket()
    print(f"# f_pad={f_pad} n_ng={n_ng} "
          f"ng_occ_max={int(state._ng_counts.max())}", flush=True)
    dev_args = (state.device("ng_xyz", f_pad, n_ng),
                state.device("ng_mask", f_pad, n_ng),
                state.device("ng_entropy", f_pad, n_ng),
                _frame_valid(state.n_frames, f_pad, device))
    stats, _ = step("frame_select_stats_all",
                    lambda: frame_select_stats_all(*dev_args), device,
                    width=44)
    cap_in = min(65536, max(4096, -(-n_ng // 2048) * 2048))
    chunk = min(f_pad, 32)
    w_band = band_for(chunk * cap_in, chunk)
    print(f"# cap_in={cap_in} chunk={chunk} flat={chunk * cap_in} "
          f"w_band={w_band}", flush=True)
    out = {"f_pad": f_pad, "n_ng": n_ng, "cap_in": cap_in, "chunk": chunk,
           "w_band": w_band, "chunks": [], "launch_s": []}
    for f0 in chunk_starts(f_pad, chunk):
        sel, core, spans = dissect(dev_args, stats, f0, chunk, cap_in)
        out["chunks"].append({"f0": f0, "sel_mean": float(sel.float().mean()),
                              "core": core, "spans": spans})
        print(f"# f0={f0:3d} sel_mean={out['chunks'][-1]['sel_mean']:7.0f} "
              f"core={core} " + " ".join(f"{k}: span={s} ovf={o}"
                                         for k, (s, o) in spans.items()),
              flush=True)
    if launch:
        for f0 in chunk_starts(f_pad, chunk):
            _, seconds = step(
                f"cluster_frames_chunk f0={f0}",
                lambda f0=f0: cluster_frames_chunk(
                    *dev_args, stats, f0, CLUSTER_SEED, chunk=chunk,
                    cap_in=cap_in, **CHUNK_KW), device, width=44)
            out["launch_s"].append(seconds)
        print("# OK", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--launch", action="store_true",
                    help="also run cluster_frames_chunk on each chunk")
    ap.add_argument("--smoke", action="store_true",
                    help="the soak's smoke caps and scene")
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)
    run(args.frames, args.launch, args.device, smoke=args.smoke)
    return 0


if __name__ == "__main__":
    sys.exit(main())
