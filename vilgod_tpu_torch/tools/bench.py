"""End-to-end throughput of the port: zero-shot pseudo-labeling frames per
second on one card, with the geometry-only APs beside it.

    python -m vilgod_tpu_torch.tools.bench                 # the card
    python -m vilgod_tpu_torch.tools.bench --scale smoke   # the CPU

The JAX package's ``bench.py`` scene and caps: at full scale two 96-frame
synthetic sequences (seed 7) at the full caps, after an untimed warm-up
scene of the same shape (seed 13), through the port's ``run_sequences``
with a ViT-B/16 ``ClipWrapper`` in bf16 (random weights from seed 0; the
work is a checkpoint's); the best of three timed passes. Then one
geometry-only pass (no CLIP model: size-prior classes) scored against the
synthetic ground truth. ``--scale smoke`` takes bench.py's smoke caps and
scene (one 8-frame sequence, no warm-up, one pass) and a narrow f32 tower,
and runs on the CPU; full scale runs on ``cuda``.

Prints one JSON line with bench.py's fields but ``vs_baseline`` (its
baseline is a TPU's), and ``device``: the card's name and power limit as
nvidia-smi gives them (the CPU: "cpu"). ``delta_ap_max`` is bench.py's
composed reference-parity number: at full scale, untimed, the port's
``tools/parity_oracle.measure_delta_ap`` on bench.py's 24-frame parity
scene (``tools/scenes.SCENE``) at the full caps, its per-class line on
stderr; a failure of that measurement fails the bench (bench.py prints
null instead). At ``--scale smoke`` it is null, as bench.py skips it
there. ``stage_ms_per_frame`` is bench.py's budget: one warm
sequence of the timed scene runs untraced for its wall time, then again
under ``torch.profiler`` with each stage in its span; a stage's row is the
device time that starts inside its span (on the card its kernels, copies
and sets; on the CPU its outermost ATen operators), ``other_device`` the
device time outside every span (the state's build), and
``host_setup_and_gaps`` the rest of the untraced wall (never below 0), so
the rows sum to it unless the traced device time alone exceeds it.
"""
from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import subprocess
import sys
import time

# bench.py's quality bands: the JAX package's geometry-only APs on the
# full-scale scene, +-0.05
FULL_PINS = {"vehicle": 0.4453, "ped": 0.7169, "cyc": 0.3307}
BAND = 0.05
SMOKE_MIN_VEHICLE_AP = 0.2
EVAL_RANGE = (-50.0, -20.0, 50.0, 20.0)
# the smoke scale's tower: narrow, f32 (a ViT-B/16 takes minutes on a CPU)
SMOKE_CLIP = dict(patch_size=32, vision_width=64, vision_layers=2,
                  vision_heads=2, embed_dim=32, text_width=32, text_heads=2,
                  text_layers=2)


def build(scale: str):
    """(config, timed dataset, warm-up dataset or None) of bench.py's
    scale."""
    from ..config import waymo_config
    from ..data import SyntheticDataset

    if scale == "full":
        caps = {"max_points": 196608, "max_ng_points": 131072,
                "max_clusters": 256, "max_cluster_points": 4096,
                "max_tracks": 1024, "max_cluster_input": 65536,
                "clip_batch": 512}
        scene = dict(n_frames=96, n_ground=120000, n_vehicles=12,
                     n_pedestrians=6, n_cyclists=4, n_moving=6, area=90.0)
        n_seqs, warm = 2, SyntheticDataset(n_sequences=1, seed=13, **scene)
    else:
        caps = {"max_points": 16384, "max_ng_points": 8192,
                "max_clusters": 64, "max_cluster_points": 4096,
                "max_tracks": 64, "max_cluster_input": 8192, "clip_batch": 8}
        scene = dict(n_frames=8, n_ground=2500, n_vehicles=2,
                     n_pedestrians=0, n_moving=1)
        n_seqs, warm = 1, None
    ds = SyntheticDataset(n_sequences=n_seqs, seed=7, **scene)
    return waymo_config(capacity=caps), ds, warm


def clip_model_for(scale, cfg, device):
    """The classifier of ``cfg``: at full scale the bf16 tower that its
    ``clip.model_name`` names (``clip.CHECKPOINTS``), else the smoke
    tower in f32; seeded random weights."""
    import torch

    from ..models.clip import CLIPConfig, clip_config_for
    from ..models.clip_wrapper import ClipWrapper
    clip_cfg = cfg["preprocessor"]["clip"]
    model_cfg = (clip_config_for(clip_cfg["model_name"], torch.bfloat16)
                 if scale == "full"
                 else CLIPConfig(**SMOKE_CLIP, dtype=torch.float32))
    return ClipWrapper(clip_cfg, seed=0, model_cfg=model_cfg, device=device)


def pregenerate(ds):
    """Make every synthetic frame before the timed region (scene making is
    data creation, not pipeline work)."""
    for name in ds.sequence_names():
        seq = ds.sequence(name)
        for f in range(seq.sequence_length):
            seq.get_lidar_points(f)


def run(cfg, ds, clip_model, device):
    """(results, wall seconds, frames) of one pass."""
    import torch

    from ..pipeline import run_sequences
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    results = run_sequences(ds, cfg, clip_model=clip_model, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    n_frames = sum(ds.sequence(n).sequence_length
                   for n in ds.sequence_names())
    return results, dt, n_frames


def device_name(device) -> str:
    """The card's name and power limit as nvidia-smi gives them; "cpu"."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i",
                          str(device.index or 0)],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def stage_device_seconds(events, stages, cuda: bool) -> dict:
    """Device seconds by stage from the profiler's raw events
    (``prof.profiler.kineto_results.events()``: a long trace builds no
    ``FunctionEvent`` tree): each piece of device work goes to the stage
    whose span (a ``record_function`` named after it) holds its start,
    else to ``other_device``. The work is the card's kernels, copies and
    sets with ``cuda``, else the outermost ATen operators (the CPU is the
    device)."""
    stages = list(stages)
    spans, work = [], []
    for e in events:
        name, dev = e.name(), str(e.device_type())
        if name in stages or e.is_user_annotation():
            if name in stages and dev.endswith("CPU"):
                spans.append((e.start_ns(), e.end_ns(), name))
        elif dev.endswith("CUDA") if cuda else (
                dev.endswith("CPU") and name.startswith("aten::")):
            work.append((e.start_ns(), e.end_ns()))
    if not cuda:              # an operator inside another is not counted
        outer, end = [], None
        for w in sorted(work, key=lambda w: (w[0], -w[1])):
            if end is None or w[0] >= end:
                outer.append(w)
                end = w[1]
        work = outer
    spans.sort()
    starts = [s[0] for s in spans]
    out = dict.fromkeys(stages, 0.0) | {"other_device": 0.0}
    for t0, t1 in work:
        i = bisect.bisect_right(starts, t0) - 1
        key = spans[i][2] if i >= 0 and t0 <= spans[i][1] else "other_device"
        out[key] += (t1 - t0) / 1e9
    return out


def stage_budget(cfg, ds, clip_model, device):
    """(seconds by row, untraced wall seconds, frames) of bench.py's
    budget over the timed scene's first sequence (module docstring)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..pipeline.runner import ZeroShotDetector
    from ..utils import trace
    name = ds.sequence_names()[0]
    seq = ds.sequence(name)
    cuda = device.type == "cuda"

    def one_seq(recording):
        if cuda:
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        with recording:
            ZeroShotDetector(seq, name, cfg, clip_model=clip_model,
                             device=device).process()
        if cuda:
            torch.cuda.synchronize(device)
        return time.perf_counter() - t0

    warm_wall = one_seq(contextlib.nullcontext())
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    with profile(activities=activities) as prof:
        # the stages' spans as profiler ranges
        one_seq(trace.recording(device=device, profiler_ranges=True))
    rows = stage_device_seconds(prof.profiler.kineto_results.events(),
                                cfg["pipeline_active"], cuda)
    rows["host_setup_and_gaps"] = max(warm_wall - sum(rows.values()), 0.0)
    return rows, warm_wall, seq.sequence_length


def geometry_aps(cfg, ds, device):
    """LEVEL_2 APs (vehicle, pedestrian, cyclist) of one pass without a
    CLIP model, against the scene's ground truth in bench.py's range."""
    from ..eval import evaluate_detections
    results, _, _ = run(cfg, ds, None, device)
    gt = []
    for name in ds.sequence_names():
        seq = ds.sequence(name)
        gt.extend(seq.get_annos(f) for f in range(seq.sequence_length))
    ap = evaluate_detections(results, gt, eval_range=EVAL_RANGE)
    n_det = sum(len(r["boxes_lidar"]) for r in results)
    return [round(float(ap[f"OBJECT_TYPE_TYPE_{c}_LEVEL_2/AP"]), 4)
            for c in ("VEHICLE", "PEDESTRIAN", "CYCLIST")], n_det


def parity_delta_ap(cfg, device) -> float:
    """bench.py's |dAP|: the port's geometry stages feed both its table
    decision stages and the transcribed reference oracle on the 24-frame
    parity scene; prints the per-class line, returns ``delta_ap_max``."""
    from ..data import SyntheticDataset
    from .parity_oracle import measure_delta_ap
    from .scenes import SCENE

    ds = SyntheticDataset(**SCENE)
    out = measure_delta_ap(cfg, ds, ds.sequence_names()[0], device=device)
    print("# parity dAP: " + " ".join(
        f"{c}={v['table']:.3f}/{v['oracle']:.3f}(d={v['delta']:.3f})"
        for c, v in out["per_class"].items())
        + f" n_truncated={out['n_truncated']} dets={out['n_dets_table']}/"
        f"{out['n_dets_oracle']}", file=sys.stderr)
    return out["delta_ap_max"]


def run_bench(scale: str, device) -> dict:
    cfg, ds, warm = build(scale)
    clip_model = clip_model_for(scale, cfg, device)
    if warm is not None:          # every build and first launch untimed
        pregenerate(warm)
        run(cfg, warm, clip_model, device)
    pregenerate(ds)
    passes = 3 if warm is not None else 1
    best = None
    for _ in range(passes):
        out = run(cfg, ds, clip_model, device)
        if best is None or out[1] < best[1]:
            best = out
    results, dt, n_frames = best
    fps = n_frames / dt
    platform = "gpu" if device.type == "cuda" else "cpu"
    print(f"# platform={platform} scale={scale} frames={n_frames} "
          f"sequences={len(ds.sequence_names())} wall={dt:.2f}s "
          f"dets={sum(len(r['boxes_lidar']) for r in results)}",
          file=sys.stderr)
    rows, warm_wall, seq_len = stage_budget(cfg, ds, clip_model, device)
    stage_ms = {k: round(v / seq_len * 1e3, 2) for k, v in rows.items()}
    sum_ms = round(sum(stage_ms.values()), 2)
    print(f"# stage ms/frame (device trace, one warm seq; wall="
          f"{warm_wall / seq_len * 1e3:.2f}): " + " ".join(
              f"{k}={v}" for k, v in sorted(stage_ms.items(),
                                            key=lambda kv: -kv[1]))
          + f" | sum={sum_ms}", file=sys.stderr)

    (vehicle_ap, ped_ap, cyc_ap), n_geo = geometry_aps(cfg, ds, device)
    if scale == "full":
        got = {"vehicle": vehicle_ap, "ped": ped_ap, "cyc": cyc_ap}
        quality_ok = all(abs(got[k] - FULL_PINS[k]) <= BAND
                         for k in FULL_PINS)
    else:
        quality_ok = vehicle_ap >= SMOKE_MIN_VEHICLE_AP
    print(f"# geometry-only: vehicle_ap={vehicle_ap} ped_ap={ped_ap:.4f} "
          f"cyc_ap={cyc_ap:.4f} dets={n_geo} quality_ok={quality_ok}",
          file=sys.stderr)
    delta_ap = None
    if scale == "full":
        delta_ap = parity_delta_ap(cfg, device)
    else:
        print("# delta_ap_max: null at --scale smoke (the port's "
              "tools/parity_oracle.measure_delta_ap runs at full scale)",
              file=sys.stderr)
    return {
        "metric": "e2e_frames_per_sec",
        "value": round(fps, 3),
        "unit": "frames/s",
        "vehicle_ap": vehicle_ap,
        "ped_ap": ped_ap,
        "cyc_ap": cyc_ap,
        "quality_ok": quality_ok,
        "delta_ap_max": delta_ap,
        "platform": platform,
        "stage_ms_per_frame": stage_ms,
        "stage_sum_ms_per_frame": sum_ms,
        "wall_ms_per_frame": round(dt / n_frames * 1e3, 2),
        "device": device_name(device),
    }


def main(argv=None) -> int:
    from ..utils import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", choices=("full", "smoke"), default="full")
    args = ap.parse_args(argv)
    device = resolve_device("cuda" if args.scale == "full" else "cpu")
    print(json.dumps(run_bench(args.scale, device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
