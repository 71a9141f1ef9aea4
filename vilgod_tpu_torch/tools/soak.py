"""A Waymo-length soak of the port at the bench's full caps; the port of the
JAX package's ``tools/soak_tpu.py``.

    python -m vilgod_tpu_torch.tools.soak                  # the card
    python -m vilgod_tpu_torch.tools.soak --smoke          # the CPU
    python -m vilgod_tpu_torch.tools.soak --out soak.md    # also a report

A Waymo sequence has about 199 frames. The soak runs two such synthetic
sequences (seeds 21, then 22) of the bench's scene shape through stages
1-5 and 7-9 (no classification, as ``soak_tpu.build_cfg`` has them) at the
bench's full caps (``tools/scenes.CAPS``), both in the 200-frame bucket,
and checks what the JAX tool checks:

- no capacity saturates: the clusters used stay below ``max_clusters``,
  the valid tracks above 0 and below ``max_tracks``;
- there are detections in the last 50 frames;
- the second sequence runs warm: where the JAX tool counts no recompile,
  the port's second sequence starts no nvcc build and loads no new kernel
  library (``utils/cuda_build.BUILDS`` and ``LOADS``), and its peak of
  ``torch.cuda.max_memory_allocated`` (reset before each sequence) is
  within 5 % of the first's.

It prints each sequence's wall, frames/s, peak and stage seconds, then one
JSON line; a failed check exits 1. ``--smoke`` runs the JAX tool's smoke
caps and scene (40 frames) on the CPU. Nothing is written unless ``--out``
names a file.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

STAGES = ["mask_ground_points", "calculate_entropy_scores",
          "spatial_clustering", "filter_detections", "track_clusters",
          "fit_bounding_boxes_simple", "propagate_labels",
          "evaluate_sequence"]
# soak_tpu.build_cfg(smoke=True)'s caps
SMOKE_CAPS = {"max_points": 16384, "max_ng_points": 8192, "max_clusters": 64,
              "max_cluster_points": 2048, "max_tracks": 512,
              "max_cluster_input": 8192, "clip_batch": 8}
SMOKE_SCENE = dict(n_ground=2500, n_vehicles=2, n_pedestrians=1, n_moving=1,
                   area=50.0)
# bench.py's scene shape
FULL_SCENE = dict(n_ground=120000, n_vehicles=12, n_pedestrians=6,
                  n_cyclists=4, n_moving=6, area=90.0)
SEEDS = (21, 22)
LATE_FRAMES = 50
PEAK_TOLERANCE = 0.05


def build_cfg(smoke: bool, stages=STAGES):
    """The soak's configuration: stages 1-5 and 7-9 (or ``stages``) at the
    smoke or the bench's full caps."""
    from ..config import waymo_config
    from .scenes import CAPS
    return waymo_config(capacity=SMOKE_CAPS if smoke else CAPS,
                        pipeline_active=list(stages))


def run_sequence(cfg, scene: dict, seed: int, n_frames: int, device) -> dict:
    """One sequence through the runner: the state, the results, the wall
    of ``process`` and of the state's build, the stage seconds, the peak
    memory on the card (None on the CPU) and the builds and library loads
    it started."""
    import torch

    from ..data import SyntheticDataset
    from ..pipeline.runner import ZeroShotDetector
    from ..utils import cuda_build

    seq = SyntheticDataset(n_sequences=1, n_frames=n_frames, seed=seed,
                           **scene).sequence("synth_0")
    for f in range(n_frames):        # making the scene is not the soak
        seq.get_lidar_points(f)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    builds = sum(cuda_build.BUILDS.values())
    loads = sum(cuda_build.LOADS.values())
    t0 = time.perf_counter()
    zsd = ZeroShotDetector(seq, "synth_0", cfg, device=device)
    t1 = time.perf_counter()
    results = zsd.process()
    if cuda:
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t1
    return {"state": zsd.state, "results": results, "wall_s": wall,
            "build_state_s": t1 - t0, "stage_s": dict(zsd.stage_times),
            "peak_bytes": (torch.cuda.max_memory_allocated(device)
                           if cuda else None),
            "builds": sum(cuda_build.BUILDS.values()) - builds,
            "loads": sum(cuda_build.LOADS.values()) - loads}


def capacity_checks(run: dict, n_frames: int) -> dict:
    """The JAX soak's checks on one sequence (AssertionError on a
    failure); returns what they read."""
    state, results = run["state"], run["results"]
    assert len(results) == n_frames, (len(results), n_frames)
    assert state.det_n.max() > 0, "no detections at all"
    clusters = int(state.labels.max()) + 1
    assert clusters < state.caps.max_clusters, "cluster table saturated"
    tracks = len(state.tracks.valid_tracks())
    assert 0 < tracks < state.caps.max_tracks, "track pool saturated"
    late = min(LATE_FRAMES, n_frames)
    dets_late = sum(len(results[f]["boxes_lidar"])
                    for f in range(n_frames - late, n_frames))
    assert dets_late > 0, f"no detections in the final {late} frames"
    raw = state.points_mask.sum(axis=1)
    ng = state._ng_counts
    return {"clusters_used": clusters,
            "max_clusters": state.caps.max_clusters,
            "tracks": tracks, "max_tracks": state.caps.max_tracks,
            "dets_last_frames": dets_late, "last_frames": late,
            "raw_points_mean": float(raw.mean()), "raw_points_max": int(raw.max()),
            "points_bucket": state.points_bucket(),
            "ng_points_mean": float(ng.mean()), "ng_points_max": int(ng.max()),
            "ng_bucket": state.ng_bucket()}


def warm_checks(cold: dict, warm: dict):
    """The stand-in for the JAX soak's "zero recompiles": the second
    same-bucket sequence built and loaded no kernel library, and its peak
    memory on the card is within 5 % of the first's."""
    assert warm["builds"] == 0 and warm["loads"] == 0, (
        f"the warm sequence built {warm['builds']} and loaded "
        f"{warm['loads']} kernel libraries")
    if cold["peak_bytes"] is not None:
        drift = abs(warm["peak_bytes"] - cold["peak_bytes"]) / cold["peak_bytes"]
        assert drift <= PEAK_TOLERANCE, (
            f"peak memory moved {drift:.2%} between same-bucket sequences "
            f"({cold['peak_bytes']} -> {warm['peak_bytes']} bytes)")


def soak(cfg, scene: dict, n_frames: int, device, seeds=SEEDS,
         inspect=None) -> dict:
    """The two sequences and every check; returns the report (the checks
    raise AssertionError). ``inspect(seed, state)``, if given, sees each
    sequence's state before its buffers are dropped (before the next
    sequence's peak is reset)."""
    from .bench import device_name

    runs, checks = [], []
    for seed in seeds:
        run = run_sequence(cfg, scene, seed, n_frames, device)
        checks.append(capacity_checks(run, n_frames))
        if inspect is not None:
            inspect(seed, run["state"])
        # the next sequence's peak must not hold this one's buffers
        del run["state"], run["results"]
        runs.append(run)
    warm_checks(*runs)
    report = {"device": device_name(device), "frames": n_frames,
              "seeds": list(seeds)}
    for name, run, check in zip(("cold", "warm"), runs, checks):
        report[name] = {
            "wall_s": run["wall_s"], "frames_per_s": n_frames / run["wall_s"],
            "build_state_s": run["build_state_s"],
            "peak_gib": (None if run["peak_bytes"] is None
                         else run["peak_bytes"] / 2 ** 30),
            "builds": run["builds"], "loads": run["loads"],
            "stage_s": run["stage_s"], **check}
    return report


def report_lines(report: dict) -> list[str]:
    """The report as a short markdown table."""
    cold, warm = report["cold"], report["warm"]
    lines = [f"# Soak: {report['frames']} frames, seeds {report['seeds']}, "
             f"{report['device']}", "",
             "| | cold | warm |", "|---|---|---|"]
    for key in ("wall_s", "frames_per_s", "build_state_s", "peak_gib",
                "builds", "loads", "clusters_used", "tracks",
                "dets_last_frames"):
        lines.append(f"| {key} | {cold[key]} | {warm[key]} |")
    for stage in cold["stage_s"]:
        lines.append(f"| {stage} (s) | {cold['stage_s'][stage]:.4f} | "
                     f"{warm['stage_s'].get(stage, 0.0):.4f} |")
    return lines


def main(argv=None) -> int:
    from ..utils.common import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="the smoke caps and scene, on the CPU")
    ap.add_argument("--frames", type=int, default=None,
                    help="frames a sequence (default 199; --smoke 40)")
    ap.add_argument("--out", default=None,
                    help="also write the report (markdown) to this file")
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.smoke else None)
    n_frames = args.frames or (40 if args.smoke else 199)
    try:
        report = soak(build_cfg(args.smoke),
                      SMOKE_SCENE if args.smoke else FULL_SCENE, n_frames,
                      device)
    except AssertionError as e:
        print(f"# soak failed: {e}", file=sys.stderr)
        return 1
    lines = report_lines(report)
    print("\n".join(lines))
    if args.out:
        Path(args.out).write_text("\n".join(lines) + "\n")
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
