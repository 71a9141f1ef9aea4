"""Run one cell of ``BENCHMARK.json`` on one NVIDIA H100.

    python3 -m benchmark.run --workload waymo.urban --seed 1 --seconds 10 \
        --trace 0

Prints the traffic's proof, the traced pass's overhead and each number
of ``correct`` beside its limit on standard error (those last), and as
the last line of standard output one JSON object: ``correct``,
``attempted`` and ``failed`` (frames), ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` ``breakdown``, and ``checks`` last. Exits 2 without a card
(or with fewer than the cell asks for) and 3 if JAX or the JAX package
was loaded, printing no result either way.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CHECKOUT = ROOT.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "vilgod_tpu")


def _caches():
    """The build and kernel caches at fixed paths inside the checkout."""
    build = CHECKOUT / "build"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared as whole names."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def log(*parts):
    print("#", *parts, file=sys.stderr, flush=True)


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", "0"], capture_output=True,
            text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def metrics_of(manifest: dict, cell: str, trace: bool) -> list[dict]:
    group = manifest["per_layer" if trace else "end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def proof(out: dict) -> None:
    """The traffic's proof: kernel launches, shape buckets, cap use."""
    rec, caps = out["rec"], out["config"]["capacity"]
    log("launches", json.dumps(out["launches"]))
    seqs = rec.sequences
    log("ng_bucket", [s["ng_bucket"] for s in seqs],
        "| raw points max", max(s["raw_points_max"] for s in seqs), "of",
        caps["max_points"],
        "| non-ground max", max(s["ng_points_max"] for s in seqs), "of",
        caps["max_ng_points"],
        "| clusters a frame max", max(s["det_n_max"] for s in seqs), "of",
        caps["max_clusters"],
        "| cluster points max", max(s["cluster_points_max"] for s in seqs),
        "of", caps["max_cluster_points"], "(clusters over it:",
        sum(s["clusters_over_cap"] for s in seqs), ")",
        "| tracks max", max(s["tracks_used"] for s in seqs), "of",
        caps["max_tracks"])
    log("set-up: process age at each step's end (s)",
        json.dumps(out["setup_parts"]), "| window opened at", out["setup_s"])
    log("cuda_build.BUILDS at set-up", out["builds_setup"],
        "| in the window: builds", out["window_builds"], "loads",
        out["window_loads"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()

    manifest = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    entry = {w["name"]: w for w in manifest["workloads"]}[args.workload]
    # the frames are made in worker processes while torch loads
    from . import cell, scenes
    workload = cell.load(args.workload)[0]
    pending = scenes.start_sequences(workload["scene"], args.seed,
                                     workload["sequences"])
    try:
        import torch
        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < entry["chips"]):
            log("no card, or fewer cards than the cell's", entry["chips"])
            pending.close()
            return 2
        from . import check, harness, trace as tr
        from .flops import peaks
        from .metrics import read
    except BaseException:
        pending.close()
        raise

    out = harness.run(args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda:0", pending=pending)
    rec = out["rec"]
    log("card", card_line())
    proof(out)
    frames = sum(s["frames"] for s in rec.sequences)
    kind = torch.cuda.get_device_name(0)
    ctx = dict(frames=frames, window_s=out["window_s"],
               setup_s=out["setup_s"], peak_bytes=rec.peak_bytes,
               stage_s={}, tower=out["config"]["clip"], peak=peaks(kind),
               images_needed=check.NUM_VIEWS * sum(
                   len(s["classified"]) for s in rec.sequences),
               trace=None)
    for s in rec.sequences:
        for k, v in s["stage_times"].items():
            ctx["stage_s"][k] = ctx["stage_s"].get(k, 0.0) + v
    log("window", f"{ctx['window_s']:.3f} s (the check's copies, "
        f"{rec.observe_s:.3f} s, left out)", "sequences",
        len(rec.sequences), "frames", frames, "stage seconds",
        json.dumps(ctx["stage_s"]))
    device = {"platform": "gpu", "kind": kind, "count": 1,
              "memory_peak_bytes": rec.peak_bytes}
    result = {}
    if args.trace:
        traced = out.pop("traced")
        untraced = sum(rec.sequences[0]["stage_times"].values())
        ctx["trace"] = tr.summarize(traced, out["config"]["clip"], ctx["peak"])
        t = ctx["trace"]
        log("traced sequence", f"{traced['wall_s']:.3f} s against "
            f"{untraced:.3f} s untraced (overhead "
            f"{100 * (traced['wall_s'] / untraced - 1):.1f} %)",
            "| stage markers", t["stage_marks"], "| kernel 5 launches",
            traced["k5_launches"], "for", len(traced["classifier_items"]),
            "classifier calls")
        device.update(busy_s=t["busy_s"], window_s=t["window_s"])
        top = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:10]  # noqa
        result["breakdown"] = {
            "device_ops": [[k, v] for k, v in top(t["device_ops"])],
            "idle_gaps": [[k, v] for k, v in top(t["idle_by_stage"])]}
    metrics = {}
    for m in metrics_of(manifest, args.workload, bool(args.trace)):
        v = read(m["name"], ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    # the program's state is gone with the window; its model goes now
    del out["clip"]
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    info = {}
    values = check.readings(rec.sequences, out["seqs"], out["config"],
                            args.seed, torch.device("cuda:0"), info=info)
    log("reference", f"{time.perf_counter() - t0:.3f} s", "| saw",
        json.dumps(info))
    correct, checks = check.judge(values, out["limits"])

    found = forbidden_modules()
    if found:
        log("loaded, and never allowed:", found)
        return 3
    for k, v in checks.items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    line = {"correct": correct, "attempted": frames, "failed": 0,
            "metrics": metrics, "device": device, **result,
            "checks": checks}
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
