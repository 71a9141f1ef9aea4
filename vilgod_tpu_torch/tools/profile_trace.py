"""Total device time by kernel and operator over one warm sequence of the
main path, from the trace the runner writes with ``profile_dir``; the port
of the JAX package's ``tools/profile_trace.py``.

    python -m vilgod_tpu_torch.tools.profile_trace [--top 40]
    python -m vilgod_tpu_torch.tools.profile_trace --trace run.trace.json
    python -m vilgod_tpu_torch.tools.profile_trace --scale smoke   # the CPU

Without ``--trace`` it runs the main path's scene (``tools/scenes.py``: the
bench's 24-frame parity scene at the bench's full caps, all nine stages,
a ViT-B/16 bf16 ``ClipWrapper`` with random weights from seed 0) once to
warm up, then once more with ``profile_dir`` set (``--trace-dir``, default
``build/profile``), and reads that sequence's
``<profile_dir>/synth_0.trace.json``. It prints the table of total time
by name (the card's kernels, copies and sets; in a trace with none of
those, the CPU run's ATen operators), with launch counts, top N, and a
JSON line last. ``--scale smoke`` runs the bench's smoke scene and caps
with a narrow tower on the CPU.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

# the card's work in a torch.profiler Chrome trace
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
CPU_CATEGORIES = ("cpu_op",)


def aggregate(trace: dict):
    """(rows, categories used): rows are ``(name, total seconds, count)``
    over the trace's complete events of the card's work, or, in a trace
    with none, of the CPU's operators (each operator event, nested ones
    too), largest total first."""
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    categories = DEVICE_CATEGORIES
    if not any(e.get("cat") in categories for e in events):
        categories = CPU_CATEGORIES
    total = defaultdict(float)
    count = defaultdict(int)
    for e in events:
        if e.get("cat") in categories:
            total[e["name"]] += e.get("dur", 0) / 1e6
            count[e["name"]] += 1
    rows = sorted(((n, total[n], count[n]) for n in total),
                  key=lambda r: -r[1])
    return rows, categories


def table_lines(rows, top: int) -> list[str]:
    busy = sum(r[1] for r in rows)
    lines = [f"# {len(rows)} names, {sum(r[2] for r in rows)} events, "
             f"{busy:.4f} s in all",
             f"{'name':96s} {'total_ms':>11s} {'n':>7s} {'share':>7s}"]
    for name, t, n in rows[:top]:
        lines.append(f"{name[:96]:96s} {t * 1e3:11.3f} {n:7d} "
                     f"{100 * t / max(busy, 1e-12):6.2f}%")
    return lines


def trace_warm_sequence(scale: str, trace_dir: Path, device) -> tuple:
    """Run the scale's main path once, then once more with ``profile_dir``;
    returns (trace path, traced wall seconds, frames)."""
    import torch

    from ..pipeline.runner import ZeroShotDetector
    from .bench import clip_model_for, pregenerate
    from .scenes import main_path

    cfg, ds = main_path(scale)
    clip_model = clip_model_for(scale, cfg, device)
    pregenerate(ds)
    name = ds.sequence_names()[0]
    seq = ds.sequence(name)
    ZeroShotDetector(seq, name, cfg, clip_model=clip_model,
                     device=device).process()
    traced = cfg.copy()
    traced["profile_dir"] = str(trace_dir)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    ZeroShotDetector(seq, name, traced, clip_model=clip_model,
                     device=device).process()
    wall = time.perf_counter() - t0
    return trace_dir / f"{name}.trace.json", wall, seq.sequence_length


def main(argv=None) -> int:
    from ..utils.common import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--trace", default=None,
                    help="aggregate this Chrome trace instead of running")
    ap.add_argument("--trace-dir", default="build/profile")
    ap.add_argument("--scale", choices=("full", "smoke"), default="full")
    args = ap.parse_args(argv)
    out = {}
    if args.trace:
        path = Path(args.trace)
    else:
        device = resolve_device("cuda" if args.scale == "full" else "cpu")
        path, wall, frames = trace_warm_sequence(args.scale,
                                                 Path(args.trace_dir), device)
        out.update(traced_wall_s=wall, frames=frames)
        print(f"# traced warm sequence: {wall:.3f} s, "
              f"{wall / frames * 1e3:.2f} ms a frame", flush=True)
    rows, cats = aggregate(json.loads(path.read_text()))
    print("\n".join(table_lines(rows, args.top)))
    out.update(trace=str(path), categories=list(cats),
               busy_s=sum(r[1] for r in rows),
               top=[{"name": n, "total_ms": t * 1e3, "n": c}
                    for n, t, c in rows[:args.top]])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
