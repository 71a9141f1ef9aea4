"""Per-stage wall budget of the main path, one cold and one warm sequence;
the port of the JAX package's ``tools/profile_stages.py``.

    python -m vilgod_tpu_torch.tools.profile_stages                 # the card
    python -m vilgod_tpu_torch.tools.profile_stages --scale smoke   # the CPU

A thin CLI over ``ZeroShotDetector.stage_times``: the runner already
synchronises the card at the end of every stage
(``pipeline/runner.py``), so a stage's seconds hold its device work and
no environment switch is needed. It runs the main path's scene
(``tools/scenes.py``: the bench's 24-frame parity scene at the bench's
full caps, nine stages, a ViT-B/16 bf16 tower with random weights) twice,
the first sequence cold (kernel builds and first launches included), and
prints each stage's seconds and share of the sequence's wall, then a
JSON line. ``--scale smoke`` takes the bench's smoke scene and caps with a
narrow tower, on the CPU.
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def stage_budgets(scale: str, device) -> list[dict]:
    """[{name, wall_s, frames, stage_s}] of the cold and the warm
    sequence."""
    import torch

    from ..pipeline.runner import ZeroShotDetector
    from .bench import clip_model_for, pregenerate
    from .scenes import main_path

    cfg, ds = main_path(scale)
    clip_model = clip_model_for(scale, cfg, device)
    pregenerate(ds)
    name = ds.sequence_names()[0]
    seq = ds.sequence(name)
    budgets = []
    for run in ("cold", "warm"):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        zsd = ZeroShotDetector(seq, name, cfg, clip_model=clip_model,
                               device=device)
        zsd.process()
        budgets.append({"name": run, "wall_s": time.perf_counter() - t0,
                        "frames": seq.sequence_length,
                        "stage_s": dict(zsd.stage_times)})
    return budgets


def budget_lines(budget: dict) -> list[str]:
    wall = budget["wall_s"]
    lines = [f"== {budget['name']}: wall={wall:.3f} s  "
             f"frames/s={budget['frames'] / wall:.3f}"]
    for k, v in sorted(budget["stage_s"].items(), key=lambda kv: -kv[1]):
        lines.append(f"  {k:28s} {v:8.4f} s  {100 * v / wall:5.1f}%")
    return lines


def main(argv=None) -> int:
    from ..utils.common import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", choices=("full", "smoke"), default="full")
    args = ap.parse_args(argv)
    device = resolve_device("cuda" if args.scale == "full" else "cpu")
    budgets = stage_budgets(args.scale, device)
    for b in budgets:
        print("\n".join(budget_lines(b)))
    print(json.dumps({"budgets": budgets}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
