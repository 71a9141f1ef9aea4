"""The readings the limits of ``correct`` are set from, on the card: for
each seed, one window sequence of the cell through the program, then the
numbers of the program against the reference and of the control (the
reference in the precision below the configuration's, in the program's
place) against the reference, and of the weaker control that takes only
the tower's products in fp8. All seeds run in one process; the
benchmark's own runs never run a control.

    python3 -m benchmark.calibrate --workload waymo.urban --seeds 1,2,3 \
        --controls 1,2

Prints one JSON line a seed; a limit lies above every program reading
and below every control reading (``limits/<config>.json``). Exits 2
without a card.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--controls", default="",
                    help="the seeds whose controls are read too")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("# no card", file=sys.stderr)
        return 2

    from . import check, harness
    device = torch.device("cuda:0")
    controls = {int(s) for s in args.controls.split(",") if s}
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = harness.run(args.workload, seed, 0.0, False, "cuda:0")
        rec, config = out["rec"], out["config"]
        frames = sum(s["frames"] for s in rec.sequences)
        del out["clip"]
        gc.collect()
        torch.cuda.empty_cache()
        line = {"workload": args.workload, "seed": seed,
                "frames_per_s": frames / out["window_s"],
                "launches": {k: v for k, v in out["launches"].items() if v}}
        info = {}
        runs = [("program", False)]
        if seed in controls:
            runs += [("control", True), ("control_operands", "operands")]
        for name, control in runs:
            line[name] = check.readings(rec.sequences, out["seqs"], config,
                                        seed, device, control=control,
                                        info=info)
        line["info"] = info
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        del out, rec
        gc.collect()
    return 0


if __name__ == "__main__":
    sys.exit(main())
