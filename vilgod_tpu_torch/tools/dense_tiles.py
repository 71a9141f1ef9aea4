"""The dense kernels' tile decisions on the dense configuration's own calls.

    python3 -m vilgod_tpu_torch.tools.dense_tiles [--frames 4] [--device cpu]

Runs stages 1-3 of the dense configuration (``tools/scenes.py``: the
bench's parity scene and caps with a 0.5 m entropy radius and a
16000-point cluster input; clustering takes chunks of 8 frames, so fewer
frames leave the rest of the chunk empty) over the first ``--frames``
frames, on the card unless ``--device cpu`` is given, and for every call
of the box-decided dense kernels 6-9 prints one JSON line with the torch
mirror's decisions (``dense_kernels.tile_decisions``): tiles skipped, taken
whole and left to the pair loop, and the share of all (query, data) pairs
inside those. The last line sums each kernel over its calls. The mirror's
arithmetic is the kernels' own, so the decisions do not depend on the
device; on the CPU the kernels run their plain versions (a few minutes for
4 frames).
"""
from __future__ import annotations

import argparse
import inspect
import json


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="the device to run on (default: cuda)")
    args = ap.parse_args(argv)

    from vilgod_tpu_torch.data import SyntheticDataset
    from vilgod_tpu_torch.ops import dense_kernels as dk
    from vilgod_tpu_torch.pipeline.runner import ZeroShotDetector
    from vilgod_tpu_torch.tools.scenes import SCENE, FirstFrames, dense_config
    from vilgod_tpu_torch.utils.common import resolve_device

    device = resolve_device(args.device)
    cfg = dense_config()
    ds = SyntheticDataset(**SCENE)
    totals = {}

    def record(name, q_t8, d_t8, ndim, plan):
        n_q, n_d = q_t8.shape[1], d_t8.shape[1]
        row = {"kernel": name, "n_q": n_q, "n_d": n_d, "ndim": ndim,
               "tiles": plan["skip"].numel(),
               "skipped": int(plan["skip"].sum()),
               "whole": int(plan["whole"].sum()),
               "pairs": int(plan["pairs"].sum()),
               "needed_share": plan["needed_pairs"] / (n_q * n_d)}
        print(json.dumps(row), flush=True)
        tot = totals.setdefault(name, {"calls": 0, "pairs": 0, "needed": 0})
        tot["calls"] += 1
        tot["pairs"] += n_q * n_d
        tot["needed"] += plan["needed_pairs"]

    wrapped = {}

    def spy(name):
        fn = getattr(dk, name)
        wrapped[name] = fn
        sig = inspect.signature(fn)

        def call(*a, **kw):
            bound = sig.bind(*a, **kw)
            bound.apply_defaults()
            v = bound.arguments
            if name == "tile_min_label":
                q_t8 = d_t8 = v["pts_t8"]
                opts = dict(radius2=v["radius2"], labels=v["labels"],
                            big=v["big"])
            else:
                q_t8, d_t8 = v["q_t8"], v["d_t8"]
                opts = {"tile_radius_count": {"r2": v.get("r2")},
                        "tile_radius_count3": {"levels2": v.get("levels2")},
                        "tile_nearest": {"nearest": True}}[name]
            record(name, q_t8, d_t8, v["ndim"],
                   dk.tile_decisions(q_t8, d_t8, v["ndim"], **opts))
            return fn(*a, **kw)
        setattr(dk, name, call)

    for name in ("tile_radius_count", "tile_radius_count3", "tile_min_label",
                 "tile_nearest"):
        spy(name)
    try:
        zsd = ZeroShotDetector(FirstFrames(ds.sequence("synth_0"),
                                           args.frames),
                               "synth_0", cfg, device=device)
        zsd.process()
    finally:
        for name, fn in wrapped.items():
            setattr(dk, name, fn)
    print(json.dumps({"frames": args.frames, "device": str(device),
                      "totals": {k: {**v, "needed_share": v["needed"]
                                     / v["pairs"]}
                                 for k, v in totals.items()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
