"""Runs stages 1-3 at the full caps over a long sequence; the port of the
JAX package's ``tools/debug_cluster_crash.py``.

    python -m vilgod_tpu_torch.tools.debug_cluster_crash [--frames 64]
    python -m vilgod_tpu_torch.tools.debug_cluster_crash --device cpu \\
        --frames 8 --smoke

Ground masking, entropy and clustering through ``ZeroShotDetector`` on the
soak's scene (seed 21) at the JAX tool's caps (the bench's full caps with
``clip_batch`` 128): at 64 frames the 64-frame bucket's selection
statistics and two chunks of 32 pages, the shapes where the JAX package's
TPU worker died. It prints the wall of the three stages, each stage's
seconds, ``ng_bucket``, the valid detections (``dets``) and
``labels_max``. ``--smoke`` takes the soak's smoke caps and scene.

The JAX tool's ``--no-pallas`` has no counterpart on the card: running the
plain versions on card tensors would be a fallback that hides the
kernels. The plain versions run under ``--device cpu``. The first line is
the card's name and power limit (``cpu`` on the CPU). Runs on ``cuda``
unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

STAGES = ["mask_ground_points", "calculate_entropy_scores",
          "spatial_clustering"]
# the JAX tool's caps: the bench's full caps, CLIP batches of 128
CAPS = {"max_points": 196608, "max_ng_points": 131072, "max_clusters": 256,
        "max_cluster_points": 4096, "max_tracks": 1024,
        "max_cluster_input": 65536, "clip_batch": 128}
SEED = 21


def run(frames: int = 64, device=None, caps=None, scene=None) -> dict:
    """Stages 1-3 over ``frames`` frames; returns {seconds, stage_s,
    ng_bucket, dets, labels_max}."""
    from ..config import waymo_config
    from ..data import SyntheticDataset
    from ..pipeline.runner import ZeroShotDetector
    from ..utils.common import resolve_device
    from .bench import device_name
    from .microbench import sync
    from .soak import FULL_SCENE

    device = resolve_device(device)
    print(device_name(device), flush=True)
    print(f"# device={device.type} frames={frames}", flush=True)
    cfg = waymo_config(capacity=caps or CAPS, pipeline_active=STAGES)
    seq = SyntheticDataset(n_sequences=1, n_frames=frames, seed=SEED,
                           **(scene or FULL_SCENE)).sequence("synth_0")
    for f in range(frames):        # making the scene is not the stages
        seq.get_lidar_points(f)
    t0 = time.perf_counter()
    zsd = ZeroShotDetector(seq, "synth_0", cfg, device=device)
    zsd.process()
    sync(device)
    st = zsd.state
    out = {"seconds": time.perf_counter() - t0,
           "stage_s": dict(zsd.stage_times), "ng_bucket": st.ng_bucket(),
           "dets": int(st.det_valid.sum()), "labels_max": int(st.labels.max())}
    print("stage seconds: " + json.dumps(out["stage_s"]))
    print(f"# OK in {out['seconds']:.1f}s: ng_bucket={out['ng_bucket']} "
          f"dets={out['dets']} labels_max={out['labels_max']}", flush=True)
    return out


def main(argv=None) -> int:
    from .soak import SMOKE_CAPS, SMOKE_SCENE

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--smoke", action="store_true",
                    help="the soak's smoke caps and scene")
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)
    caps, scene = (SMOKE_CAPS, SMOKE_SCENE) if args.smoke else (None, None)
    run(args.frames, args.device, caps, scene)
    return 0


if __name__ == "__main__":
    sys.exit(main())
