#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (vilgod_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. device: the card's name and power limit; build the CUDA kernels of
   vilgod_tpu_torch/csrc/ with nvcc for sm_90a (timed);
2. card against CPU, first half: the first 4 frames of the scene below on
   the card (this run also warms the CUDA context up for phase 3);
3. the main path: ground -> entropy -> clustering through
   ``run_sequences`` on one 24-frame sequence of the bench's parity scene
   at the bench's full caps (paged clustering, 24 pages x 40960). Launch
   counts are zeroed just before and read just after; every kernel of the
   path must have launched;
4. kernels against their plain PyTorch versions on the card, on the
   arguments the main path gave them (captured in phase 3) and on a
   forced full-width (overflow) call each: counts, labels and indices
   equal, squared distances bitwise equal; kernel, plain and bound times;
5. card against CPU, second half: the same 4 frames by the port on the
   CPU (the plain versions); ground mask, labels, det_n and det_static
   equal, det_center within 1e-4 m.

The line before the last is the kernels JSON; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

SCENE = dict(n_sequences=1, seed=7, n_frames=24, n_ground=120000,
             n_vehicles=12, n_pedestrians=6, n_cyclists=4, n_moving=6,
             area=90.0)
CAPS = {"max_points": 196608, "max_ng_points": 131072, "max_clusters": 256,
        "max_cluster_points": 4096, "max_tracks": 1024,
        "max_cluster_input": 65536, "clip_batch": 64}
STAGES = ["mask_ground_points", "calculate_entropy_scores",
          "spatial_clustering"]
CHECK_FRAMES = 4
REPLACES = {
    "banded_tile_count": "vilgod_tpu/ops/pallas_kernels.py:331",
    "banded_tile_count3": "vilgod_tpu/ops/pallas_kernels.py:371",
    "banded_tile_min_label": "vilgod_tpu/ops/pallas_kernels.py:412",
    "banded_tile_nearest": "vilgod_tpu/ops/pallas_kernels.py:463",
}
# float32 operations per (query, window point) pair: (q - d) and its square
# per coordinate, the coordinate sums, then each kernel's epilogue
EPILOGUE_OPS = {"banded_tile_count": 1, "banded_tile_count3": 3,
                "banded_tile_min_label": 2, "banded_tile_nearest": 1}


def log(msg):
    print(msg, flush=True)


class FirstFrames:
    """The first ``n`` frames of a sequence source (the same scene, not a
    shorter scene: a synthetic scene's motion depends on its length)."""

    def __init__(self, source, n):
        self.source, self.sequence_length = source, n

    def get_lidar_points(self, fnr):
        return self.source.get_lidar_points(fnr)

    def get_pose(self, fnr):
        return self.source.get_pose(fnr)


# argument positions of each wrapper (as ops/banded.py calls them)
POS = {
    "banded_tile_count": dict(q=0, d=1, starts=2, tq=4, w=5, ndim=6),
    "banded_tile_count3": dict(q=0, d=1, starts=2, tq=4, w=5, ndim=6),
    "banded_tile_min_label": dict(q=0, r2=1, lab=2, starts=3, tq=4, w=5,
                                  ndim=6),
    "banded_tile_nearest": dict(q=0, d=1, starts=2, tq=3, w=4, ndim=5),
}
OUT_BYTES = {"banded_tile_count": 4, "banded_tile_count3": 12,
             "banded_tile_min_label": 4, "banded_tile_nearest": 8}


class Recorder:
    """Keeps, per kernel wrapper, the arguments of its largest banded call
    (window narrower than the data) while ``active``, with the true end of
    each query block's candidate span where ``block_windows`` gave the
    window starts (the data-dependent work of the call)."""

    def __init__(self, kernels, window_modules):
        self.active, self.calls, self.spans = False, {}, {}
        for name in kernels.KERNEL_NAMES:
            setattr(kernels, name, self._wrap(name, getattr(kernels, name)))
        for mod in window_modules:
            mod.block_windows = self._record_spans(mod.block_windows)

    def _record_spans(self, fn):
        def wrapper(*args, **kwargs):
            starts, ends, ovf = fn(*args, **kwargs)
            if self.active:
                # keyed by identity; holding `starts` keeps its id unique
                self.spans[id(starts)] = (starts, ends)
            return starts, ends, ovf
        return wrapper

    def _wrap(self, name, fn):
        pos = POS[name]

        def wrapper(*args):
            if self.active:
                q, w = args[pos["q"]], args[pos["w"]]
                n_d = args[pos.get("d", pos["q"])].shape[1]
                key = (w < n_d, q.shape[1] * w)
                if name not in self.calls or key > self.calls[name][0]:
                    starts = args[pos["starts"]]
                    span = self.spans.get(id(starts))
                    ends = span[1] if span and span[0] is starts else None
                    self.calls[name] = (key, args, ends)
            return fn(*args)
        wrapper.wrapped = fn
        return wrapper


def cuda_ms(fn, reps):
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def full_width_args(name, args, m):
    """The same pass over the first ``m`` sorted ranks at full width
    (starts 0, w = m): the overflow re-run of the main path."""
    import torch
    pos, a = POS[name], list(args)
    for k in ("q", "d"):
        if k in pos:
            a[pos[k]] = args[pos[k]][:, :m].contiguous()
    for k in ("r2", "lab"):
        if k in pos:
            a[pos[k]] = args[pos[k]][:m].contiguous()
    a[pos["starts"]] = torch.zeros(m // args[pos["tq"]], dtype=torch.int32,
                                   device=args[0].device)
    a[pos["w"]] = m
    return tuple(a)


def pairs_needed(args, pos, ends):
    """(query, data point) pairs this call's data needs: per query block,
    the window rows up to the block's true candidate end (points past it
    lie beyond CELL and change no count, label or in-radius nearest);
    the whole window where the span is unknown."""
    n_q, tq, w = args[pos["q"]].shape[1], args[pos["tq"]], args[pos["w"]]
    if ends is None:
        return n_q * w
    span = (ends - args[pos["starts"]]).clamp(0, w)
    return int(span.sum()) * tq


def check_kernel(name, args, kernels, m, ends=None):
    """Kernel vs plain version on the main path's ``args`` and on a forced
    full-width call over the first ``m`` ranks; times and bound. Returns
    the JSON row (launches filled in by the caller)."""
    import torch

    kernel = getattr(kernels, name).wrapped
    plain = kernels.PLAIN[name]

    def outs(f, a):
        out = f(*a)
        return out if isinstance(out, tuple) else (out,)

    def compare(a):
        got, want = outs(kernel, a), outs(plain, a)
        torch.cuda.synchronize()
        err = 0.0
        for g, w in zip(got, want):
            # bitwise: float32 compared as its bits
            same = (torch.equal(g.view(torch.int32), w.view(torch.int32))
                    if g.dtype == torch.float32 else torch.equal(g, w))
            if not same:
                raise AssertionError(f"{name}: kernel != plain version "
                                     f"({int((g != w).sum())} of {g.numel()})")
            err = max(err, float((g.double() - w.double()).nan_to_num(0.0)
                                 .abs().max()))
        return err

    err = max(compare(args), compare(full_width_args(name, args, m)))
    ms = cuda_ms(lambda: kernel(*args), 5)
    plain_ms = cuda_ms(lambda: plain(*args), 1)

    pos = POS[name]
    n_q, w, ndim = args[pos["q"]].shape[1], args[pos["w"]], args[pos["ndim"]]
    n_d = args[pos["d"]].shape[1] if "d" in pos else 0
    pairs = pairs_needed(args, pos, ends)
    ops = pairs * (3 * ndim - 1 + EPILOGUE_OPS[name])
    in_bytes = (4 * ndim * (n_q + n_d) + 4 * args[pos["starts"]].numel()
                + (8 * n_q if "r2" in pos else 0))
    t_ops = ops / PEAK_FP32_FLOPS * 1e3
    t_bytes = (in_bytes + OUT_BYTES[name] * n_q) / PEAK_HBM_BYTES * 1e3
    return {"name": name, "route": "cuda",
            "source": "vilgod_tpu_torch/csrc/banded.cu",
            "replaces": REPLACES[name], "launches": 0, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None,
            "shape": {"n_q": n_q, "n_d": n_d or n_q, "w": w, "ndim": ndim,
                      "pairs_scanned": n_q * w, "pairs_needed": pairs,
                      "full_width_check_cols": m}}


def run_detector(source, cfg, device):
    from vilgod_tpu_torch.pipeline.runner import ZeroShotDetector
    zsd = ZeroShotDetector(source, "synth_0", cfg, device=device)
    zsd.process()
    return zsd.state, zsd.stage_times


def profile_main_path(ds, cfg):
    """The main path's stages once more under torch.profiler: the card's
    busy share of the stage wall time and the kernels that fill it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from vilgod_tpu_torch.pipeline.runner import ZeroShotDetector

    zsd = ZeroShotDetector(ds.sequence("synth_0"), "synth_0", cfg,
                           device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        zsd.process()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    # the kernels themselves (the CPU ops that launched them carry the same
    # device time again)
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA") and dev_us(e) > 0]
    busy_s = sum(dev_us(e) for e in events) / 1e6
    top = sorted(events, key=dev_us, reverse=True)[:8]
    return {"wall_s": wall, "device_busy_s": busy_s,
            "device_busy_share": busy_s / wall if busy_s else None,
            "top": [{"name": e.key[:60], "ms": dev_us(e) / 1e3,
                     "calls": e.count} for e in top]}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the port on "
              "the card", file=sys.stderr)
        return 2
    import numpy as np
    from vilgod_tpu_torch.config import waymo_config
    from vilgod_tpu_torch.data import SyntheticDataset
    from vilgod_tpu_torch.ops import cluster, entropy, kernels, neighbors
    from vilgod_tpu_torch.pipeline.runner import run_sequences
    from vilgod_tpu_torch.pipeline.state import Capacity, SequenceState

    # ---- 1. device and build ----
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    lib_path = kernels.build_library()
    kernels.load_library()
    log(f"build: {time.perf_counter() - t0:.2f} s -> {lib_path.name}")
    ptxas = lib_path.with_suffix(".log")
    if ptxas.exists():
        text = ptxas.read_text()
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
        spills = [int(b) for b in re.findall(r"(\d+) bytes spill stores", text)]
        log(f"ptxas: {len(regs)} kernels, max {max(regs, default=0)} "
            f"registers, {sum(spills)} bytes spilled")

    cfg = waymo_config(capacity=CAPS, pipeline_active=STAGES)
    ds = SyntheticDataset(**SCENE)
    first = FirstFrames(ds.sequence("synth_0"), CHECK_FRAMES)

    # ---- 2. card half of the card-vs-CPU check (also the warm-up) ----
    t0 = time.perf_counter()
    card_state, _ = run_detector(first, cfg, "cuda")
    log(f"card run of the first {CHECK_FRAMES} frames: "
        f"{time.perf_counter() - t0:.2f} s")

    # ---- 3. the main path ----
    recorder = Recorder(kernels, (cluster, entropy, neighbors))
    torch.cuda.reset_peak_memory_stats()
    times = {}
    with tempfile.TemporaryDirectory(dir=lib_path.parent) as cache:
        kernels.reset_launches()
        recorder.active = True
        t0 = time.perf_counter()
        run_sequences(ds, cfg, cache_dir=cache, stage_times=times,
                      device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        recorder.active = False
        launches = dict(kernels.LAUNCHES)
        st = SequenceState.allocate("synth_0", SCENE["n_frames"],
                                    Capacity.from_cfg(cfg), device="cpu")
        assert st.load(Path(cache) / "synth_0.npz"), "no checkpoint written"
    n_frames = SCENE["n_frames"]
    stage_s = sum(times.values())
    dets = (st.det_n > 0).sum(axis=1)
    log("main path: " + json.dumps({
        "frames": n_frames, "wall_s": wall, "stage_s": times,
        "frames_per_s": n_frames / stage_s,
        "detections_per_frame": dets.tolist(),
        "ground_points_per_frame": float(st.ground_mask.sum() / n_frames),
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "launches": launches}))
    for name in kernels.KERNEL_NAMES:
        if launches[name] <= 0:
            raise AssertionError(f"{name} never launched on the main path")
    if not (set(times) == set(STAGES) and dets.min() > 0
            and np.isfinite(st.det_center).all()):
        raise AssertionError("main path output malformed")

    log("profile: " + json.dumps(profile_main_path(ds, cfg)))

    # ---- 4. kernels against their plain versions ----
    rows = []
    for name in kernels.KERNEL_NAMES:
        if name not in recorder.calls:
            raise AssertionError(f"{name}: no main-path call recorded")
        _, args, ends = recorder.calls[name]
        cols = min(args[0].shape[1], 4 * 40960) // 2048 * 2048
        row = check_kernel(name, args, kernels, cols, ends)
        row["launches"] = launches[name]
        rows.append(row)
        log(f"kernel {name}: " + json.dumps(row))
    recorder.calls.clear()
    recorder.spans.clear()

    # ---- 5. CPU half of the card-vs-CPU check ----
    t0 = time.perf_counter()
    cpu_state, _ = run_detector(first, cfg, "cpu")
    log(f"CPU run of the first {CHECK_FRAMES} frames: "
        f"{time.perf_counter() - t0:.2f} s")
    a, b = card_state, cpu_state
    for field in ("ground_mask", "labels", "det_n", "det_static"):
        if not np.array_equal(getattr(a, field), getattr(b, field)):
            raise AssertionError(f"card != CPU in {field}")
    center_err = float(np.abs(a.det_center - b.det_center).max())
    if center_err > 1e-4:
        raise AssertionError(f"card != CPU det_center: {center_err}")
    log("card vs CPU: " + json.dumps({
        "frames": CHECK_FRAMES, "det_center_max_err_m": center_err,
        "detections": int((a.det_n > 0).sum()), "equal": True}))

    print(smi)
    print(json.dumps({"kernels": [
        {k: v for k, v in r.items() if k != "shape"} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
