#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (vilgod_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. device: the card's name and power limit; build the CUDA sources of
   vilgod_tpu_torch/csrc/ (banded.cu, vit.cu) with nvcc for sm_90a, one
   nvcc each, started together (timed);
2. card against CPU, first half: the first 4 frames of the scene below
   through all five stages on the card, classified by a narrow bf16 tower
   on which the fused attention kernel holds (this run also warms the CUDA
   context up for phase 3);
3. the main path: ground -> entropy -> clustering -> filter ->
   classification through ``run_sequences`` on one 24-frame sequence of the
   bench's parity scene at the bench's full caps (paged clustering, 24 pages
   x 40960; CLIP batches of 512 clusters = 2048 images) with a ViT-B/16
   ``ClipWrapper`` in bf16 (random weights from seed 0). Launch counts are
   zeroed just before and read just after; every kernel of the path must
   have launched, ``fused_attention_proj`` once per vision layer and
   classify call. Then the opt-in MLP kernels: one classify batch of this
   run through the tower with ``VILGOD_FUSED_MLP_BLOCK=1`` and with
   ``VILGOD_FUSED_MLP=1``; each must launch;
4. kernels against their plain PyTorch versions on the card, on the
   arguments the main path gave them (captured in phase 3): the banded
   kernels also on a forced full-width (overflow) call each (counts, labels
   and indices equal, squared distances bitwise equal), the ViT kernels also
   on a ragged batch of 3 images (assert_close rtol 1.6e-2, atol 1e-2, mean
   |diff| < 1e-3); kernel, plain, torch-composite and bound times;
5. card against CPU, second half: the same 4 frames by the port on the CPU
   (the plain versions): ground mask, labels, det_n, det_static and
   det_valid equal, det_center within 1e-4 m, plane_ref within 1e-4, every
   image embedding's cosine with its CPU counterpart >= 0.999, det_cls equal
   on >= 95 % of valid detections.

The line before the last is the kernels JSON; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor cores, dense
# bf16 on the tensor cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

SCENE = dict(n_sequences=1, seed=7, n_frames=24, n_ground=120000,
             n_vehicles=12, n_pedestrians=6, n_cyclists=4, n_moving=6,
             area=90.0)
# the bench's full caps (bench.py:68-75)
CAPS = {"max_points": 196608, "max_ng_points": 131072, "max_clusters": 256,
        "max_cluster_points": 4096, "max_tracks": 1024,
        "max_cluster_input": 65536, "clip_batch": 512}
STAGES = ["mask_ground_points", "calculate_entropy_scores",
          "spatial_clustering", "filter_detections", "classification"]
CHECK_FRAMES = 4
# the card-vs-CPU tower: narrow, bf16, 64-wide heads (the fused path)
CHECK_CLIP = dict(patch_size=32, vision_width=128, vision_layers=2,
                  vision_heads=2, embed_dim=64, text_width=64, text_heads=1,
                  text_layers=2)
REPLACES = {
    "banded_tile_count": "vilgod_tpu/ops/pallas_kernels.py:331",
    "banded_tile_count3": "vilgod_tpu/ops/pallas_kernels.py:371",
    "banded_tile_min_label": "vilgod_tpu/ops/pallas_kernels.py:412",
    "banded_tile_nearest": "vilgod_tpu/ops/pallas_kernels.py:463",
    "fused_attention_proj": "vilgod_tpu/models/vit_kernels.py:193",
    "fused_mlp_block": "vilgod_tpu/models/vit_kernels.py:59",
    "fused_mlp": "vilgod_tpu/models/vit_kernels.py:117",
}
OPT_IN = {"fused_mlp_block": "VILGOD_FUSED_MLP_BLOCK",
          "fused_mlp": "VILGOD_FUSED_MLP"}
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


class VitRecorder:
    """Keeps, per ViT kernel wrapper, the arguments of its largest call
    while ``active``; counts encode_image calls and images; keeps the
    largest tower input and each call's embeddings."""

    def __init__(self, vit_kernels):
        self.active, self.calls = False, {}
        self.encode_calls, self.images, self.tower_input = 0, 0, None
        for name in vit_kernels.KERNEL_NAMES:
            setattr(vit_kernels, name,
                    self._wrap(name, getattr(vit_kernels, name)))

    def _wrap(self, name, fn):
        def wrapper(*args):
            if self.active and (name not in self.calls or args[0].numel()
                                > self.calls[name][0].numel()):
                self.calls[name] = args
            return fn(*args)
        wrapper.wrapped = fn
        return wrapper

    def watch(self, clip_model, keep_embeddings=None):
        """Count (and keep) the tower calls of ``clip_model``."""
        encode = clip_model.model.encode_image

        def wrapper(x):
            out = encode(x)
            if self.active:
                self.encode_calls += 1
                self.images += x.shape[0]
                if self.tower_input is None or x.shape[0] > self.tower_input.shape[0]:
                    self.tower_input = x
            if keep_embeddings is not None:
                keep_embeddings.append(out.float().cpu())
            return out
        clip_model.model.encode_image = wrapper


def vit_bound(name, args):
    """(bound ms, bound_by, GFLOP): the products' operations over the bf16
    tensor-core peak, or each input read once and the output written once
    over the memory rate, whichever is larger."""
    if name == "fused_attention_proj":
        x, w = args[0], args[3]
        b, t, width = x.shape
        ops = b * (2 * t * width * 3 * width + 2 * t * width * width
                   + 4 * t * t * width)
    else:
        x, w = args[0], args[3] if name == "fused_mlp_block" else args[1]
        ops = 4 * x.shape[0] * x.shape[1] * w.shape[1]
    nbytes = sum(a.numel() * a.element_size() for a in args
                 if hasattr(a, "numel")) + x.numel() * x.element_size()
    t_ops = ops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes",
            ops / 1e9)


def vit_composite(name, args):
    """The same function from PyTorch's own operators (F.layer_norm,
    F.linear, F.scaled_dot_product_attention): the yardstick the port never
    calls."""
    import torch
    import torch.nn.functional as F

    def qgelu(v):
        return v * torch.sigmoid(1.702 * v)

    if name == "fused_attention_proj":
        x, lns, lnb, wq, bq, wo, bo, heads = args
        width = x.shape[-1]
        wq_t, wo_t = wq.t().contiguous(), wo.t().contiguous()
        lns16, lnb16 = lns.to(x.dtype), lnb.to(x.dtype)

        def run():
            h = F.layer_norm(x, (width,), lns16, lnb16, eps=1e-5)
            q, k, v = (t.unflatten(-1, (heads, -1)).transpose(1, 2)
                       for t in F.linear(h, wq_t, bq).split(width, dim=-1))
            att = F.scaled_dot_product_attention(q, k, v)
            return F.linear(att.transpose(1, 2).flatten(2), wo_t, bo) + x
    elif name == "fused_mlp_block":
        x, lns, lnb, wf, bf, wp, bp = args
        wf_t, wp_t = wf.t().contiguous(), wp.t().contiguous()
        lns16, lnb16 = lns.to(x.dtype), lnb.to(x.dtype)

        def run():
            h = F.layer_norm(x, (x.shape[-1],), lns16, lnb16, eps=1e-5)
            return F.linear(qgelu(F.linear(h, wf_t, bf)), wp_t, bp) + x
    else:
        x, wf, bf, wp, bp = args
        wf_t, wp_t = wf.t().contiguous(), wp.t().contiguous()

        def run():
            return F.linear(qgelu(F.linear(x, wf_t, bf)), wp_t, bp)
    return run


def ragged(name, args, n_images=3):
    """The same call on the first ``n_images`` images (ragged tiles)."""
    a = list(args)
    if name == "fused_attention_proj":
        a[0] = args[0][:n_images].contiguous()
    else:
        a[0] = args[0][:n_images * 197].contiguous()
    return tuple(a)


def check_vit_kernel(name, args, vit_kernels):
    """Kernel vs plain version on the main path's ``args`` and on a ragged
    batch of 3 images; kernel, plain, composite and bound times."""
    import torch

    kernel = getattr(vit_kernels, name).wrapped
    plain = vit_kernels.PLAIN[name]
    err, mean_err = 0.0, 0.0
    for a in (args, ragged(name, args)):
        got = kernel(*a)
        torch.cuda.synchronize()
        want = plain(*a)
        torch.testing.assert_close(got.float(), want.float(), rtol=1.6e-2,
                                   atol=1e-2)
        diff = (got.float() - want.float()).abs()
        mean = float(diff.mean())
        if mean >= 1e-3:
            raise AssertionError(f"{name}: mean |kernel - plain| {mean}")
        err, mean_err = max(err, float(diff.max())), max(mean_err, mean)
        del got, want, diff
    ms = cuda_ms(lambda: kernel(*args), 3)
    plain_ms = cuda_ms(lambda: plain(*args), 1)
    composite = vit_composite(name, args)
    composite()
    library_ms = cuda_ms(composite, 3)
    bound_ms, bound_by, gflop = vit_bound(name, args)
    return {"name": name, "route": "cuda",
            "source": "vilgod_tpu_torch/csrc/vit.cu",
            "replaces": REPLACES[name], "launches": 0, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "shape": {"x": list(args[0].shape), "gflop": gflop,
                      "mean_abs_err": mean_err}}


def item_rows(n_items, batch, views=4):
    """Tower rows of each classified item, as the classification stage
    chunks its items (full batches, then a tail batch, padded)."""
    tail = min(batch, max(32, batch // 4))
    rows, i, base = [], 0, 0
    while i < n_items:
        b = batch if n_items - i > tail else tail
        for j in range(min(b, n_items - i)):
            rows.append([base + j * views + v for v in range(views)])
        i += b
        base += b * views
    return rows


def clip_check_model(device):
    import torch
    from vilgod_tpu_torch.config import waymo_config
    from vilgod_tpu_torch.models.clip import CLIPConfig
    from vilgod_tpu_torch.models.clip_wrapper import ClipWrapper

    cfg = CLIPConfig(**CHECK_CLIP, dtype=torch.bfloat16)
    return ClipWrapper(waymo_config()["preprocessor"]["clip"], seed=0,
                       model_cfg=cfg, device=device)


def run_detector(source, cfg, device, clip_model):
    from vilgod_tpu_torch.pipeline.runner import ZeroShotDetector
    zsd = ZeroShotDetector(source, "synth_0", cfg, clip_model=clip_model,
                           device=device)
    zsd.process()
    return zsd.state, zsd.stage_times


def profile_main_path(ds, cfg, clip_model):
    """The main path's stages once more under torch.profiler: the card's
    busy share of the stage wall time and the kernels that fill it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from vilgod_tpu_torch.pipeline.runner import ZeroShotDetector

    zsd = ZeroShotDetector(ds.sequence("synth_0"), "synth_0", cfg,
                           clip_model=clip_model, device="cuda")
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
    top = sorted(events, key=dev_us, reverse=True)[:10]
    return {"wall_s": wall, "stage_s": zsd.stage_times,
            "device_busy_s": busy_s,
            "device_busy_share": busy_s / wall if busy_s else None,
            "top": [{"name": e.key[:60], "ms": dev_us(e) / 1e3,
                     "calls": e.count} for e in top]}


def print_ptxas(lib_path):
    ptxas = lib_path.with_suffix(".log")
    if ptxas.exists():
        text = ptxas.read_text()
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
        spills = [int(b) for b in re.findall(r"(\d+) bytes spill stores", text)]
        log(f"ptxas {lib_path.name}: {len(regs)} kernels, max "
            f"{max(regs, default=0)} registers, {sum(spills)} bytes spilled")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the port on "
              "the card", file=sys.stderr)
        return 2
    import numpy as np
    from vilgod_tpu_torch.config import waymo_config
    from vilgod_tpu_torch.data import SyntheticDataset
    from vilgod_tpu_torch.models import vit_kernels
    from vilgod_tpu_torch.models.clip_wrapper import ClipWrapper
    from vilgod_tpu_torch.ops import cluster, entropy, kernels, neighbors
    from vilgod_tpu_torch.pipeline.runner import run_sequences
    from vilgod_tpu_torch.pipeline.state import (CLS_NONE, Capacity,
                                                 SequenceState)
    from vilgod_tpu_torch.utils.cuda_build import build_all

    # ---- 1. device and build ----
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    paths = build_all([kernels.LIBRARY, vit_kernels.LIBRARY])
    kernels.LIBRARY.load()
    vit_kernels.LIBRARY.load()
    log(f"build: {time.perf_counter() - t0:.2f} s -> "
        f"{', '.join(p.name for p in paths)}")
    for path in paths:
        print_ptxas(path)

    cfg = waymo_config(capacity=CAPS, pipeline_active=STAGES)
    ds = SyntheticDataset(**SCENE)
    first = FirstFrames(ds.sequence("synth_0"), CHECK_FRAMES)
    recorder = Recorder(kernels, (cluster, entropy, neighbors))
    vit_rec = VitRecorder(vit_kernels)

    # ---- 2. card half of the card-vs-CPU check (also the warm-up) ----
    t0 = time.perf_counter()
    card_clip, card_emb = clip_check_model("cuda"), []
    vit_rec.watch(card_clip, card_emb)
    card_state, _ = run_detector(first, cfg, "cuda", card_clip)
    log(f"card run of the first {CHECK_FRAMES} frames: "
        f"{time.perf_counter() - t0:.2f} s")

    # ---- 3. the main path ----
    t0 = time.perf_counter()
    clip_model = ClipWrapper(cfg["preprocessor"]["clip"], dtype=torch.bfloat16,
                             seed=0)
    vit_rec.watch(clip_model)
    log(f"ClipWrapper ViT-B/16 bf16 on the card: "
        f"{time.perf_counter() - t0:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    times = {}
    with tempfile.TemporaryDirectory(dir=paths[0].parent) as cache:
        kernels.reset_launches()
        vit_kernels.reset_launches()
        recorder.active = vit_rec.active = True
        t0 = time.perf_counter()
        run_sequences(ds, cfg, clip_model=clip_model, cache_dir=cache,
                      stage_times=times, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        recorder.active = vit_rec.active = False
        launches = {**kernels.LAUNCHES, **vit_kernels.LAUNCHES}
        st = SequenceState.allocate("synth_0", SCENE["n_frames"],
                                    Capacity.from_cfg(cfg), device="cpu")
        assert st.load(Path(cache) / "synth_0.npz"), "no checkpoint written"
    n_frames = SCENE["n_frames"]
    stage_s = sum(times.values())
    dets = (st.det_n > 0).sum(axis=1)
    valid = st.det_valid
    n_layers = clip_model.model_cfg.vision_layers
    log("main path: " + json.dumps({
        "frames": n_frames, "wall_s": wall, "stage_s": times,
        "frames_per_s": n_frames / stage_s,
        "detections_per_frame": dets.tolist(),
        "valid_detections": int(valid.sum()),
        "images_classified": vit_rec.images,
        "classify_calls": vit_rec.encode_calls,
        "ground_points_per_frame": float(st.ground_mask.sum() / n_frames),
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "launches": launches}))
    for name in kernels.KERNEL_NAMES:
        if launches[name] <= 0:
            raise AssertionError(f"{name} never launched on the main path")
    want = n_layers * vit_rec.encode_calls
    if vit_rec.encode_calls <= 0 or launches["fused_attention_proj"] != want:
        raise AssertionError(
            f"fused_attention_proj launched {launches['fused_attention_proj']}"
            f" times on the main path, expected {want} ({n_layers} layers x "
            f"{vit_rec.encode_calls} classify calls)")
    if not (set(times) == set(STAGES) and dets.min() > 0 and valid.any()
            and np.isfinite(st.det_center).all()
            and np.isfinite(st.plane_ref).all()
            and (st.det_cls[valid] != CLS_NONE).all()
            and ((st.det_score[valid] > 0) & (st.det_score[valid] <= 1)).all()
            and (st.det_cls[~valid] == CLS_NONE).all()):
        raise AssertionError("main path output malformed")
    log("classes on the main path: " + json.dumps(
        np.bincount(st.det_cls[valid], minlength=4).tolist()))

    # the opt-in MLP kernels: one classify batch of the main path through
    # the tower with each switch
    x = vit_rec.tower_input
    base = clip_model.model.encode_image(x).float()
    for name, var in OPT_IN.items():
        vit_kernels.reset_launches()
        os.environ[var] = "1"
        vit_rec.active = True
        try:
            out = clip_model.model.encode_image(x).float()
            torch.cuda.synchronize()
        finally:
            vit_rec.active = False
            del os.environ[var]
        launches[name] = vit_kernels.LAUNCHES[name]
        cos = float(torch.nn.functional.cosine_similarity(out, base).min())
        log(f"{var}=1 on {x.shape[0]} images: {launches[name]} launches of "
            f"{name}, min cosine to the default tower {cos:.6f}")
        if launches[name] != n_layers:
            raise AssertionError(f"{name}: {launches[name]} launches with "
                                 f"{var}=1, expected {n_layers}")
    del x, base, out
    vit_rec.tower_input = None

    log("profile: " + json.dumps(profile_main_path(ds, cfg, clip_model)))

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
    for name in vit_kernels.KERNEL_NAMES:
        if name not in vit_rec.calls:
            raise AssertionError(f"{name}: no call recorded")
        row = check_vit_kernel(name, vit_rec.calls.pop(name), vit_kernels)
        row["launches"] = launches[name]
        rows.append(row)
        log(f"kernel {name}: " + json.dumps(row))
        torch.cuda.empty_cache()

    # ---- 5. CPU half of the card-vs-CPU check ----
    t0 = time.perf_counter()
    cpu_clip, cpu_emb = clip_check_model("cpu"), []
    vit_rec.watch(cpu_clip, cpu_emb)
    cpu_state, _ = run_detector(first, cfg, "cpu", cpu_clip)
    log(f"CPU run of the first {CHECK_FRAMES} frames: "
        f"{time.perf_counter() - t0:.2f} s")
    a, b = card_state, cpu_state
    for field in ("ground_mask", "labels", "det_n", "det_static",
                  "det_valid"):
        if not np.array_equal(getattr(a, field), getattr(b, field)):
            raise AssertionError(f"card != CPU in {field}")
    center_err = float(np.abs(a.det_center - b.det_center).max())
    plane_err = float(np.abs(a.plane_ref - b.plane_ref).max())
    if center_err > 1e-4 or plane_err > 1e-4:
        raise AssertionError(f"card != CPU: det_center {center_err}, "
                             f"plane_ref {plane_err}")
    ea, eb = torch.cat(card_emb), torch.cat(cpu_emb)
    cos = torch.nn.functional.cosine_similarity(ea, eb)
    if ea.shape != eb.shape or float(cos.min()) < 0.999:
        raise AssertionError(f"card != CPU image embeddings: min cosine "
                             f"{float(cos.min())}")
    valid = a.det_valid
    same = a.det_cls[valid] == b.det_cls[valid]

    def margins(emb, clip):
        text = clip.text_features.float().cpu()
        probs = torch.softmax(100.0 * torch.nn.functional.normalize(emb)
                              @ text.T, dim=-1)
        top2 = probs.topk(2, dim=-1).values
        return (top2[:, 0] - top2[:, 1]).numpy()

    rows_of = item_rows(int(valid.sum()), CAPS["clip_batch"])
    ma, mb = margins(ea, card_clip), margins(eb, cpu_clip)
    items = [(f, int(c)) for f in range(a.n_frames)
             for c in np.flatnonzero(valid[f])]
    for k in np.flatnonzero(~same):
        f, c = items[k]
        log(f"card != CPU class of ({f}, {c}): {a.det_cls[f, c]} vs "
            f"{b.det_cls[f, c]}, top-2 margins per view card "
            f"{ma[rows_of[k]].round(5).tolist()} CPU "
            f"{mb[rows_of[k]].round(5).tolist()}")
    if same.mean() < 0.95:
        raise AssertionError(f"card != CPU det_cls on {int((~same).sum())} "
                             f"of {same.size} valid detections")
    log("card vs CPU: " + json.dumps({
        "frames": CHECK_FRAMES, "det_center_max_err_m": center_err,
        "plane_ref_max_err": plane_err,
        "detections": int((a.det_n > 0).sum()),
        "valid_detections": int(valid.sum()),
        "embedding_min_cosine": float(cos.min()),
        "det_cls_equal_share": float(same.mean()),
        "det_score_max_err": float(np.abs(a.det_score - b.det_score).max())}))

    print(smi)
    print(json.dumps({"kernels": [
        {k: v for k, v in r.items() if k != "shape"} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
