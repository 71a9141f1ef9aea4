#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (vilgod_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. device: the card's name and power limit; build the CUDA sources of
   vilgod_tpu_torch/csrc/ (banded.cu, vit.cu, dense.cu) with nvcc for
   sm_90a, one nvcc each, started together (timed); ptxas's registers,
   spill stores and static shared memory per kernel of each source, with
   kernel 8's pair loop at ndim 5 held to at least ``K8_MIN_REGISTERS``; per
   pair-loop kernel (banded 1-4, dense 6-9 and 12, which shares kernel 8's
   template) and ndim, the SASS instructions of its pair loop per (query,
   data point) pair (``cuobjdump -sass``);
2. card against CPU, first half: the first 4 frames of the scene
   (``SCENE`` of vilgod_tpu_torch/tools/scenes.py, as are the caps and the
   dense configuration of phase 3b)
   through ground -> entropy -> clustering -> filter -> classification on
   the card, classified by a narrow bf16 tower on which the fused attention
   kernel holds (this run also warms the CUDA context up for phase 3);
3. the main path: all nine stages (ground -> entropy -> clustering ->
   filter -> tracking -> classification -> boxes -> label propagation ->
   evaluation) through ``run_sequences`` on one 24-frame sequence of the
   bench's parity scene at the bench's full caps (paged clustering, 24 pages
   x 40960; CLIP batches of 512 clusters = 2048 images) with a ViT-B/16
   ``ClipWrapper`` in bf16 (random weights from seed 0), each stage's
   seconds printed. Launch counts are zeroed just before and read just
   after; every kernel of the path must have launched,
   ``fused_attention_proj`` once per vision layer and classify call. Then
   the opt-in MLP kernels: one classify batch of this run through the tower
   with ``VILGOD_FUSED_MLP_BLOCK=1`` and with ``VILGOD_FUSED_MLP=1``; each
   must launch. Then the nine stages once more under ``torch.profiler``:
   the card's busy share and the banded kernels' device time per launch.
   Then a geometry-only pass (no CLIP model): stages 1-4, their
   checkpoint kept, and the nine stages resumed from it, scored with the
   port's ``evaluate_detections`` (LEVEL_2 APs, bench.py's range);
3b. the dense configuration: the same scene and caps with an entropy radius
   of 0.5 m (not bandable: every (frame, window frame) pair is one dense
   count) and a 16000-point cluster input (per-frame dense DBSCAN and dense
   label transfer), stages 1-3; its counts zeroed just before and read just
   after: ``tile_radius_count`` 192 times, ``tile_radius_count3`` 24,
   ``tile_nearest`` 48 (label transfer and border attach), ``tile_min_label``
   at least 24 times. Then the same once more under ``torch.profiler``:
   each box-decided dense kernel's (6-9) device time per call split into
   its box pass, its fill (the nearest: its bound pass), its main kernel
   and its unpack, beside the wrapper's host time per call;
3c. the run tool: ``python -m vilgod_tpu_torch.tools.run``'s ``main`` on
   the card (its default device) over a short synthetic sequence
   (``RUN_TOOL_ARGS``: the tool's synthetic scene at 8 frames, the default
   caps, all nine stages with a random-weight ViT-B/16) with a results
   directory and ``profile_dir``: its ``ap_results.json`` must be written
   and its trace must hold one span per stage, all nine;
4. all twelve kernels against their plain PyTorch versions on the card,
   on the arguments the runs gave them (captured in phases 3 and 3b): the
   banded kernels also on a forced full-width (overflow) call each, small
   enough that the kernel splits each span over ``gridDim.y`` and merges
   the splits with atomics (the banded kernels take each block's span end
   on the main path and none at full width; their span call must also
   equal the same call over the whole windows on every valid query lane,
   for ``banded_tile_nearest`` on those whose nearest lies within the
   0.5 m cell; each timed, too, with its spans cut into runs of 1-16
   chunks and one run a span, outputs bitwise equal to its own), the
   dense kernels also on a ragged call (N not a multiple of 256) each
   (counts, labels and indices equal, squared distances bitwise equal);
   kernels 6-9 and 12 (the box pre-pass) also on a call of 1001 x 1499
   lanes, a constructed call whose tiles are skipped (and for the counts
   taken whole), and the captured call with its data lanes shuffled (no tile
   decided; timed as ``pairs_ms``, the pair loop's own rate), kernel 9
   also on its 5-D border-attach call (core points against sentinel lanes
   interleaved; timed); on each of these calls the kernel's own decision
   per tile equals the torch mirror's, whose tiles skipped, taken whole
   and left to the pair loop, the pairs in those (``needed_pairs``) and
   the bound over them (``bound_needed_ms``) the row reports; each dense
   kernel is also timed by its device time alone (``device_ms``:
   torch.profiler's kernel time per call, no gaps between launches);
   ``tile_min_label_qd``, which no path calls, on a 512-lane query block
   of the main path's largest ``banded_tile_min_label`` call against that
   block's window, and on a ragged 1000 x 1500 call cut from one window
   with its data 100 lanes on (labels equal), its 1001 x 1499 call cut
   the same way; the ViT kernels also on a ragged batch of 3 images
   (assert_close rtol 1.6e-2, atol 1e-2, mean |diff| < 1e-3), with a line
   that splits
   ``fused_attention_proj`` into its LayerNorm pass, qkv GEMM, attention
   core and output GEMM (ms, TFLOP/s, GB/s); kernel, plain, torch-composite
   and bound times;
5. card against CPU, second half: the same 4 frames by the port on the CPU
   (the plain versions): ground mask, labels, det_n, det_static and
   det_valid equal, det_center within 1e-4 m, plane_ref within 1e-4, every
   image embedding's cosine with its CPU counterpart >= 0.999, det_cls equal
   on >= 95 % of valid detections. Then stages 5 and 7-9 on the CPU over
   all 24 frames from the card's stage 1-4 checkpoint of the geometry-only
   pass: det_tid, det_valid, det_cls, det_static_track and the track pool
   equal, det_box within 1e-4 m, the same boxes per frame, APs within 1e-6.

The line before the last is the kernels JSON; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import inspect
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from vilgod_tpu_torch.tools.scenes import (CAPS, SCENE, STAGES, FirstFrames,
                                           dense_config)

# H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor cores, dense
# bf16 on the tensor cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

GEOMETRY = STAGES[:4]
# phase 3c: the run tool's overrides (its synthetic scene, 8 frames)
RUN_TOOL_ARGS = ["preprocessor=synthetic", "synthetic.n_frames=8"]
# the 4-frame card-vs-CPU check of stages 1-4 and the classification
CHECK_STAGES = GEOMETRY + ["classification"]
EVAL_RANGE = (-50.0, -20.0, 50.0, 20.0)
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
    "tile_radius_count": "vilgod_tpu/ops/pallas_kernels.py:93",
    "tile_radius_count3": "vilgod_tpu/ops/pallas_kernels.py:136",
    "tile_min_label": "vilgod_tpu/ops/pallas_kernels.py:187",
    "tile_nearest": "vilgod_tpu/ops/pallas_kernels.py:531",
    "tile_min_label_qd": "vilgod_tpu/ops/pallas_kernels.py:241",
}
OPT_IN = {"fused_mlp_block": "VILGOD_FUSED_MLP_BLOCK",
          "fused_mlp": "VILGOD_FUSED_MLP"}
# float32 operations per (query, window point) pair: (q - d) and its square
# per coordinate, the coordinate sums, then each kernel's epilogue
EPILOGUE_OPS = {"banded_tile_count": 1, "banded_tile_count3": 3,
                "banded_tile_min_label": 2, "banded_tile_nearest": 1,
                "tile_radius_count": 1, "tile_radius_count3": 3,
                "tile_min_label": 2, "tile_nearest": 1,
                "tile_min_label_qd": 2}


def log(msg):
    print(msg, flush=True)


# argument positions of each wrapper (as ops/banded.py calls them), each
# block's span end included
POS = {
    "banded_tile_count": dict(q=0, d=1, starts=2, tq=4, w=5, ndim=6, ends=7),
    "banded_tile_count3": dict(q=0, d=1, starts=2, tq=4, w=5, ndim=6, ends=7),
    "banded_tile_min_label": dict(q=0, r2=1, lab=2, starts=3, tq=4, w=5,
                                  ndim=6, ends=8),
    "banded_tile_nearest": dict(q=0, d=1, starts=2, tq=3, w=4, ndim=5,
                                ends=6),
}
# the pair-loop kernels' template instances, by library: banded.cu's
# (kernels 1 and 2 share count_kernel<NDIM, NLEV>) and dense.cu's kernels
# 6-9 and 12 (6 and 7 share count_kernel<NDIM, NLEV>, 8 and 12
# min_label_kernel<NDIM>; nearest_kernel<NDIM>)
SASS_KERNELS = {"banded_tile_count": ("banded", "count_kernel", 1),
                "banded_tile_count3": ("banded", "count_kernel", 3),
                "banded_tile_min_label": ("banded", "min_label_kernel", None),
                "banded_tile_nearest": ("banded", "nearest_kernel", None),
                "tile_radius_count": ("dense", "count_kernel", 1),
                "tile_radius_count3": ("dense", "count_kernel", 3),
                "tile_min_label": ("dense", "min_label_kernel", None),
                "tile_nearest": ("dense", "nearest_kernel", None),
                "tile_min_label_qd": ("dense", "min_label_kernel", None)}
# run lengths (256-rank chunks) the banded kernels are also timed at,
# beside the wrapper's own (ops/kernels._RUN_CHUNKS) and one run a span
RUN_CHOICES = (1, 2, 4, 8, 16)
# ptxas's least allotment for dense.cu's min_label_kernel<5> (kernel 8's
# pair loop) measured at kernel 8's old time (phase 1)
K8_MIN_REGISTERS = 72
OUT_BYTES = {"banded_tile_count": 4, "banded_tile_count3": 12,
             "banded_tile_min_label": 4, "banded_tile_nearest": 8,
             "tile_radius_count": 4, "tile_radius_count3": 12,
             "tile_min_label": 4, "tile_nearest": 8,
             "tile_min_label_qd": 4}


class Recorder:
    """Keeps, per kernel wrapper, the arguments of its largest banded call
    (window narrower than the data) while ``active`` (positional, defaults
    applied), with the true end of each query block's candidate span (the
    data-dependent work of the call), the call's own ``ends``."""

    def __init__(self, kernels):
        self.active, self.calls = False, {}
        for name in kernels.KERNEL_NAMES:
            setattr(kernels, name, self._wrap(name, getattr(kernels, name)))

    def _wrap(self, name, fn):
        pos, sig = POS[name], inspect.signature(fn)

        def wrapper(*args, **kwargs):
            if self.active:
                bound = sig.bind(*args, **kwargs)
                bound.apply_defaults()
                a = bound.args
                q, w = a[pos["q"]], a[pos["w"]]
                n_d = a[pos.get("d", pos["q"])].shape[1]
                key = (w < n_d, q.shape[1] * w)
                if name not in self.calls or key > self.calls[name][0]:
                    self.calls[name] = (key, a, a[pos["ends"]])
            return fn(*args, **kwargs)
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


def device_ms(fn, reps):
    """The card's kernel time (ms) of one call of ``fn``: the device time
    of every kernel ``reps`` calls launch, under torch.profiler, over
    ``reps``. Unlike ``cuda_ms`` it leaves out the gaps between launches,
    which a call of under 100 us leaves when its host time is longer."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.end - e.time_range.start for e in prof.events()
             if str(e.device_type).endswith("CUDA"))
    return us / reps / 1e3


def full_width_args(name, args, m):
    """The same pass over the first ``m`` sorted ranks at full width
    (starts 0, w = m, no span ends): the overflow re-run of the main
    path, on few enough query blocks that the kernel splits each span over
    gridDim.y."""
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
    if "ends" in pos:
        a[pos["ends"]] = None
    return tuple(a)


def without_ends(name, args):
    """The same call over each block's whole window (``ends`` None)."""
    a = list(args)
    a[POS[name]["ends"]] = None
    return tuple(a)


def block_spans(args, pos, ends):
    """Per query block, the data ranks its call scans: the window rows up
    to the block's true candidate end (points past it lie beyond CELL and
    change no count, label or in-radius nearest); the whole window where
    the call has no span (an overflow re-run)."""
    import torch
    starts, w = args[pos["starts"]], args[pos["w"]]
    if ends is None:
        return torch.full_like(starts, w)
    return (ends - starts).clamp(0, w)


def check_kernel(name, args, kernels, m, ends=None):
    """Kernel vs plain version on the main path's ``args`` and on a forced
    full-width call over the first ``m`` ranks, which must split gridDim.y;
    the span call also against the same call over the whole windows, equal
    on every valid query lane (the nearest: on those whose whole-window
    nearest lies within CELL); times and bound. Returns the JSON row
    (launches filled in by the caller)."""
    import torch
    from vilgod_tpu_torch.ops.banded import CELL

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

    pos = POS[name]
    split, _ = kernels._span_split(m)
    if split < 2:
        raise AssertionError(f"{name}: the full-width check over {m} ranks "
                             "does not split gridDim.y")
    err = max(compare(args), compare(full_width_args(name, args, m)))
    if ends is not None:
        lanes = args[pos["q"]][0] < kernels.SENTINEL
        whole = outs(kernel, without_ends(name, args))
        if name == "banded_tile_nearest":
            lanes &= whole[0] < CELL ** 2
        for g, w_ in zip(outs(kernel, args), whole):
            if not torch.equal(g[lanes], w_[lanes]):
                raise AssertionError(f"{name}: the span call differs from "
                                     "the whole-window call on valid query "
                                     "lanes")
        del whole
    ms = cuda_ms(lambda: kernel(*args), 20)
    plain_ms = cuda_ms(lambda: plain(*args), 1)
    # the same call with spans cut into runs of other lengths (whole: one
    # run a span, no split), outputs held bitwise to the wrapper's own
    base, run_ms, own = outs(kernel, args), {}, kernels._RUN_CHUNKS
    w_chunks = args[pos["w"]] // 256
    try:
        for label, r in [(str(r), r) for r in RUN_CHOICES] + [
                ("whole", w_chunks + 1)]:
            kernels._RUN_CHUNKS = r
            for g, b in zip(outs(kernel, args), base):
                if not torch.equal(g.view(torch.int32), b.view(torch.int32)):
                    raise AssertionError(f"{name}: runs of {label} chunks "
                                         "change the output")
            run_ms[label] = cuda_ms(lambda: kernel(*args), 20)
    finally:
        kernels._RUN_CHUNKS = own
    del base

    n_q, w, ndim = args[pos["q"]].shape[1], args[pos["w"]], args[pos["ndim"]]
    n_d = args[pos["d"]].shape[1] if "d" in pos else 0
    spans = block_spans(args, pos, ends)
    pairs = int(spans.sum()) * args[pos["tq"]]
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
                      "pairs_scanned": pairs, "pairs_needed": pairs,
                      "span_mean": float(spans.float().mean()),
                      "span_max": int(spans.max()),
                      "span_p99": float(torch.quantile(spans.float(), 0.99)),
                      "empty_spans": int((spans == 0).sum()),
                      "blocks": spans.numel(),
                      "split_run": kernels._span_split(w),
                      "run_ms": run_ms,
                      "full_width_check": {"cols": m, "split": split}}}


class DenseRecorder:
    """Keeps, per dense kernel wrapper and ndim, the arguments of its
    largest call (by query x data points) and the number of its calls
    while ``active``, bound to the wrapper's parameters (positional,
    defaults applied); while ``host`` is a dict, sums each wrapper's host
    seconds and calls there."""

    def __init__(self, dense_kernels):
        self.active, self.calls, self.host = False, {}, None
        self.counts = {}
        for name in dense_kernels.KERNEL_NAMES:
            setattr(dense_kernels, name,
                    self._wrap(name, getattr(dense_kernels, name)))

    def _wrap(self, name, fn):
        sig = inspect.signature(fn)

        def wrapper(*args, **kwargs):
            if self.active:
                bound = sig.bind(*args, **kwargs)
                bound.apply_defaults()
                a = bound.args
                size = a[0].shape[1] * (a[1].shape[1] if a[1].dim() == 2
                                        else a[0].shape[1])
                key = (name, bound.arguments["ndim"])
                self.counts[key] = self.counts.get(key, 0) + 1
                if key not in self.calls or size > self.calls[key][0]:
                    self.calls[key] = (size, a)
            if self.host is None:
                return fn(*args, **kwargs)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            total = self.host.setdefault(name, [0.0, 0])
            total[0] += time.perf_counter() - t0
            total[1] += 1
            return out
        wrapper.wrapped = fn
        return wrapper

    def largest(self, name):
        """The arguments of ``name``'s largest call over every ndim."""
        sizes = {k: v for k, v in self.calls.items() if k[0] == name}
        if not sizes:
            raise AssertionError(f"{name}: no dense call recorded")
        return max(sizes.values(), key=lambda v: v[0])[1]


def profile_dense(ds, cfg, dense_rec):
    """The dense configuration once more under torch.profiler: per
    box-decided dense kernel (6-9), its calls' device time split into the
    box pass, the fill (the nearest: its bound pass, which also sets the
    keys), the main kernel and the unpack (the nearest), by the order of
    the launches on the stream (each call's begin with its box pass), and
    the wrapper's host time per call (entry to return; the launches are
    asynchronous)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from vilgod_tpu_torch.pipeline.runner import run_sequences

    dense_rec.host = {}
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run_sequences(ds, cfg, device="cuda")
            torch.cuda.synchronize()
    finally:
        host, dense_rec.host = dense_rec.host, None
    events = sorted((e for e in prof.events()
                     if str(e.device_type).endswith("CUDA")),
                    key=lambda e: e.time_range.start)
    return dense_call_parts([(e.name, e.time_range.end - e.time_range.start)
                             for e in events], host)


def dense_call_parts(kernels, host):
    """Per box-decided dense kernel: the mean device time (us) of each part
    of its calls, from the card's kernels in stream order ((name, us)
    pairs: a call is its box pass, its fill or bound pass, its main kernel
    and, for the nearest, its unpack), and the wrapper's host time per call
    from ``host`` ({wrapper: [seconds, calls]})."""
    main = {"count_kernel<1>": "tile_radius_count",
            "count_kernel<3>": "tile_radius_count3",
            "min_label_kernel": "tile_min_label",
            "nearest_kernel": "tile_nearest"}
    parts, cur = {}, None
    for kname, us in kernels:
        m = re.search(r"(\w+_kernel)(<[^>]*>)?\(", kname)
        kind = m.group(1) if m else None
        if kind == "box_kernel":
            cur = {"box": us, "fill": 0.0, "unpack": 0.0}
        elif cur is None:
            continue
        elif kind in ("fill_kernel", "nearest_bound_kernel"):
            cur["fill"] += us
        elif kind in ("count_kernel", "min_label_kernel", "nearest_kernel"):
            # count_kernel<NDIM, NLEV>: kernel 6 or 7 by its levels
            nlev = re.findall(r"\d+", m.group(2) or "")[-1:]
            name = main[kind + (f"<{nlev[0]}>" if kind == "count_kernel"
                                else "")]
            cur["main"] = us
            parts.setdefault(name, []).append(cur)
            if name != "tile_nearest":
                cur = None
        elif kind == "nearest_unpack_kernel":
            cur["unpack"] = us
            cur = None
        else:
            cur = None
    out = {}
    for name, calls in parts.items():
        n = len(calls)
        row = {"calls": n}
        for part in ("box", "fill", "main", "unpack"):
            row[f"{part}_us"] = sum(c[part] for c in calls) / n
        row["device_us"] = sum(row[f"{p}_us"] for p in
                               ("box", "fill", "main", "unpack"))
        if name in host:
            row["host_us"] = host[name][0] / host[name][1] * 1e6
            row["host_calls"] = host[name][1]
        out[name] = row
    return out


def dense_ndim(name, args):
    """The ndim argument of a dense wrapper's positional ``args``."""
    return (args[3] if name == "tile_min_label"
            else args[5] if name == "tile_min_label_qd" else args[-1])


def dense_ragged_args(name, args, n_q=1000, n_d=1500):
    """The same call on the first ``n_q`` query and ``n_d`` data columns
    (neither a multiple of 256); the min-label pass has one cloud."""
    a = list(args)
    if name == "tile_min_label":
        a[0] = args[0][:, :n_q].contiguous()
        a[1], a[2] = args[1][:n_q].contiguous(), args[2][:n_q].contiguous()
    else:
        a[0] = args[0][:, :n_q].contiguous()
        a[1] = args[1][:, :n_d].contiguous()
    return tuple(a)


def min_label_qd_args(args, ends, n_q=512):
    """Kernel 12's arguments cut from a ``banded_tile_min_label`` call:
    ``n_q`` query lanes from the query block with the longest true candidate
    span (the middle block where the span is unknown) and that block's
    window of w data lanes, with both radii and the data's labels."""
    pts_t8, r2, lab, starts, tq, w, ndim, big = args[:8]
    n = pts_t8.shape[1]
    if ends is not None:
        blk = int((ends - starts).clamp(0, w).argmax())
    else:
        blk = starts.numel() // 2
    q0 = min(blk * tq, n - n_q)
    s = min(max(int(starts[blk]), 0), n - w)
    return (pts_t8[:, q0:q0 + n_q].contiguous(),
            pts_t8[:, s:s + w].contiguous(), r2[q0:q0 + n_q].contiguous(),
            r2[s:s + w].contiguous(), lab[s:s + w].contiguous(), ndim, big)


def min_label_qd_ragged(args, n_q=1000, n_d=1500, shift=100):
    """The ragged kernel-12 call: ``n_q`` lanes of the middle query block's
    window against ``n_d`` lanes of it ``shift`` lanes on (neither a
    multiple of 256; overlapping, so the queries find labels)."""
    pts_t8, r2, lab, starts, tq, w, ndim, big = args[:8]
    n = pts_t8.shape[1]
    s = min(max(int(starts[starts.numel() // 2]), 0), n - n_d - shift)
    d = s + shift
    return (pts_t8[:, s:s + n_q].contiguous(), pts_t8[:, d:d + n_d].contiguous(),
            r2[s:s + n_q].contiguous(), r2[d:d + n_d].contiguous(),
            lab[d:d + n_d].contiguous(), ndim, big)


def dense_composite(name, args):
    """The same function from ``torch.cdist`` (the matmul form) and a
    compare or a min: the yardstick the port never calls."""
    import torch

    if name == "tile_min_label_qd":
        q_t8, d_t8, q_r2, d_r2, lab, ndim, big = args
        q, d = q_t8[:ndim].T.contiguous(), d_t8[:ndim].T.contiguous()
        big_t = torch.tensor(big, dtype=torch.int32, device=q.device)

        def run():
            d2 = torch.cdist(q, d).square_()
            joint = torch.maximum(q_r2[:, None], d_r2[None, :])
            return torch.where(d2 <= joint, lab[None, :], big_t).amin(dim=1)
        return run
    if name == "tile_min_label":
        pts_t8, r2, lab, ndim, big = args
        p = pts_t8[:ndim].T.contiguous()
        big_t = torch.tensor(big, dtype=torch.int32, device=p.device)

        def run():
            d2 = torch.cdist(p, p).square_()
            joint = torch.maximum(r2[:, None], r2[None, :])
            return torch.where(d2 <= joint, lab[None, :], big_t).amin(dim=1)
        return run
    q_t8, d_t8, *rest = args
    ndim = rest[-1]
    q, d = q_t8[:ndim].T.contiguous(), d_t8[:ndim].T.contiguous()
    if name == "tile_radius_count":
        r2 = rest[0]
        return lambda: (torch.cdist(q, d).square_() <= r2).sum(dim=1)
    if name == "tile_radius_count3":
        lv = rest[0]

        def run():
            d2 = torch.cdist(q, d).square_()
            return torch.stack([(d2 <= lv[k]).sum(dim=1) for k in range(3)],
                               dim=1)
        return run
    return lambda: torch.cdist(q, d).square_().min(dim=1)


# kernels 6-9 and 12 take the box pre-pass: their extra calls and tile
# checks
BOXED = ("tile_radius_count", "tile_radius_count3", "tile_min_label",
         "tile_nearest", "tile_min_label_qd")
# the min-label kernels (8 and 12) take no tile whole
MIN_LABEL = ("tile_min_label", "tile_min_label_qd")


def decided_args(name, args, n_clumps=32, seed=0):
    """A call of kernels 6-9 whose tiles the boxes decide: 256 lanes a
    clump, so each data chunk and each query block is one clump; a clump's
    points lie in a cube small enough that every pair inside it is within
    the least level (the counts take those tiles whole; the nearest has no
    level and takes 0.5 m), clumps come in pairs 0.9 times the largest
    level apart (their tiles run the pair loop) and the pairs lie 10 m
    apart (skipped); sentinel lanes at the end (the counts: sentinel x
    sentinel tiles taken whole; kernels 8 and 12: non-core, radius 0,
    label big; kernel 12's query and data radii drawn apart)."""
    import torch
    q_t8, ndim = args[0], dense_ndim(name, args)
    dev, gen = q_t8.device, torch.Generator(device="cpu").manual_seed(seed)
    if name == "tile_radius_count":
        levels = [float(args[2])]
    elif name == "tile_radius_count3":
        levels = args[2].tolist()
    else:
        levels = [0.01 if name in MIN_LABEL else 0.25]
    half = 0.9 * (min(levels) / (4 * ndim)) ** 0.5
    n = 256 * n_clumps
    centre = torch.zeros(n_clumps, ndim)
    k = torch.arange(n_clumps)
    centre[:, 0] = 10.0 * (k // 2) + 0.9 * max(levels) ** 0.5 * (k % 2)
    pts = (centre.repeat_interleave(256, 0)
           + (torch.rand(n, ndim, generator=gen) * 2 - 1) * half)
    t8 = torch.zeros(8, n + 512)
    t8[:ndim, :n] = pts.T
    t8[:ndim, n:] = 1.0e6
    t8 = t8.to(dev)
    if name == "tile_nearest":
        return (t8, t8.clone(), ndim)
    if name not in MIN_LABEL:
        return (t8, t8.clone(), args[2], ndim)
    big = args[-1]

    def radii():
        r2 = torch.zeros(n + 512)
        r2[:n] = 0.01 + 0.08 * torch.rand(n, generator=gen)
        return r2.to(dev)
    radius2 = radii()
    labels = torch.full((n + 512,), big, dtype=torch.int32)
    labels[:n] = torch.randperm(n, generator=gen).to(torch.int32) + 3
    if name == "tile_min_label":
        return (t8, radius2, labels.to(dev), ndim, big)
    return (t8, t8.clone(), radius2, radii(), labels.to(dev), ndim, big)


def shuffled_args(name, args, seed=1):
    """The same call with the data lanes in a random order (kernel 8: its
    one cloud with radius2 and labels; kernel 12: the data with its radii
    and labels), so every box spans the cloud and every tile runs the pair
    loop."""
    import torch
    gen = torch.Generator(device="cpu").manual_seed(seed)
    a = list(args)
    if name == "tile_min_label":
        perm = torch.randperm(args[0].shape[1], generator=gen).to(
            args[0].device)
        for i in (0, 1, 2):
            a[i] = args[i][..., perm].contiguous()
    elif name == "tile_min_label_qd":
        perm = torch.randperm(args[1].shape[1], generator=gen).to(
            args[1].device)
        for i in (1, 3, 4):
            a[i] = args[i][..., perm].contiguous()
    else:
        perm = torch.randperm(args[1].shape[1], generator=gen).to(
            args[1].device)
        a[1] = args[1][:, perm].contiguous()
    return tuple(a)


def tile_stats(name, args, dense_kernels, kernel):
    """The box pre-pass's decisions on ``args`` by the torch mirror: tiles
    (warp query group x 256-lane chunk) skipped, taken whole, left to the
    pair loop, and the pairs inside those. The kernel's own decisions on
    the same call (its ``tiles=`` record) must equal the mirror's, tile
    for tile."""
    import torch

    if name == "tile_min_label":
        pts_t8, radius2, labels, ndim, big = args
        plan = dense_kernels.tile_decisions(pts_t8, pts_t8, ndim,
                                            radius2=radius2, labels=labels,
                                            big=big)
    elif name == "tile_min_label_qd":
        q_t8, d_t8, q_r2, d_r2, labels, ndim, big = args
        plan = dense_kernels.tile_decisions(q_t8, d_t8, ndim, radius2=q_r2,
                                            d_radius2=d_r2, labels=labels,
                                            big=big)
    elif name == "tile_nearest":
        q_t8, d_t8, ndim = args
        plan = dense_kernels.tile_decisions(q_t8, d_t8, ndim, nearest=True)
    else:
        q_t8, d_t8, lv, ndim = args
        key = "r2" if name == "tile_radius_count" else "levels2"
        plan = dense_kernels.tile_decisions(q_t8, d_t8, ndim, **{key: lv})
    codes = plan["codes"]
    own = torch.full_like(codes, 255)
    kernel(*args, tiles=own)
    if not torch.equal(own, codes):
        raise AssertionError(
            f"{name}: the kernel decides {int((own != codes).sum())} of "
            f"{codes.numel()} tiles otherwise than the mirror (kernel "
            f"skip/whole/pairs {[int((own == k).sum()) for k in range(3)]}, "
            f"mirror {[int((codes == k).sum()) for k in range(3)]})")
    return {"tiles": plan["skip"].numel(),
            "tiles_skipped": int(plan["skip"].sum()),
            "tiles_whole": int(plan["whole"].sum()),
            "tiles_pairs": int(plan["pairs"].sum()),
            "needed_pairs": plan["needed_pairs"]}


def check_dense_kernel(name, args, dense_kernels, ragged_args=None,
                       extra=None, odd_args=None):
    """Kernel vs plain version on the captured ``args``, on a ragged call
    (``ragged_args``, else cut from ``args``), for the box-decided kernels
    on a call of 4k + 1 / 4k + 3 lanes (``odd_args``, else cut from
    ``args``), and on each call of ``extra``
    ({label: args}, each also timed with its tile decisions held to the
    mirror's); kernel, plain, composite and bound times. Every query meets
    every data point, so the operations over all pairs are the same
    whatever the data; the box-decided kernels also report the pairs their
    decisions leave."""
    import torch

    kernel = getattr(dense_kernels, name).wrapped
    plain = dense_kernels.PLAIN[name]

    def compare(a):
        got, want = kernel(*a), plain(*a)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        torch.cuda.synchronize()
        err = 0.0
        for g, w in zip(got, want):
            same = (torch.equal(g.view(torch.int32), w.view(torch.int32))
                    if g.dtype == torch.float32 else torch.equal(g, w))
            if not same:
                raise AssertionError(f"{name}: kernel != plain version "
                                     f"({int((g != w).sum())} of {g.numel()})")
            err = max(err, float((g.double() - w.double()).nan_to_num(0.0)
                                 .abs().max()))
        return err

    if ragged_args is None:
        ragged_args = dense_ragged_args(name, args)
    err = max(compare(args), compare(ragged_args))
    tiles = None
    if name in BOXED:
        # a cloud of 4k + 1 / 4k + 3 lanes (padded to 16-byte rows), a call
        # whose tiles are skipped and taken whole, one whose data lanes are
        # shuffled (no tile decided): all bitwise
        decided, shuffled = decided_args(name, args), shuffled_args(name, args)
        odd = (dense_ragged_args(name, args, 1001, 1499) if odd_args is None
               else odd_args)
        err = max(err, compare(odd), compare(decided), compare(shuffled))
        tiles = tile_stats(name, args, dense_kernels, kernel)
        tiles["odd_call"] = tile_stats(name, odd, dense_kernels, kernel)
        tiles["decided_call"] = tile_stats(name, decided, dense_kernels,
                                           kernel)
        tiles["shuffled_call"] = tile_stats(name, shuffled, dense_kernels,
                                            kernel)
        dec = tiles["decided_call"]
        if not (dec["tiles_skipped"] and dec["tiles_pairs"] and (
                dec["tiles_whole"] or name in MIN_LABEL + ("tile_nearest",))):
            raise AssertionError(f"{name}: the decided call decides "
                                 f"nothing: {dec}")
        kernel(*shuffled)
        tiles["pairs_ms"] = cuda_ms(lambda: kernel(*shuffled), 20)
        del decided, shuffled, odd
        for label, a in (extra or {}).items():
            err = max(err, compare(a))
            st = tile_stats(name, a, dense_kernels, kernel)
            st["ms"] = cuda_ms(lambda: kernel(*a), 20)
            st["device_ms"] = device_ms(lambda: kernel(*a), 20)
            nq_x, nd_x, ndim_x = (a[0].shape[1], a[1].shape[1],
                                  dense_ndim(name, a))
            st["shape"] = {"n_q": nq_x, "n_d": nd_x, "ndim": ndim_x}
            st["needed_share"] = st["needed_pairs"] / (nq_x * nd_x)
            st["bound_needed_ms"] = max(
                st["needed_pairs"] * (3 * ndim_x - 1 + EPILOGUE_OPS[name])
                / PEAK_FP32_FLOPS * 1e3,
                (4 * ndim_x * (nq_x + nd_x) + OUT_BYTES[name] * nq_x)
                / PEAK_HBM_BYTES * 1e3)
            tiles[label] = st
    ms = cuda_ms(lambda: kernel(*args), 20 if name in BOXED else 5)
    dev_ms = device_ms(lambda: kernel(*args), 20)
    plain_ms = cuda_ms(lambda: plain(*args), 1)
    composite = dense_composite(name, args)
    composite()
    library_ms = cuda_ms(composite, 3)
    torch.cuda.empty_cache()

    n_q = args[0].shape[1]
    n_d = n_q if name == "tile_min_label" else args[1].shape[1]
    ndim = dense_ndim(name, args)
    ops = n_q * n_d * (3 * ndim - 1 + EPILOGUE_OPS[name])
    in_bytes = 4 * ndim * (n_q + (0 if name == "tile_min_label" else n_d))
    if name == "tile_min_label":
        in_bytes += 8 * n_q                      # radii and labels
    elif name == "tile_min_label_qd":
        in_bytes += 4 * n_q + 8 * n_d            # radii and data labels
    t_ops = ops / PEAK_FP32_FLOPS * 1e3
    t_bytes = (in_bytes + OUT_BYTES[name] * n_q) / PEAK_HBM_BYTES * 1e3
    if tiles is not None:
        # the bound over the pairs the boxes leave to the pair loop
        t_needed = (tiles["needed_pairs"] * (3 * ndim - 1 + EPILOGUE_OPS[name])
                    / PEAK_FP32_FLOPS * 1e3)
        tiles["bound_needed_ms"] = max(t_needed, t_bytes)
        tiles["needed_share"] = tiles["needed_pairs"] / (n_q * n_d)
    return {"name": name, "route": "cuda",
            "source": "vilgod_tpu_torch/csrc/dense.cu",
            "replaces": REPLACES[name], "launches": 0, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library_ms,
            "shape": {"n_q": n_q, "n_d": n_d, "ndim": ndim, "pairs": n_q * n_d,
                      "device_ms": dev_ms,
                      "ragged_check": [ragged_args[0].shape[1],
                                       ragged_args[0 if name == "tile_min_label"
                                                   else 1].shape[1]]},
            "tiles": tiles}


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


def attention_split(args, vit_kernels):
    """``fused_attention_proj`` on ``args`` by part: the LayerNorm pass,
    the qkv GEMM, the attention core and the output GEMM, each timed alone
    (ms), the GEMMs' TFLOP/s and the other parts' GB/s (each input read
    once, each output written once)."""
    import torch

    x, lns, lnb, wq, bq, wo, bo, heads = args
    b, t, width = x.shape
    m = b * t
    x2 = x.reshape(m, width)
    h = vit_kernels.layernorm_cuda(x2, lns, lnb)
    qkv = vit_kernels.gemm_cuda(h, wq, bq)
    att = vit_kernels.attention_core_cuda(qkv, b, t, heads)
    parts = {
        "layernorm": (lambda: vit_kernels.layernorm_cuda(x2, lns, lnb),
                      0, 2 * x2.numel() * 2),
        "qkv_gemm": (lambda: vit_kernels.gemm_cuda(h, wq, bq),
                     2 * m * width * 3 * width, 0),
        "attention_core": (lambda: vit_kernels.attention_core_cuda(
            qkv, b, t, heads), 4 * b * t * t * width,
            (qkv.numel() + att.numel()) * 2),
        "out_gemm": (lambda: vit_kernels.gemm_cuda(att, wo, bo, res=x2),
                     2 * m * width * width, 0),
    }
    out = {"x": list(x.shape)}
    for part, (fn, flop, nbytes) in parts.items():
        fn()
        t_ms = cuda_ms(fn, 3)
        out[part] = {"ms": t_ms, "tflop_per_s": flop / t_ms / 1e9,
                     "gb_per_s": nbytes / t_ms / 1e6}
    del h, qkv, att
    torch.cuda.empty_cache()
    return out


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
    # the banded kernels' device time per launch, by template instance
    banded = {}
    for e in events:
        m = re.search(r"(count|min_label|nearest|fill)_kernel<[^>]*>", e.key)
        if m:
            banded[m.group(0)] = {"ms": dev_us(e) / 1e3, "calls": e.count,
                                  "us_per_call": dev_us(e) / e.count}
    return {"wall_s": wall, "stage_s": zsd.stage_times,
            "device_busy_s": busy_s,
            "device_busy_share": busy_s / wall if busy_s else None,
            "top": [{"name": e.key[:60], "ms": dev_us(e) / 1e3,
                     "calls": e.count} for e in top],
            "banded": banded}


def print_ptxas(lib_path, per_kernel=False):
    """The build's ptxas report: kernels, most registers, bytes spilled;
    with ``per_kernel`` a line per entry function and template instance
    (registers, spill stores, static shared memory). Returns {entry
    function and template arguments: registers} (empty without
    ``per_kernel``)."""
    ptxas = lib_path.with_suffix(".log")
    registers = {}
    if ptxas.exists():
        text = ptxas.read_text()
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
        spills = [int(b) for b in re.findall(r"(\d+) bytes spill stores", text)]
        log(f"ptxas {lib_path.name}: {len(regs)} kernels, max "
            f"{max(regs, default=0)} registers, {sum(spills)} bytes spilled")
        if per_kernel:
            for entry in text.split("Compiling entry function")[1:]:
                # the mangled name's length prefix, the name, its
                # template arguments (count3_kernel<6>, min_label_kernel<6>)
                fn = re.search(r"\d\d?((?:[a-z]+\d?_)+kernel)"
                               r"(?:I((?:Li\d+E)+)E)?", entry)
                reg = re.search(r"Used (\d+) registers", entry)
                spill = re.search(r"(\d+) bytes spill stores", entry)
                smem = re.search(r"(\d+) bytes smem", entry)
                name = fn.group(1) if fn else "?"
                if fn and fn.group(2):
                    name += f"<{', '.join(re.findall(r'\d+', fn.group(2)))}>"
                log(f"ptxas {name}: "
                    f"{reg.group(1) if reg else '?'} registers, "
                    f"{spill.group(1) if spill else '?'} bytes spill stores, "
                    f"{smem.group(1) if smem else 0} bytes static smem")
                if reg:
                    registers[name] = int(reg.group(1))
    return registers


def sass_per_pair(lib_path):
    """Per pair-loop kernel of the library at ``lib_path`` (banded.cu's
    kernels 1-4, dense.cu's 6-9) and ndim: the SASS instructions of the
    innermost loop that does the pair arithmetic (``cuobjdump -sass`` of
    the built library) over the pairs one trip of it serves. With -fmad=false each
    pair squares ndim differences with one FMUL each, so the pairs a trip
    serves are its FMULs over ndim; the loop is the innermost backward
    branch range with the most FMULs. Returns {kernel: {ndim: {"instr",
    "pairs", "per_pair", "fadd_per_pair"}}} (None where no loop parses)."""
    from vilgod_tpu_torch.utils.cuda_build import _nvcc
    tool = Path(_nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True).stdout
    library = lib_path.name[len("lib"):].split("_")[0]
    out = {}
    for section in text.split("Function : ")[1:]:
        fn = re.match(r"\S*?\d\d?((?:[a-z]+\d?_)+kernel)I((?:Li\d+E)+)E",
                      section)
        if not fn:
            continue
        targs = [int(t) for t in re.findall(r"\d+", fn.group(2))]
        ndim, nlev = targs[0], (targs[1] if len(targs) > 1 else None)
        names = [k for k, v in SASS_KERNELS.items()
                 if v == (library, fn.group(1), nlev)]
        if not names:
            continue
        ins = [(int(a, 16), op.strip()) for a, op in re.findall(
            r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", section)]
        loops = []
        for addr, op in ins:
            br = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", op)
            if br and int(br.group(1), 16) < addr:
                loops.append((int(br.group(1), 16), addr))
        inner = [(lo, hi) for lo, hi in loops
                 if not any(lo <= a and b <= hi and (a, b) != (lo, hi)
                            for a, b in loops)]
        best = None
        for lo, hi in inner:
            body = [op for a, op in ins if lo <= a <= hi]
            ops = [re.sub(r"^@!?U?P\w+\s+", "", op).split()[0]
                   for op in body]
            fmul = sum(o.split(".")[0] == "FMUL" for o in ops)
            fadd = sum(o.split(".")[0] == "FADD" for o in ops)
            if fmul and (best is None or fmul > best[1]):
                best = (len(body), fmul, fadd)
        row = None
        if best:
            pairs = best[1] / ndim
            row = {"instr": best[0], "pairs": pairs,
                   "per_pair": best[0] / pairs,
                   "fadd_per_pair": best[2] / pairs}
        for name in names:
            out.setdefault(name, {})[ndim] = row
    return out


def check_run_tool(out):
    """Phase 3c: the run tool on the card with ``profile_dir`` under
    ``out``; its trace must hold a span per stage, all nine, and its APs
    must be written. Returns the spans' seconds and the run's summary."""
    import numpy as np
    from vilgod_tpu_torch.tools import run as run_tool

    t0 = time.perf_counter()
    results = run_tool.main(RUN_TOOL_ARGS + [
        f"paths.results={out / 'results'}", f"profile_dir={out / 'trace'}"])
    wall = time.perf_counter() - t0
    traces = list((out / "trace").glob("*.trace.json"))
    if len(traces) != 1:
        raise AssertionError(f"run tool: {len(traces)} traces written")
    events = json.loads(traces[0].read_text())["traceEvents"]
    spans = {e["name"]: e["dur"] / 1e6 for e in events
             if e.get("cat") == "user_annotation"}
    missing = [s for s in STAGES if s not in spans]
    if missing:
        raise AssertionError(f"run tool: no trace span for {missing}")
    ap = json.loads((out / "results" / "ap_results.json").read_text())
    if len(results) != 8 or not all(np.isfinite(v) for v in ap.values()):
        raise AssertionError(f"run tool: {len(results)} frames, APs {ap}")
    return {"wall_s": wall, "frames": len(results),
            "detections": int(sum(len(r["name"]) for r in results)),
            "trace_mib": traces[0].stat().st_size / 2 ** 20,
            "device_events": sum(1 for e in events
                                 if e.get("cat") == "kernel"),
            "span_s": {k: spans[k] for k in STAGES}}


def check_first_frames(a, b, card_emb, cpu_emb, card_clip, cpu_clip):
    """The 4-frame check: card state ``a`` against CPU state ``b``."""
    import numpy as np
    import torch

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


def check_box_stages(a, b, results_a, results_b, ap_a, ap_b):
    """Stages 5 and 7-9 on the card (``a``) and on the CPU (``b``) from the
    same stage 1-4 checkpoint."""
    import numpy as np

    for field in ("det_tid", "det_valid", "det_cls", "det_static_track"):
        if not np.array_equal(getattr(a, field), getattr(b, field)):
            raise AssertionError(f"card != CPU in {field} (stages 5, 7-9)")
    ta, tb = a.tracks.serialize(), b.tracks.serialize()
    for k in ta:
        if not np.array_equal(ta[k], tb[k]):
            raise AssertionError(f"card != CPU in the track pool's {k}")
    nan_a, nan_b = np.isnan(a.det_box), np.isnan(b.det_box)
    box_err = float(np.abs(np.where(nan_a, 0, a.det_box)
                           - np.where(nan_b, 0, b.det_box)).max())
    if not np.array_equal(nan_a, nan_b) or box_err > 1e-4:
        raise AssertionError(f"card != CPU det_box: {box_err} m")
    per_a = [len(r["name"]) for r in results_a]
    per_b = [len(r["name"]) for r in results_b]
    if per_a != per_b:
        raise AssertionError(f"card != CPU boxes per frame: {per_a} vs {per_b}")
    ap_err = max(abs(ap_a[k] - ap_b[k]) for k in ap_a)
    if ap_a.keys() != ap_b.keys() or ap_err > 1e-6:
        raise AssertionError(f"card != CPU APs: {ap_err}")
    log("card vs CPU, stages 5 and 7-9: " + json.dumps({
        "frames": a.n_frames, "tracks": int(len(a.tracks.valid_tracks())),
        "boxes": int(sum(per_a)), "det_box_max_err_m": box_err,
        "ap_max_err": ap_err}))


def score(results, ds):
    """The port's Waymo-protocol APs of ``results`` against the scene's
    ground truth, in bench.py's range."""
    from vilgod_tpu_torch.eval import evaluate_detections

    seq = ds.sequence("synth_0")
    gt = [seq.get_annos(f) for f in range(seq.sequence_length)]
    return evaluate_detections(results, gt, eval_range=EVAL_RANGE)


def ap_summary(ap):
    return {cls: ap[f"OBJECT_TYPE_TYPE_{cls.upper()}_LEVEL_2/AP"]
            for cls in ("Vehicle", "Pedestrian", "Cyclist")}


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
    from vilgod_tpu_torch.ops import dense_kernels, kernels
    from vilgod_tpu_torch.pipeline.runner import (ZeroShotDetector,
                                                  run_sequences)
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
    libraries = [kernels.LIBRARY, vit_kernels.LIBRARY, dense_kernels.LIBRARY]
    paths = build_all(libraries)
    for lib in libraries:
        lib.load()
    log(f"build: {time.perf_counter() - t0:.2f} s -> "
        f"{', '.join(p.name for p in paths)}")
    registers = [print_ptxas(path, per_kernel=True) for path in paths]
    # kernel 8's pair loop (dense.cu, ndim 5): with the same SASS a pair,
    # ptxas's allotment of 61 registers ran it 10-16 % slower than the 72
    # or more that run it at its old time; no launch bound can raise an
    # allotment, so the build is held to it here
    k8_regs = registers[2].get("min_label_kernel<5>", 0)
    assert k8_regs >= K8_MIN_REGISTERS, (
        f"dense.cu min_label_kernel<5> got {k8_regs} registers, below the "
        f"{K8_MIN_REGISTERS} that run kernel 8 at its measured time")
    for path in (paths[0], paths[2]):
        for name, by_ndim in sass_per_pair(path).items():
            log(f"sass {name} (instructions of the pair loop per pair, by "
                f"ndim): " + json.dumps(by_ndim))

    cfg = waymo_config(capacity=CAPS, pipeline_active=STAGES)
    ds = SyntheticDataset(**SCENE)
    first = FirstFrames(ds.sequence("synth_0"), CHECK_FRAMES)
    recorder = Recorder(kernels)
    dense_rec = DenseRecorder(dense_kernels)
    vit_rec = VitRecorder(vit_kernels)
    n_frames = SCENE["n_frames"]
    work = Path(tempfile.mkdtemp(dir=paths[0].parent))

    try:
        # ---- 2. card half of the 4-frame card-vs-CPU check (warm-up) ----
        check_cfg = waymo_config(capacity=CAPS, pipeline_active=CHECK_STAGES)
        t0 = time.perf_counter()
        card_clip, card_emb = clip_check_model("cuda"), []
        vit_rec.watch(card_clip, card_emb)
        card_state, _ = run_detector(first, check_cfg, "cuda", card_clip)
        log(f"card run of the first {CHECK_FRAMES} frames: "
            f"{time.perf_counter() - t0:.2f} s")

        # ---- 3. the main path: nine stages ----
        t0 = time.perf_counter()
        clip_model = ClipWrapper(cfg["preprocessor"]["clip"],
                                 dtype=torch.bfloat16, seed=0)
        vit_rec.watch(clip_model)
        log(f"ClipWrapper ViT-B/16 bf16 on the card: "
            f"{time.perf_counter() - t0:.2f} s")
        torch.cuda.reset_peak_memory_stats()
        times = {}
        cache = work / "main"
        for mod in (kernels, vit_kernels, dense_kernels):
            mod.reset_launches()
        recorder.active = vit_rec.active = True
        t0 = time.perf_counter()
        results = run_sequences(ds, cfg, clip_model=clip_model,
                                cache_dir=cache, stage_times=times,
                                device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        recorder.active = vit_rec.active = False
        launches = {**kernels.LAUNCHES, **vit_kernels.LAUNCHES}
        st = SequenceState.allocate("synth_0", n_frames,
                                    Capacity.from_cfg(cfg), device="cpu")
        assert st.load(cache / "synth_0.npz"), "no checkpoint written"
        stage_s = sum(times.values())
        dets = (st.det_n > 0).sum(axis=1)
        valid = st.det_valid
        n_layers = clip_model.model_cfg.vision_layers
        n_boxes = [len(r["name"]) for r in results]
        log("main path stage seconds: " + json.dumps(times))
        log("main path: " + json.dumps({
            "frames": n_frames, "wall_s": wall, "stage_s": stage_s,
            "frames_per_s": n_frames / stage_s,
            "detections_per_frame": dets.tolist(),
            "valid_detections": int(valid.sum()),
            "tracks": int(len(st.tracks.valid_tracks())),
            "boxes_per_frame": n_boxes,
            "images_classified": vit_rec.images,
            "classify_calls": vit_rec.encode_calls,
            "ground_points_per_frame": float(st.ground_mask.sum() / n_frames),
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "launches": launches,
            "dense_launches": dict(dense_kernels.LAUNCHES)}))
        for name in kernels.KERNEL_NAMES:
            if launches[name] <= 0:
                raise AssertionError(f"{name} never launched on the main path")
        want = n_layers * vit_rec.encode_calls
        if vit_rec.encode_calls <= 0 or launches["fused_attention_proj"] != want:
            raise AssertionError(
                f"fused_attention_proj launched "
                f"{launches['fused_attention_proj']} times on the main path, "
                f"expected {want} ({n_layers} layers x {vit_rec.encode_calls} "
                f"classify calls)")
        boxes = np.concatenate([r["boxes_lidar"] for r in results])
        if not (set(times) == set(STAGES) and dets.min() > 0 and valid.any()
                and len(results) == n_frames and len(boxes) > 0
                and np.isfinite(boxes).all()
                and np.isfinite(st.det_center).all()
                and np.isfinite(st.plane_ref).all()
                and (st.det_cls[valid] != CLS_NONE).all()
                and ((st.det_score[valid] > 0)
                     & (st.det_score[valid] <= 1)).all()):
            raise AssertionError("main path output malformed")
        log("classes on the main path: " + json.dumps(
            np.bincount(st.det_cls[valid], minlength=4).tolist()))

        # the opt-in MLP kernels: one classify batch of the main path
        # through the tower with each switch
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
            log(f"{var}=1 on {x.shape[0]} images: {launches[name]} launches "
                f"of {name}, min cosine to the default tower {cos:.6f}")
            if launches[name] != n_layers:
                raise AssertionError(f"{name}: {launches[name]} launches with "
                                     f"{var}=1, expected {n_layers}")
        del x, base, out
        vit_rec.tower_input = None

        log("profile: " + json.dumps(profile_main_path(ds, cfg, clip_model)))

        # the geometry-only pass: stages 1-4 (their checkpoint kept for
        # phase 5), then the nine stages resumed from it without CLIP
        geo, stage4 = work / "geometry", work / "stage4"
        geo_times = {}
        run_sequences(ds, waymo_config(capacity=CAPS, pipeline_active=GEOMETRY),
                      cache_dir=geo, stage_times=geo_times, device="cuda")
        stage4.mkdir()
        shutil.copy(geo / "synth_0.npz", stage4 / "synth_0.npz")
        zsd = ZeroShotDetector(ds.sequence("synth_0"), "synth_0", cfg,
                               clip_model=None, cache_dir=geo, device="cuda")
        geo_results = zsd.process()
        geo_state = zsd.state
        geo_times.update({k: v for k, v in zsd.stage_times.items()
                          if k not in GEOMETRY})
        geo_ap = score(geo_results, ds)
        log("geometry-only pass stage seconds: " + json.dumps(geo_times))
        log("geometry-only pass: " + json.dumps({
            "detections": int(sum(len(r["name"]) for r in geo_results)),
            "boxes_by_class": {str(k): int(v) for k, v in zip(*np.unique(
                np.concatenate([r["name"] for r in geo_results]),
                return_counts=True))},
            "boxes_per_frame": [len(r["name"]) for r in geo_results],
            "tracks": int(len(geo_state.tracks.valid_tracks())),
            "level_2_ap": ap_summary(geo_ap)}))

        # ---- 3b. the dense configuration ----
        dense_times = {}
        dense_kernels.reset_launches()
        dense_rec.active = True
        t0 = time.perf_counter()
        run_sequences(ds, dense_config(), stage_times=dense_times,
                      device="cuda")
        torch.cuda.synchronize()
        dense_wall = time.perf_counter() - t0
        dense_rec.active = False
        dense_launches = dict(dense_kernels.LAUNCHES)
        launches.update(dense_launches)
        log("dense configuration stage seconds: " + json.dumps(dense_times))
        log("dense configuration: " + json.dumps({
            "wall_s": dense_wall, "launches": dense_launches,
            "calls_by_ndim": {f"{k[0]}@ndim{k[1]}": v
                              for k, v in dense_rec.counts.items()},
            "args": {f"{k[0]}@ndim{k[1]}": [list(a.shape) for a in v[1]
                                            if hasattr(a, "shape")]
                     for k, v in dense_rec.calls.items()}}))
        # per frame: 8 window frames of entropy counts, one DBSCAN (its
        # 3-level count), its border attach and the label transfer
        for name, per_frame in (("tile_radius_count", 8),
                                ("tile_radius_count3", 1),
                                ("tile_nearest", 2)):
            if dense_launches[name] != per_frame * n_frames:
                raise AssertionError(
                    f"{name} launched {dense_launches[name]} times, expected "
                    f"{per_frame * n_frames} ({n_frames} frames x "
                    f"{per_frame})")
        if dense_launches["tile_min_label"] < n_frames:
            raise AssertionError(f"tile_min_label launched "
                                 f"{dense_launches['tile_min_label']} times, "
                                 f"expected >= {n_frames}")
        # the nearest: one 3-D label transfer and one 5-D border attach
        # (core points of the DBSCAN features) a frame
        by_ndim = {k[1]: v for k, v in dense_rec.counts.items()
                   if k[0] == "tile_nearest"}
        if by_ndim != {3: n_frames, 5: n_frames}:
            raise AssertionError(f"tile_nearest calls by ndim {by_ndim}, "
                                 f"expected {n_frames} at ndim 3 and 5")
        log("dense configuration profile (us per call): " + json.dumps(
            profile_dense(ds, dense_config(), dense_rec)))

        # ---- 3c. the run tool with a trace ----
        run_dir = work / "run_tool"
        log("run tool with profile_dir: " + json.dumps(
            check_run_tool(run_dir)))
        shutil.rmtree(run_dir)

        # ---- 4. kernels against their plain versions ----
        rows = []
        for name in kernels.KERNEL_NAMES:
            if name not in recorder.calls:
                raise AssertionError(f"{name}: no main-path call recorded")
            _, args, ends = recorder.calls[name]
            # few enough query blocks that every kernel splits its spans
            cols = min(args[0].shape[1], 65536) // 2048 * 2048
            row = check_kernel(name, args, kernels, cols, ends)
            row["launches"] = launches[name]
            rows.append(row)
            log(f"kernel {name}: " + json.dumps(row))
        # kernel 12 has no caller: its arguments are cut from the largest
        # banded min-label call of the main path
        _, args, ends = recorder.calls["banded_tile_min_label"]
        qd_args, qd_ragged = min_label_qd_args(args, ends), min_label_qd_ragged(args)
        qd_odd = min_label_qd_ragged(args, 1001, 1499)
        recorder.calls.clear()
        for name in dense_kernels.KERNEL_NAMES:
            if name == "tile_min_label_qd":
                row = check_dense_kernel(name, qd_args, dense_kernels,
                                         qd_ragged, odd_args=qd_odd)
                row["launches"] = launches.get(name, 0)
                rows.append(row)
                log(f"kernel {name} (no caller; 0 launches on the main "
                    f"path): " + json.dumps(row))
                continue
            extra = ({"border_attach": dense_rec.calls[("tile_nearest", 5)][1]}
                     if name == "tile_nearest" else None)
            row = check_dense_kernel(name, dense_rec.largest(name),
                                     dense_kernels, extra=extra)
            row["launches"] = launches[name]
            rows.append(row)
            log(f"kernel {name}: " + json.dumps(row))
        del qd_args, qd_ragged, qd_odd
        dense_rec.calls.clear()
        for name in vit_kernels.KERNEL_NAMES:
            if name not in vit_rec.calls:
                raise AssertionError(f"{name}: no call recorded")
            if name == "fused_attention_proj":
                log("kernel fused_attention_proj by part: " + json.dumps(
                    attention_split(vit_rec.calls[name], vit_kernels)))
            row = check_vit_kernel(name, vit_rec.calls.pop(name), vit_kernels)
            row["launches"] = launches[name]
            rows.append(row)
            log(f"kernel {name}: " + json.dumps(row))
            torch.cuda.empty_cache()

        # ---- 5. CPU halves of the card-vs-CPU checks ----
        t0 = time.perf_counter()
        cpu_clip, cpu_emb = clip_check_model("cpu"), []
        vit_rec.watch(cpu_clip, cpu_emb)
        cpu_state, _ = run_detector(first, check_cfg, "cpu", cpu_clip)
        log(f"CPU run of the first {CHECK_FRAMES} frames: "
            f"{time.perf_counter() - t0:.2f} s")
        check_first_frames(card_state, cpu_state, card_emb, cpu_emb,
                           card_clip, cpu_clip)

        t0 = time.perf_counter()
        zc = ZeroShotDetector(ds.sequence("synth_0"), "synth_0", cfg,
                              clip_model=None, cache_dir=stage4, device="cpu")
        cpu_results = zc.process()
        log(f"CPU run of stages 5 and 7-9 over {n_frames} frames: "
            f"{time.perf_counter() - t0:.2f} s "
            + json.dumps({k: v for k, v in zc.stage_times.items()
                          if k not in GEOMETRY}))
        check_box_stages(geo_state, zc.state, geo_results, cpu_results,
                         geo_ap, score(cpu_results, ds))
    finally:
        shutil.rmtree(work, ignore_errors=True)

    print(smi)
    print(json.dumps({"kernels": [
        {k: v for k, v in r.items() if k not in ("shape", "tiles")}
        for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
