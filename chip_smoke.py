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
3d. the real-data path: phase 3's scene written to a Waymo OpenPCDet
   layout by the port's ``export_pseudo_dataset`` (its GT as the labels,
   its object indices as track ids; bytes and seconds printed) and read
   back (timed), then ``tools.run``'s ``main`` on the card with
   ``preprocessor=waymo paths.data=... split=pseudo`` at phase 3's caps,
   nine stages and ViT-B/16 bf16 random-weight tower, its launch counts
   zeroed just before and read just after (kernels 1-4 each launched,
   ``fused_attention_proj`` as often as in phase 3). Its ground masks,
   labels, detections, track ids and classes must equal phase 3's, its
   boxes within 1e-4 m and scores within 1e-4 (the frames are the same
   after ``set_frame``'s 5 mm quantisation); ``tools.evaluate``'s ``main``
   with ``--cluster-eval`` re-scores its result files to its
   ``ap_results.json`` within 1e-6; its detections written by
   ``export_pseudo_labels`` read back with the same boxes. One line with
   the stage seconds, frames/s, export and load seconds and the APs
   against both GTs, beside the card's name and power limit;
3e. the tools and the chained ground scan, each number beside the card's
   name and power limit: (a) ``tools.parity_oracle.measure_delta_ap`` on
   phase 3's scene at its caps on the card (kernels 1-4 each launched, the
   counts zeroed just before and read just after): detections on both
   sides, ``delta_ap_max`` <= 0.5, and 0.0 where no cluster truncates; the
   per-class APs and ``n_truncated`` printed; (c) the chained ground scan
   (``segment_sequence_chained``, k = 3) on phase 3's 24 frames: the
   card's masks equal the card's per-chunk scans and the CPU's chained
   scan exactly; (d) ``tools.microbench``'s ground (presort, scan, the
   chained scan at k = 1 and 3), cluster (selection, paged DBSCAN and its
   count3, min-label, propagation with its rounds, and nearest passes,
   the kNN transfer) and classify (rendering, ViT-B/16 encode at
   ``clip_batch`` 512) sections on phase 3's inputs, one line per part
   with the kernel launches in it; (b) ``tools.soak``: two 199-frame
   sequences (seeds 21, 22) at the full caps, stages 1-5 and 7-9 (kernels
   1-4 each launched): no capacity saturated, detections in the last 50
   frames, no nvcc build or library load in the second, its peak memory
   within 5 % of the first's; cold and warm frames/s, peaks and stage
   seconds printed, and the chained scan timed at k = 1, 5, 25 on the
   first sequence's 200-frame bucket (phase 3g (f) also runs on that
   sequence's state, its launches kept out of the soak's);
3f. the multi-device layer (``vilgod_tpu_torch.parallel``) on the one
   card, its shards logical shards of cuda:0 (``parallel.local_devices``
   replaced for the phase), on the parity scene at 32 frames (a shard of
   16 holds the 15-frame window) at phase 3's caps: (b) the nine stages
   through ``run_sequences`` with phase 3's ViT-B/16 tower, on one device
   and over 2 shards with ``shard_ground`` off (the sharded entropy,
   clustering, filter and classification taken; kernels 1-5 each launched
   in the sharded run): ground masks, entropy, labels, probabilities,
   detections, planes and track ids equal; classes equal but where the
   two runs' winning scores lie within ``TIE_TOL`` (JAX's tie rule; each
   flip printed); boxes of the detections whose classes agree within
   ``BOX_TOL`` m; launches per stage of both runs, and stage seconds of
   both, run again in the other order (one device, 2 shards, 2 shards,
   one device; the dense configuration too); then
   stage 1 over 2 shards with ``shard_ground`` on: its masks equal the
   per-chunk scans; (a) each sharded function on 2 and 4 shards on the
   arguments the one-device run gave its counterpart, held to that
   counterpart's output: ``sharded_entropy`` (2 shards, the 32 real
   frames and 31 in the 32-frame bucket; 4 shards of 8 frames must raise)
   bit-equal, ``sharded_ground`` equal to the per-chunk scans,
   ``sharded_cluster_chunk`` and ``sharded_filter_metrics`` bit-equal,
   ``global_detection_count`` the count; (c) the dense configuration's
   stages 1-3 on one device and over 2 shards: equal, kernels 6-9 each
   launched in the sharded run;
3g. the C++ ground oracle and the debug tools of vilgod_tpu_torch/tools,
   one JSON line each with the card's name and power limit and its
   seconds: (a) ``tools.ground_oracle``: the oracle (``ground/native``,
   built with g++ into ``build/native/``) against ``segment_ground`` on
   the card in tests/test_ground_native.py's four cases and bounds
   (recall > 0.9, false positives < 0.15, IoU > 0.97, sensor height within
   0.2 m of 1.723, agreement > 0.999 on each of 6 frames); (b)
   ``debug_ground_scale`` at f_pad 24, 48, 64 and 200 (presort, scan and
   fused, cold and warm; each run's masks equal to its scan's and to the
   first frames of the 200-frame run's); (c) ``debug_band_width`` on phase
   3's chunk input: kernels 2-4 with ``ends`` at band widths 8192, 10240,
   14336 and 20480, the outputs of every width without overflow equal
   (integers exactly, squared distances bitwise on valid lanes); (d)
   ``debug_cluster_stepwise`` at 200 frames; (e) ``debug_cluster_crash``
   at 64 frames; (f) ``debug_soak_cluster --launch`` on the soak's first
   200-frame state (every chunk's spans and overflow flags, then its
   run), taken in phase 3e through the soak's ``inspect`` hook;
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
   the same way; the ViT kernels also on a ragged batch of 3 images and
   ``fused_attention_proj`` on 16 images of 257 tokens (its two-pass core;
   the main path's 197 take the one-pass core) (assert_close rtol 1.6e-2,
   atol 1e-2, mean |diff| < 1e-3), with a line that splits
   ``fused_attention_proj`` into its LayerNorm pass, qkv GEMM, attention
   core and output GEMM (ms, TFLOP/s, GB/s, bound, and each part's
   PyTorch counterpart timed alone); kernel, plain, torch-composite and
   bound times; then two public ops no stage calls, on the card and on
   the CPU: ``entropy_scores_window`` of one main-path non-ground frame
   against the entropy stage's 15-frame window (each window frame's count
   equal, scores within 1e-6, the kernel it launched reported) and
   ``knn`` with k = 8 of that frame against the next (indices equal,
   squared distances bitwise equal);
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
import logging
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
# phase 4's entropy_scores_window: the entropy stage's 15-frame window of
# the main path and the query frame's place in it
ENTROPY_WINDOW = 15
ENTROPY_SEEK = 7
CHECK_FRAMES = 4
# phase 3e: the soak's length (a Waymo sequence, the 200-frame bucket), the
# chained scan's k on that bucket, the microbench's timed repetitions, and
# the ground stage's z offset
SOAK_FRAMES = 199
SOAK_CHAINS = (1, 5, 25)
MICROBENCH_REPS = 2
Z_OFFSET = 1.723
# phase 3g: the debug tools' frame counts (tools/debug_*.py defaults, the
# ground scale also at the soak's 200-frame bucket)
GROUND_SCALE_FPADS = (24, 48, 64, 200)
STEPWISE_FRAMES = 200
CRASH_FRAMES = 64
# phase 3f: the parity scene at 32 frames (a shard of 2 holds the 15-frame
# window), the logical shards of the one card, and the tolerances of the
# sharded classification (JAX's tie rule of tests/test_parallel.py: a
# class may flip only where the two runs' winning scores lie this close)
SHARD_FRAMES = 32
SHARDS = (2, 4)
TIE_TOL = 1e-4
BOX_TOL = 1e-4
# the state fields each stage decides, as phase 3f compares them
STAGE_FIELDS = {
    "mask_ground_points": ("ground_mask",),
    "calculate_entropy_scores": ("ng_entropy",),
    "spatial_clustering": ("labels", "probs", "det_n", "det_center",
                           "det_static"),
    "filter_detections": ("det_valid", "plane_ref"),
    "track_clusters": ("det_tid",),
    "classification": ("det_cls", "det_score"),
    "evaluate_sequence": ("det_box", "det_cls", "det_valid"),
}
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


def long_sequence(args, n_images=16, t=257, seed=0):
    """The attention call's weights on ``n_images`` images of ``t`` tokens
    (ViT-L/14's length: past the one-pass core's 208, the two-pass core)
    drawn from ``seed``."""
    import torch

    x = args[0]
    gen = torch.Generator(device=x.device).manual_seed(seed)
    xl = torch.randn(n_images, t, x.shape[-1], device=x.device,
                     generator=gen).mul_(0.5).to(x.dtype)
    return (xl, *args[1:])


def check_vit_kernel(name, args, vit_kernels):
    """Kernel vs plain version on the main path's ``args``, on a ragged
    batch of 3 images and, for the attention, on 16 images of 257 tokens;
    kernel, plain, composite and bound times."""
    import torch

    kernel = getattr(vit_kernels, name).wrapped
    plain = vit_kernels.PLAIN[name]
    err, mean_err = 0.0, 0.0
    calls = [args, ragged(name, args)]
    if name == "fused_attention_proj":
        calls.append(long_sequence(args))
    for a in calls:
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
    (ms), with its TFLOP/s and GB/s (each input read once, each output
    written once), its bound (the larger of the operations over the bf16
    peak and the bytes over the memory rate) and its PyTorch counterpart
    timed alone on the same inputs (``library_ms``: ``F.layer_norm``,
    ``F.linear``, ``F.scaled_dot_product_attention`` on (B, heads, T, 64)
    views of qkv, ``F.linear`` plus the residual), never called by the
    port."""
    import torch
    import torch.nn.functional as F

    x, lns, lnb, wq, bq, wo, bo, heads = args
    b, t, width = x.shape
    m = b * t
    x2 = x.reshape(m, width)
    h = vit_kernels.layernorm_cuda(x2, lns, lnb)
    qkv = vit_kernels.gemm_cuda(h, wq, bq)
    att = vit_kernels.attention_core_cuda(qkv, b, t, heads)
    wq_t, wo_t = wq.t().contiguous(), wo.t().contiguous()
    lns16, lnb16 = lns.to(x.dtype), lnb.to(x.dtype)
    q, k, v = qkv.view(b, t, 3, heads, -1).unbind(2)
    q, k, v = (a.transpose(1, 2) for a in (q, k, v))

    def size(*tensors):
        return sum(a.numel() * a.element_size() for a in tensors)

    # part: (kernel, library call, operations, bytes)
    parts = {
        "layernorm": (lambda: vit_kernels.layernorm_cuda(x2, lns, lnb),
                      lambda: F.layer_norm(x2, (width,), lns16, lnb16,
                                           eps=1e-5),
                      0, size(x2, lns, lnb, h)),
        "qkv_gemm": (lambda: vit_kernels.gemm_cuda(h, wq, bq),
                     lambda: F.linear(h, wq_t, bq),
                     2 * m * width * 3 * width, size(h, wq, bq, qkv)),
        "attention_core": (lambda: vit_kernels.attention_core_cuda(
            qkv, b, t, heads), lambda: F.scaled_dot_product_attention(
                q, k, v), 4 * b * t * t * width, size(qkv, att)),
        "out_gemm": (lambda: vit_kernels.gemm_cuda(att, wo, bo, res=x2),
                     lambda: F.linear(att, wo_t, bo) + x2,
                     2 * m * width * width,
                     size(att, wo, bo, x2) + size(x2)),  # + the output
    }
    out = {"x": list(x.shape)}
    for part, (fn, library, flop, nbytes) in parts.items():
        fn()
        t_ms = cuda_ms(fn, 3)
        library()
        t_ops = flop / PEAK_BF16_FLOPS * 1e3
        t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
        out[part] = {"ms": t_ms, "tflop_per_s": flop / t_ms / 1e9,
                     "gb_per_s": nbytes / t_ms / 1e6,
                     "bound_ms": max(t_ops, t_bytes),
                     "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                     "library_ms": cuda_ms(library, 3)}
    del h, qkv, att, q, k, v
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


class StageSeconds(logging.Handler):
    """Keeps the run tool's logged ``Stage seconds: {...}``."""

    PREFIX = "Stage seconds: "

    def __init__(self):
        super().__init__()
        self.seconds = None

    def emit(self, record):
        msg = record.getMessage()
        if msg.startswith(self.PREFIX):
            self.seconds = json.loads(msg[len(self.PREFIX):])


def export_parity_scene(ds, root):
    """Phase 3d, export: the scene's frames and poses into a Waymo
    OpenPCDet layout under ``root`` by the port's ``export_pseudo_dataset``,
    its GT as the labels and its object indices as track ids. Returns
    (bytes written, seconds)."""
    import numpy as np
    from vilgod_tpu_torch.data import export_pseudo_dataset

    seq = ds.sequence("synth_0")
    labels, tids = [], []
    for f in range(seq.sequence_length):
        gt = seq.get_annos(f)
        labels.append({"boxes_lidar": gt["gt_boxes_lidar"],
                       "name": gt["gt_names"],
                       "score": np.ones(len(gt["gt_names"]), np.float32),
                       "moving": gt["moving"]})
        tids.append(np.arange(len(gt["gt_names"])))
    t0 = time.perf_counter()
    export_pseudo_dataset(ds, {"synth_0": labels}, root,
                          track_ids_by_sequence={"synth_0": tids})
    seconds = time.perf_counter() - t0
    return sum(p.stat().st_size for p in root.rglob("*") if p.is_file()), seconds


def check_real_data_run(a, b, results_a, results_b):
    """Phase 3d against phase 3 on the same card: state ``b`` and results
    ``results_b`` of the run from disk, ``a`` and ``results_a`` of the run
    on the generator's frames. Integers equal, boxes within 1e-4 m, scores
    within 1e-4. Returns the largest box and score differences."""
    import numpy as np

    for field in ("ground_mask", "labels", "det_n", "det_valid", "det_tid",
                  "det_cls", "det_static", "det_static_track"):
        if not np.array_equal(getattr(a, field), getattr(b, field)):
            raise AssertionError(f"real-data run != main path in {field}")
    if len(results_a) != len(results_b):
        raise AssertionError(f"real-data run: {len(results_b)} frames, "
                             f"main path {len(results_a)}")
    box_err = score_err = 0.0
    for f, (ra, rb) in enumerate(zip(results_a, results_b)):
        if not (np.array_equal(ra["name"], rb["name"])
                and np.array_equal(ra["moving"], rb["moving"])):
            raise AssertionError(f"real-data run != main path in frame {f}'s "
                                 f"names or moving flags")
        if len(ra["name"]):
            box_err = max(box_err, float(np.abs(
                np.asarray(ra["boxes_lidar"]) - rb["boxes_lidar"]).max()))
            score_err = max(score_err, float(np.abs(
                np.asarray(ra["score"]) - rb["score"]).max()))
    if box_err > 1e-4 or score_err > 1e-4:
        raise AssertionError(f"real-data run != main path: boxes {box_err} m, "
                             f"scores {score_err}")
    return box_err, score_err


def rescore(results_dir, root):
    """Phase 3d, re-score: the port's evaluate CLI with ``--cluster-eval``
    on the run's result files. Returns (APs, its per-sequence line)."""
    import contextlib
    import io
    from vilgod_tpu_torch.tools import evaluate as evaluate_tool

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        ap = evaluate_tool.main(["--results", str(results_dir), "--data",
                                 str(root), "--split", "pseudo",
                                 "--cluster-eval"])
    line = next((ln for ln in out.getvalue().splitlines()
                 if ln.startswith("synth_0:")), None)
    if line is None:
        raise AssertionError("evaluate --cluster-eval printed no sequence line")
    return ap, line


def check_label_round_trip(root, results):
    """Phase 3d, round trip: the run's detections written by
    ``export_pseudo_labels`` over the reloaded split and read back hold the
    same names and boxes, as numpy only."""
    import pickle

    import numpy as np
    from vilgod_tpu_torch.data import WaymoSequenceDataset, export_pseudo_labels

    path = export_pseudo_labels(WaymoSequenceDataset(root, split="pseudo"),
                                {"synth_0": results}, root / "pseudo_labels.pkl")
    with open(path, "rb") as f:
        infos = pickle.load(f)
    if len(infos) != len(results):
        raise AssertionError(f"pseudo labels: {len(infos)} frames")
    for info, r in zip(infos, results):
        annos = info["annos"]
        boxes = np.asarray(r["boxes_lidar"], np.float32).reshape(-1, 7)
        if not (type(annos["gt_boxes_lidar"]) is np.ndarray
                and np.array_equal(annos["gt_boxes_lidar"], boxes)
                and np.array_equal(annos["name"], r["name"])):
            raise AssertionError(f"pseudo labels of {info['frame_id']} differ "
                                 f"from the run's detections")
    return path.stat().st_size


def check_real_data_path(ds, cfg, real, st, results, main_attention,
                         main_ap, smi):
    """Phase 3d: the parity scene exported to a Waymo layout under
    ``real``, read back (timed), run through the run tool's ``main`` on the
    card at the main path's caps and nine stages with its launch counts
    zeroed just before and read just after (kernels 1-4 each launched,
    ``fused_attention_proj`` as often as on the main path), held to the
    main path's state ``st`` and ``results``, re-scored by the evaluate CLI
    (its APs equal ``ap_results.json`` to 1e-6) and written as pseudo
    labels and read back. Returns the phase's summary."""
    import torch
    from vilgod_tpu_torch.data import WaymoSequenceDataset
    from vilgod_tpu_torch.models import vit_kernels
    from vilgod_tpu_torch.ops import dense_kernels, kernels
    from vilgod_tpu_torch.pipeline.state import Capacity, SequenceState
    from vilgod_tpu_torch.tools import run as run_tool

    n_frames = len(results)
    t_phase = time.perf_counter()
    export_bytes, export_s = export_parity_scene(ds, real / "data")
    t0 = time.perf_counter()
    lseq = WaymoSequenceDataset(real / "data", split="pseudo").sequence(
        "synth_0")
    for f in range(lseq.sequence_length):
        lseq.get_lidar_points(f)
    load_s = time.perf_counter() - t0
    stage_log = StageSeconds()
    logging.getLogger("vilgod_tpu_torch").addHandler(stage_log)
    for mod in (kernels, vit_kernels, dense_kernels):
        mod.reset_launches()
    t0 = time.perf_counter()
    try:
        real_results = run_tool.main([
            "preprocessor=waymo", f"paths.data={real / 'data'}",
            "split=pseudo", f"paths.results={real / 'results'}",
            f"paths.sequence_data={real / 'cache'}",
            f"capacity={CAPS!r}", f"pipeline_active={STAGES!r}"])
        torch.cuda.synchronize()
    finally:
        logging.getLogger("vilgod_tpu_torch").removeHandler(stage_log)
    wall = time.perf_counter() - t0
    launches = {**kernels.LAUNCHES, **vit_kernels.LAUNCHES,
                **dense_kernels.LAUNCHES}
    for name in kernels.KERNEL_NAMES:
        if launches[name] <= 0:
            raise AssertionError(f"{name} never launched on the real-data "
                                 f"path")
    if launches["fused_attention_proj"] != main_attention:
        raise AssertionError(
            f"fused_attention_proj launched {launches['fused_attention_proj']}"
            f" times on the real-data path, {main_attention} on the main path")
    real_st = SequenceState.allocate("synth_0", n_frames,
                                     Capacity.from_cfg(cfg), device="cpu")
    if not real_st.load(real / "cache" / "synth_0.npz"):
        raise AssertionError("real-data path: no checkpoint written")
    box_err, score_err = check_real_data_run(st, real_st, results,
                                             real_results)
    written = json.loads((real / "results" / "ap_results.json").read_text())
    rescored, cluster_line = rescore(real / "results", real / "data")
    rescore_err = max(abs(rescored[k] - written[k]) for k in written)
    if rescored.keys() != written.keys() or rescore_err > 1e-6:
        raise AssertionError(f"evaluate re-score != ap_results.json: "
                             f"{rescore_err}")
    labels_bytes = check_label_round_trip(real / "data", real_results)
    stage_s = sum(stage_log.seconds.values())
    return {"device": smi, "phase_s": time.perf_counter() - t_phase,
            "frames": n_frames, "export_bytes": export_bytes,
            "export_s": export_s, "load_s": load_s, "wall_s": wall,
            "stage_s": stage_log.seconds, "stage_sum_s": stage_s,
            "frames_per_s": n_frames / stage_s, "launches": launches,
            "box_max_err_m": box_err, "score_max_err": score_err,
            "rescore_ap_max_err": rescore_err,
            "pseudo_labels_bytes": labels_bytes, "cluster_eval": cluster_line,
            "level_2_ap_exported_gt": ap_summary(written),
            "level_2_ap_main_path_synthetic_gt": ap_summary(main_ap)}


def check_delta_ap(cfg, ds, kernels, smi):
    """Phase 3e (a): the port's ``measure_delta_ap`` on phase 3's scene at
    the full caps on the card, its launch counts zeroed just before and
    read just after (kernels 1-4 each launched)."""
    from vilgod_tpu_torch.tools.parity_oracle import measure_delta_ap

    kernels.reset_launches()
    t0 = time.perf_counter()
    out = measure_delta_ap(cfg, ds, "synth_0", device="cuda")
    seconds = time.perf_counter() - t0
    launched = dict(kernels.LAUNCHES)
    for name in kernels.KERNEL_NAMES:
        if launched[name] <= 0:
            raise AssertionError(f"{name} never launched in measure_delta_ap")
    if not (out["n_dets_table"] > 0 and out["n_dets_oracle"] > 0
            and out["delta_ap_max"] <= 0.5):
        raise AssertionError(f"measure_delta_ap out of bounds: {out}")
    if out["n_truncated"] == 0 and out["delta_ap_max"] != 0.0:
        raise AssertionError(f"no cluster truncated, yet the table and the "
                             f"oracle part: {out}")
    return {"device": smi, "seconds": seconds, "launches": launched, **out}


def check_chained(points, mask, gcfg, smi, k=3):
    """Phase 3e (c): on the main path's frames the card's chained scan
    (k chains) equals the card's per-chunk scans exactly and the CPU's
    chained scan."""
    import torch
    from vilgod_tpu_torch.ground.patchwork import (segment_sequence,
                                                   segment_sequence_chained)

    f = points.shape[0]
    step = f // k
    card = segment_sequence_chained(points, mask, gcfg, Z_OFFSET, k)
    chunks = torch.cat([segment_sequence(points[i:i + step],
                                         mask[i:i + step], gcfg,
                                         Z_OFFSET)[0]
                        for i in range(0, f, step)])
    t0 = time.perf_counter()
    cpu = segment_sequence_chained(points.cpu(), mask.cpu(), gcfg, Z_OFFSET,
                                   k)
    cpu_s = time.perf_counter() - t0
    single = segment_sequence(points, mask, gcfg, Z_OFFSET)[0]
    if not torch.equal(card, chunks):
        raise AssertionError(f"chained scan (k={k}) differs from the per-chunk "
                             f"scans on {int((card != chunks).sum())} points")
    if not torch.equal(card.cpu(), cpu):
        raise AssertionError(f"chained scan (k={k}) differs card vs CPU on "
                             f"{int((card.cpu() != cpu).sum())} points")
    return {"device": smi, "frames": f, "chains": k,
            "ground_points": int((card & mask).sum()),
            "differ_from_single_scan": int(((card != single) & mask).sum()),
            "cpu_s": cpu_s}


def check_soak_cluster(state, kernels, smi):
    """Phase 3g (f): ``tools.debug_soak_cluster`` with ``--launch`` on the
    soak's first 200-frame state (from the soak's ``inspect`` hook, so that
    stages 1-2 over 200 frames run once): every chunk's window dissection,
    then each chunk's ``cluster_frames_chunk``. Returns its summary, with
    the launches it made."""
    from vilgod_tpu_torch.tools import debug_soak_cluster

    before = dict(kernels.LAUNCHES)
    t0 = time.perf_counter()
    out = debug_soak_cluster.run(state.n_frames, launch=True, state=state)
    seconds = time.perf_counter() - t0
    return {"device": smi, "seconds": seconds, **out,
            "overflow": sorted({k for c in out["chunks"]
                                for k, (_, o) in c["spans"].items() if o}),
            "launches": {k: v - before[k] for k, v in kernels.LAUNCHES.items()
                         if v > before[k]}}


def check_debug_tools(geo_state, cfg, soak_cluster, smi):
    """Phase 3g: the native ground oracle and the debug tools of
    ``vilgod_tpu_torch/tools`` on the card, one JSON line each with the
    card's name and power limit: (a) ``tools.ground_oracle`` (the C++
    oracle against ``segment_ground`` on the card, tests/test_ground_native
    .py's bounds), (b) ``debug_ground_scale`` at f_pad 24, 48, 64 and 200
    (each f_pad's masks equal to the first frames of the 200-frame run's),
    (c) ``debug_band_width`` on phase 3's chunk input (the outputs of
    every width without overflow equal), (d) ``debug_cluster_stepwise`` at
    200 frames, (e) ``debug_cluster_crash`` at 64 frames; (f) ran inside
    phase 3e's soak (``soak_cluster``). Returns the phase's summary."""
    import torch
    from vilgod_tpu_torch.tools import (debug_band_width, debug_cluster_crash,
                                        debug_cluster_stepwise,
                                        debug_ground_scale, ground_oracle)

    seconds = {"f": soak_cluster["seconds"]}

    def part(key, label, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds[key] = time.perf_counter() - t0
        log(f"3g ({key}) {label}: " + json.dumps(
            {"device": smi, "seconds": seconds[key], **out}))
        torch.cuda.empty_cache()

    part("a", "native ground oracle against segment_ground",
         lambda: ground_oracle.run("cuda"))

    def ground_scale():
        rows, masks = debug_ground_scale.run(GROUND_SCALE_FPADS, device="cuda")
        last = masks[max(GROUND_SCALE_FPADS)]
        for fp, m in masks.items():
            if not torch.equal(m, last[:fp]):
                raise AssertionError(f"debug_ground_scale: the {fp}-frame "
                                     f"masks differ from the first {fp} "
                                     f"frames of the longest run's")
        return {"rows": rows}

    part("b", "debug_ground_scale", ground_scale)

    def band_width():
        out = debug_band_width.run(geo_state, cfg, device="cuda")
        return {"rows": out["rows"],
                "equal_across": debug_band_width.check_widths(out)}

    part("c", "debug_band_width", band_width)
    part("d", "debug_cluster_stepwise", lambda: {
        k: v for k, v in debug_cluster_stepwise.run(
            STEPWISE_FRAMES, device="cuda").items() if k != "det_n"})
    part("e", "debug_cluster_crash",
         lambda: debug_cluster_crash.run(CRASH_FRAMES, "cuda"))
    log("3g (f) debug_soak_cluster --launch on the soak's 200-frame state: "
        + json.dumps(soak_cluster))
    return {"device": smi, "phase_s": sum(seconds.values()),
            "seconds": seconds}


def check_tools(ds, cfg, geo_state, kernels, smi, soak_cluster):
    """Phase 3e: the tools of ``vilgod_tpu_torch/tools`` and the chained
    ground scan on the card: (a) the oracle's dAP, (c) the chained scan's
    masks, (d) the microbench's ground (with the chained scan at k = 1, 3),
    cluster and classify sections on phase 3's inputs, (b) the 199-frame
    soak, with the chained scan timed at k = 1, 5, 25 on its first
    sequence's 200-frame bucket and phase 3g (f) run on that sequence's
    state (its summary into ``soak_cluster``). Returns the phase's
    summary."""
    import torch
    from vilgod_tpu_torch.tools import microbench, soak

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    delta = check_delta_ap(cfg, ds, kernels, smi)
    log("3e (a) measure_delta_ap: " + json.dumps(delta))

    points, mask, gcfg = microbench.ground_inputs(geo_state, cfg)
    chained = check_chained(points, mask, gcfg, smi)
    log("3e (c) chained scan masks: " + json.dumps(chained))
    del points, mask

    rows = []
    for section in (microbench.bench_ground, microbench.bench_cluster,
                    microbench.bench_classify):
        rows += section(geo_state, cfg, MICROBENCH_REPS, dev)
        torch.cuda.empty_cache()
    log("3e (d) microbench: " + json.dumps({"device": smi, "rows": rows}))

    bucket_rows = []

    def time_chains(seed, state):
        if seed == soak.SEEDS[0]:
            pts, msk, g = microbench.ground_inputs(state, soak.build_cfg(False))
            bucket_rows.extend(microbench.chained_rows(
                pts, msk, g, SOAK_CHAINS, MICROBENCH_REPS, dev))
            del pts, msk
            soak_cluster.update(check_soak_cluster(state, kernels, smi))

    kernels.reset_launches()
    report = soak.soak(soak.build_cfg(False), soak.FULL_SCENE, SOAK_FRAMES,
                       dev, inspect=time_chains)
    # phase 3g (f)'s launches ran inside the soak's hook
    launched = {k: v - soak_cluster["launches"].get(k, 0)
                for k, v in kernels.LAUNCHES.items()}
    for name in kernels.KERNEL_NAMES:
        if launched[name] <= 0:
            raise AssertionError(f"{name} never launched in the soak")
    log("3e (b) soak: " + json.dumps({**report, "launches": launched}))
    log("3e (c) chained scan on the soak's 200-frame bucket: "
        + json.dumps({"device": smi, "rows": bucket_rows}))
    return {"device": smi, "phase_s": time.perf_counter() - t_phase,
            "delta_ap_max": delta["delta_ap_max"],
            "n_truncated": delta["n_truncated"],
            "soak_frames_per_s": [report["cold"]["frames_per_s"],
                                  report["warm"]["frames_per_s"]],
            "soak_peak_gib": [report["cold"]["peak_gib"],
                              report["warm"]["peak_gib"]],
            "chained_ms": {r["part"]: r["ms"] for r in rows + bucket_rows
                           if "chained" in r["part"]}}


def launch_counts(mods):
    return {k: v for m in mods for k, v in m.LAUNCHES.items()}


class StageRecord:
    """While entered, each stage of the runner's registry records, after it
    runs, the kernel launches it made and host copies of the state fields
    it decides (``STAGE_FIELDS``)."""

    def __init__(self, mods):
        from vilgod_tpu_torch.pipeline.runner import STAGE_REGISTRY
        self.registry, self.mods = STAGE_REGISTRY, mods
        self.fields, self.launches = {}, {}

    def __enter__(self):
        self.saved = dict(self.registry)
        for name, fn in self.saved.items():
            self.registry[name] = self._wrap(name, fn)
        return self

    def __exit__(self, *exc):
        self.registry.update(self.saved)

    def _wrap(self, name, fn):
        import numpy as np

        def run(state, cfg, **kw):
            before = launch_counts(self.mods)
            fn(state, cfg, **kw)
            after = launch_counts(self.mods)
            self.launches[name] = {k: after[k] - before[k] for k in after
                                   if after[k] != before[k]}
            self.fields[name] = {f: np.array(getattr(state, f))
                                 for f in STAGE_FIELDS.get(name, ())}
        return run


class Patched:
    """While entered, ``module.<name>`` of each name is replaced: by
    ``value`` where one is given, else by a spy that records each call's
    arguments and result in ``calls[name]`` and passes it through."""

    def __init__(self, module, names, value=None):
        self.module, self.names, self.value = module, names, value
        self.calls = {n: [] for n in names}

    def __enter__(self):
        self.saved = {n: getattr(self.module, n) for n in self.names}
        for n, fn in self.saved.items():
            setattr(self.module, n, self.value if self.value is not None
                    else self._spy(n, fn))
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.module, n, fn)

    def _spy(self, name, fn):
        def run(*args, **kw):
            out = fn(*args, **kw)
            self.calls[name].append((args, kw, out))
            return out
        return run


def shards_of(d):
    """``parallel.local_devices`` giving ``d`` logical shards of cuda:0."""
    import torch
    return lambda device: [torch.device("cuda", 0)] * d


def check_same(name, a, b):
    """Bit-equal (NaN where NaN), else fail with the count that differ."""
    import torch
    a, b = (torch.as_tensor(x).cpu() for x in (a, b))
    if a.shape != b.shape:
        raise AssertionError(f"{name}: shapes {tuple(a.shape)} and "
                             f"{tuple(b.shape)}")
    differ = a != b
    if a.is_floating_point():
        differ &= ~(torch.isnan(a) & torch.isnan(b))
    if bool(differ.any()):
        raise AssertionError(f"{name}: sharded differs from the single "
                             f"device on {int(differ.sum())} values")


def timed(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def check_sharded_functions(calls, parallel, stages_geometry, smi):
    """Phase 3f (a): each sharded function of ``vilgod_tpu_torch.parallel``
    on meshes of 2 and 4 logical shards of cuda:0, on the arguments the
    single-device run of the 32-frame scene gave its counterparts
    (``calls``), against that counterpart on the card."""
    import torch
    from vilgod_tpu_torch.ground.patchwork import segment_sequence
    from vilgod_tpu_torch.ops.entropy import entropy_sequence

    mesh = {d: parallel.make_mesh(devices=shards_of(d)(None)) for d in SHARDS}
    out = {"device": smi}

    (frames, masks, fv), kw, single = calls["entropy_sequence"][0]
    ent = {"window": kw["window"], "single_s": None}
    masks31, fv31 = masks.clone(), fv.clone()
    masks31[SHARD_FRAMES - 1] = False
    fv31[SHARD_FRAMES - 1] = False
    for f_real, m, v, want in ((SHARD_FRAMES, masks, fv, single),
                               (SHARD_FRAMES - 1, masks31, fv31, None)):
        if want is None:
            want, ent["single_s"] = timed(
                lambda: entropy_sequence(frames, m, v, **kw))
        got, sec = timed(lambda: parallel.sharded_entropy(
            mesh[2], frames, m, f_real=f_real, **kw))
        check_same(f"sharded_entropy (D=2, f_real {f_real})", got, want)
        ent[f"d2_f_real_{f_real}_s"] = sec
    try:
        parallel.sharded_entropy(mesh[4], frames, masks, **kw)
    except ValueError as e:
        ent["d4_raises"] = str(e)
    else:
        raise AssertionError("sharded_entropy took 4 shards of 8 frames, "
                             "fewer than the window")
    out["sharded_entropy"] = ent

    (points, mask, gcfg, z), _, _ = calls["segment_sequence"][0]
    ground = {}
    for d in SHARDS:
        step = points.shape[0] // d
        want, ground[f"per_chunk_d{d}_s"] = timed(lambda: torch.cat([
            segment_sequence(points[i:i + step], mask[i:i + step], gcfg,
                             z)[0] for i in range(0, points.shape[0], step)]))
        got, ground[f"d{d}_s"] = timed(lambda: parallel.sharded_ground(
            mesh[d], points, mask, gcfg, z))
        check_same(f"sharded_ground (D={d})", got, want)
        ground[f"d{d}_ground_points"] = int((got & mask).sum())
        if d == 2:
            out["per_chunk_d2"] = want & mask
    out["sharded_ground"] = ground

    args, kw, single = calls["cluster_frames_chunk"][0]
    cluster = {"pages": kw["chunk"]}
    for d in SHARDS:
        got, cluster[f"d{d}_s"] = timed(lambda: parallel.sharded_cluster_chunk(
            mesh[d], stages_geometry.cluster_frames_chunk, args[:4], args[4],
            args[5], args[6], **kw))
        for name, a, b in zip(("labels", "probs", "det_n", "det_center",
                               "det_static", "table"), got, single):
            check_same(f"sharded_cluster_chunk (D={d}) {name}", a, b)
    out["sharded_cluster_chunk"] = cluster

    args, kw, single = calls["filter_metrics_all"][0]
    got, sec = timed(lambda: parallel.sharded_filter_metrics(mesh[2], *args,
                                                             **kw))
    for k in single:
        check_same(f"sharded_filter_metrics {k}", got[k], single[k])
    out["sharded_filter_metrics"] = {"d2_s": sec, "fields": sorted(single)}

    det_valid = torch.as_tensor(calls["det_valid"]).cuda()
    total = int(parallel.global_detection_count(mesh[2], det_valid))
    if total != int(det_valid.sum()):
        raise AssertionError(f"global_detection_count {total} != "
                             f"{int(det_valid.sum())}")
    out["global_detection_count"] = total
    return out


def check_multi_device(clip_model, mods, smi):
    """Phase 3f: the multi-device layer on the one card, its shards logical
    shards of cuda:0 (``parallel.local_devices`` replaced): (a) each
    sharded function against its single-device counterpart, (b) the nine
    stages through ``run_sequences`` on the 32-frame parity scene, once on
    one device and once over 2 shards (``shard_ground`` off), then stage 1
    over 2 shards with ``shard_ground`` on, and (c) the dense
    configuration's stages 1-3 on one device and over 2 shards. Returns the
    phase's summary."""
    import numpy as np
    import torch
    from vilgod_tpu_torch import parallel
    from vilgod_tpu_torch.config import waymo_config
    from vilgod_tpu_torch.data import SyntheticDataset
    from vilgod_tpu_torch.pipeline import stages_geometry
    from vilgod_tpu_torch.pipeline.runner import run_sequences

    t_phase = time.perf_counter()
    ds = SyntheticDataset(**{**SCENE, "n_frames": SHARD_FRAMES})
    kernels, vit_kernels, dense_kernels = mods
    sharded_names = ("sharded_ground", "sharded_entropy",
                     "sharded_cluster_chunk", "sharded_filter_metrics")

    def run(cfg, d, clip=None, spy=()):
        """One run_sequences of ``ds``: stage seconds, launches per stage
        and in all, the fields each stage decided, the sharded functions
        called and the calls of ``spy`` (stages_geometry's)."""
        for m in mods:
            m.reset_launches()
        times = {}
        with Patched(parallel, ("local_devices",), shards_of(d)), \
                Patched(parallel, sharded_names) as taken, \
                Patched(stages_geometry, spy) as spied, \
                StageRecord(mods) as rec:
            t0 = time.perf_counter()
            run_sequences(ds, cfg, clip_model=clip, stage_times=times,
                          prefetch_next=False, device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        return {"stage_s": times, "wall_s": wall,
                "launches_by_stage": rec.launches,
                "launches": launch_counts(mods),
                "sharded_calls": {k: len(v) for k, v in taken.calls.items()
                                  if v}}, rec.fields, spied.calls

    def fields(rec, pairs):
        return {f: rec[s][f] for s, f in pairs}

    # (b) the nine stages, one device then 2 shards; (a)'s arguments come
    # from the single-device run
    off = waymo_config(capacity=CAPS, pipeline_active=STAGES,
                       parallel={"shard_ground": False})
    single, single_rec, calls = run(off, 1, clip_model, spy=(
        "segment_sequence", "entropy_sequence", "cluster_frames_chunk",
        "filter_metrics_all"))
    calls["det_valid"] = single_rec["filter_detections"]["det_valid"]
    sharded, sharded_rec, _ = run(off, 2, clip_model)
    # both once more in the other order: the first run is the coldest
    again = [run(off, d, clip_model)[0]["stage_s"] for d in (2, 1)]
    for label, times in (("one device", single["stage_s"]),
                         ("2 shards", sharded["stage_s"]),
                         ("2 shards, again", again[0]),
                         ("one device, again", again[1])):
        log(f"3f (b) stage seconds, {label}: " + json.dumps(times))
    log("3f (b) launches by stage, one device: "
        + json.dumps(single["launches_by_stage"]))
    log("3f (b) launches by stage, 2 shards: "
        + json.dumps(sharded["launches_by_stage"]))
    if set(sharded["sharded_calls"]) != set(sharded_names) - {"sharded_ground"}:
        raise AssertionError(f"sharded run took {sharded['sharded_calls']}")
    for name in list(kernels.KERNEL_NAMES) + ["fused_attention_proj"]:
        if sharded["launches"][name] <= 0:
            raise AssertionError(f"{name} never launched in the sharded run")
    for stage, names in STAGE_FIELDS.items():
        if stage in ("classification", "evaluate_sequence"):
            continue
        for f in names:
            check_same(f"{stage} {f}", sharded_rec[stage][f],
                       single_rec[stage][f])
    a, b = single_rec["classification"], sharded_rec["classification"]
    valid = single_rec["filter_detections"]["det_valid"]
    score_diff = np.abs(a["det_score"] - b["det_score"])[valid]
    flips = [(int(f), int(c), int(a["det_cls"][f, c]), int(b["det_cls"][f, c]),
              float(a["det_score"][f, c]), float(b["det_score"][f, c]))
             for f, c in zip(*np.nonzero(valid & (a["det_cls"]
                                                   != b["det_cls"])))]
    for flip in flips:
        log(f"3f (b) class flip at (frame, cluster) {flip[:2]}: {flip[2]} -> "
            f"{flip[3]}, scores {flip[4]} / {flip[5]}")
        if abs(flip[4] - flip[5]) > TIE_TOL:
            raise AssertionError(f"class flipped on untied scores: {flip}")
    a, b = single_rec["evaluate_sequence"], sharded_rec["evaluate_sequence"]
    agree = a["det_valid"] & b["det_valid"] & (a["det_cls"] == b["det_cls"])
    box_err = float(np.abs(a["det_box"][agree] - b["det_box"][agree]).max(
        initial=0.0))
    if box_err > BOX_TOL or np.isnan(box_err):
        raise AssertionError(f"boxes of agreeing detections {box_err} m apart")
    nine = {"frames": SHARD_FRAMES, "one_device": single, "shards_2": sharded,
            "valid_detections": int(valid.sum()), "class_flips": len(flips),
            "max_score_diff": float(score_diff.max(initial=0.0)),
            "max_box_err_m": box_err, "agreeing_boxes": int(agree.sum())}

    functions = check_sharded_functions(calls, parallel, stages_geometry, smi)
    per_chunk = functions.pop("per_chunk_d2")
    del calls
    log("3f (a) sharded functions: " + json.dumps(functions))

    on = waymo_config(capacity=CAPS, pipeline_active=STAGES[:1])
    ground_on, ground_rec, _ = run(on, 2)
    # the host mask is max_points wide, the scans the points bucket
    want = per_chunk.cpu().numpy()[:SHARD_FRAMES]
    got = ground_rec["mask_ground_points"]["ground_mask"]
    check_same("mask_ground_points with shard_ground (D=2) against the "
               "per-chunk scans", got[:, :want.shape[1]], want)
    nine["shard_ground_on"] = {
        "stage_s": ground_on["stage_s"],
        "sharded_calls": ground_on["sharded_calls"],
        "differ_from_single_scan": int(
            (got != single_rec["mask_ground_points"]["ground_mask"]).sum())}
    log("3f (b) nine stages: " + json.dumps({"device": smi, **nine}))

    # (c) the dense configuration, one device then 2 shards
    dense = dense_config()
    dense["parallel"] = {"shard_ground": False}
    d_single, d_single_rec, _ = run(dense, 1)
    d_sharded, d_sharded_rec, _ = run(dense, 2)
    d_again = [run(dense, d)[0]["stage_s"] for d in (2, 1)]
    for stage in STAGES[:3]:
        for f in STAGE_FIELDS[stage]:
            check_same(f"dense {stage} {f}", d_sharded_rec[stage][f],
                       d_single_rec[stage][f])
    for name in dense_kernels.KERNEL_NAMES[:4]:
        if d_sharded["launches"][name] <= 0:
            raise AssertionError(f"{name} never launched in the sharded dense "
                                 f"configuration")
    dense_out = {"device": smi, "one_device": d_single, "shards_2": d_sharded,
                 "stage_s_again": {"shards_2": d_again[0],
                                   "one_device": d_again[1]}}
    log("3f (c) dense configuration: " + json.dumps(dense_out))
    torch.cuda.empty_cache()
    # stage sums in run order: one device, 2 shards, 2 shards, one device
    return {"device": smi, "phase_s": time.perf_counter() - t_phase,
            "stage_s": [sum(t.values()) for t in (
                single["stage_s"], sharded["stage_s"], *again)],
            "class_flips": len(flips),
            "dense_stage_s": [sum(t.values()) for t in (
                d_single["stage_s"], d_sharded["stage_s"], *d_again)]}


def check_entropy_window(win, win_mask, seek, kernels, dense_kernels):
    """Phase 4: ``entropy_scores_window`` of frame ``seek`` against the
    window on the card and on the CPU: each window frame's count equal
    (recorded at the op's ``radius_count``), scores within 1e-6."""
    import torch
    from vilgod_tpu_torch.ops import entropy as entropy_mod

    radius_count = entropy_mod.radius_count
    counts = {}

    def run(device):
        got = counts.setdefault(device, [])

        def recording(*args, **kwargs):
            c = radius_count(*args, **kwargs)
            got.append(c.cpu())
            return c
        entropy_mod.radius_count = recording
        try:
            w, m = win.to(device), win_mask.to(device)
            t0 = time.perf_counter()
            h = entropy_mod.entropy_scores_window(w[seek], m[seek], w, m, seek)
            if device == "cuda":
                torch.cuda.synchronize()
            return h.cpu(), (time.perf_counter() - t0) * 1e3
        finally:
            entropy_mod.radius_count = radius_count

    run("cuda")                       # warm-up
    counts.clear()
    kernels.reset_launches()
    dense_kernels.reset_launches()
    card, card_ms = run("cuda")
    launched = {"banded_tile_count": kernels.LAUNCHES["banded_tile_count"],
                "tile_radius_count": dense_kernels.LAUNCHES["tile_radius_count"]}
    cpu, cpu_ms = run("cpu")
    a, b = torch.stack(counts["cuda"]), torch.stack(counts["cpu"])
    mismatches = int((a != b).sum())
    err = float((card - cpu).abs().max())
    if mismatches or err > 1e-6 or sum(launched.values()) != win.shape[0]:
        raise AssertionError(f"entropy_scores_window: {mismatches} counts "
                             f"differ, scores {err}, launches {launched}")
    return {"query": list(win[seek].shape), "window": list(win.shape),
            "seek": seek, "launches": launched, "count_mismatches": mismatches,
            "score_max_err": err, "card_ms": card_ms, "cpu_ms": cpu_ms}


def check_knn_k(q, qm, d, dm, k=8):
    """Phase 4: ``knn`` with k > 1 (plain torch: difference-form squared
    distances, packed-key top-k) on the card and on the CPU: equal
    indices, bitwise-equal squared distances (each product and sum is one
    IEEE-rounded elementwise op on both)."""
    import torch
    from vilgod_tpu_torch.ops import knn

    knn(q, qm, d, dm, k=k)            # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dc, ic = knn(q, qm, d, dm, k=k)
    torch.cuda.synchronize()
    card_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    dp, ip = knn(q.cpu(), qm.cpu(), d.cpu(), dm.cpu(), k=k)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    dc, ic = dc.cpu(), ic.cpu()
    if not (torch.equal(ic, ip) and torch.equal(dc, dp)):
        raise AssertionError(
            f"knn k={k}: card != CPU, {int((ic != ip).sum())} indices, "
            f"{int((dc != dp).sum())} squared distances")
    return {"k": k, "query": list(q.shape), "data": list(d.shape),
            "finite": int(torch.isfinite(dc).sum()), "card_ms": card_ms,
            "cpu_ms": cpu_ms}


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
    from vilgod_tpu_torch.pipeline.stages_geometry import frame_bucket
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
        main_attention = launches["fused_attention_proj"]
        main_ap = score(results, ds)
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
        # phase 4's entropy window and knn inputs: the main path's
        # world-frame non-ground frames at the entropy stage's bucket
        f_pad, n_ng = frame_bucket(n_frames), geo_state.ng_bucket()
        ng_xyz = geo_state.device("ng_xyz", f_pad, n_ng)[:ENTROPY_WINDOW].clone()
        ng_mask = geo_state.device("ng_mask", f_pad, n_ng)[:ENTROPY_WINDOW].clone()

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

        # ---- 3d. the real-data path: export, run from disk, re-score ----
        real = work / "real"
        log("real-data path: " + json.dumps(check_real_data_path(
            ds, cfg, real, st, results, main_attention, main_ap, smi)))
        shutil.rmtree(real)

        # ---- 3e. the tools and the chained ground scan ----
        soak_cluster = {}
        log("tools and chained scan: " + json.dumps(check_tools(
            ds, cfg, geo_state, kernels, smi, soak_cluster)))
        torch.cuda.empty_cache()

        # ---- 3f. the multi-device layer on logical shards of the card ----
        log("multi-device layer: " + json.dumps(check_multi_device(
            clip_model, (kernels, vit_kernels, dense_kernels), smi)))

        # ---- 3g. the native ground oracle and the debug tools ----
        log("native oracle and debug tools: " + json.dumps(check_debug_tools(
            geo_state, cfg, soak_cluster, smi)))
        del soak_cluster
        torch.cuda.empty_cache()

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
        # the public ops no stage calls: one main-path frame against the
        # entropy window, and its 8 nearest neighbours in the next frame
        log("entropy_scores_window card vs CPU: " + json.dumps(
            check_entropy_window(ng_xyz, ng_mask, ENTROPY_SEEK, kernels,
                                 dense_kernels)))
        log("knn k=8 card vs CPU: " + json.dumps(check_knn_k(
            ng_xyz[ENTROPY_SEEK], ng_mask[ENTROPY_SEEK],
            ng_xyz[ENTROPY_SEEK + 1], ng_mask[ENTROPY_SEEK + 1])))
        del ng_xyz, ng_mask
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
