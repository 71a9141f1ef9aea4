"""One run of a cell: set-up, the measured window over the program's
``run_sequences``, the samples its check needs, and (``--trace 1``) one
sequence again under the device profiler.

The window runs whole sequences back to back through
``vilgod_tpu_torch.pipeline.run_sequences`` (the users' entry, with its
prefetch of the next sequence) and closes at the end of the first
sequence that ends at or after ``seconds``: a sequence has no finished
frame before its end. The harness observes the program from outside: a
subclass of ``ZeroShotDetector`` notes each finished sequence, a
subclass of ``ClipWrapper`` keeps each classifier call's per-view
answers, and a wrapper around each stage of the runner's registry notes
the detection table at the classifier's start and end (and, in the
traced pass, puts a marker kernel on the device at each stage's start).
"""
from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from vilgod_tpu_torch.models import vit_kernels
from vilgod_tpu_torch.models.clip import CLIPConfig, CLIPModel
from vilgod_tpu_torch.models.clip_wrapper import ClipWrapper
from vilgod_tpu_torch.ops import dense_kernels, kernels
from vilgod_tpu_torch.pipeline import run_sequences, runner
from vilgod_tpu_torch.pipeline.stages_geometry import frame_bucket
from vilgod_tpu_torch.utils import cuda_build

from . import cell as cells
from . import scenes
from .reference.geometry import cluster_window, window_frames
from .weights import make_weights

WARMUP_FRAMES = 24


class WindowClosed(Exception):
    """Raised after the window's last sequence to leave ``run_sequences``."""


def process_age_s() -> float:
    """Seconds since this process started (Linux ``/proc``)."""
    with open("/proc/self/stat") as f:
        start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


class Recorder:
    """What the hooks note. ``mode``: None (warm-up: nothing), "window" or
    "traced"."""

    def __init__(self, seed: int, workload: dict, seconds: float, sync,
                 n_window: int):
        self.seed, self.workload, self.seconds = seed, workload, seconds
        self.sync, self.n_window = sync, n_window
        self.mode = None
        self.t_open = self.t_close = None
        self.observe_s = 0.0                # inside the window, in extract
        self.peak_bytes = None
        self.sequences: list[dict] = []     # finished window sequences
        self.current: dict | None = None    # the sequence being processed
        self.traced_calls: list[int] = []   # items per classifier call
        self.marker = None                  # traced pass: marks a stage

    # -- hooks ---------------------------------------------------------
    def stage_start(self, name, state):
        if self.marker is not None:
            self.marker()
        if self.mode == "window" and name == "classification":
            self.current["valid_at_classify"] = state.det_valid.copy()

    def stage_end(self, name, state):
        if self.mode != "window":
            return
        if name == "filter_detections":
            self.current["valid_filter"] = state.det_valid.copy()
            self.current["det_n"] = state.det_n.copy()
        elif name == "classification":
            self.current["cls"] = state.det_cls.copy()
            self.current["score"] = state.det_score.copy()

    def classifier_call(self, frame_ids, cluster_ids, idx, score):
        if self.mode == "window":
            self.current["views"].append(
                (np.array(frame_ids).copy(), np.array(cluster_ids).copy(),
                 idx, score))
        elif self.mode == "traced":
            self.traced_calls.append(len(frame_ids))

    def sequence_start(self, name):
        if self.mode == "window":
            self.current = {"name": name, "views": []}

    def sequence_end(self, zsd):
        if self.mode != "window":
            return
        self.sync()
        t = time.perf_counter()
        seq = self.current
        seq.update(frames=zsd.state.n_frames,
                   stage_times=dict(zsd.stage_times), t_end=t)
        closing = t - self.t_open >= self.seconds
        if closing:
            self.t_close = t
            if torch.cuda.is_available():
                self.peak_bytes = torch.cuda.max_memory_allocated()
        self.extract(zsd.state, seq, len(self.sequences))
        if not closing:
            self.observe_s += time.perf_counter() - t
        self.sequences.append(seq)
        self.current = None
        if closing:
            raise WindowClosed

    # -- the samples of the check ----------------------------------------
    def extract(self, state, seq: dict, k: int):
        """Copy to the host what the check compares, for samples drawn from
        the seed: frames whose clustering is checked, each with the next
        frame of its cluster window, and the entropy windows of both;
        frames whose filter is checked; the ground masks and non-ground
        buffers of all of them, their entropy scores and labels; and the
        raw indices of the points of sampled classified detections. Its
        time inside the window is left out of the window's."""
        chk = self.workload["check"]
        rng = np.random.default_rng([self.seed % (2**62), k])
        n_f = state.n_frames
        f_pad = frame_bucket(n_f)
        n_pts, n_ng = state.points_bucket(), state.ng_bucket()
        cap_ng = state.caps.max_ng_points
        picks = sorted(int(f) for f in rng.choice(
            n_f, size=min(chk["entropy_frames"] + chk["filter_frames"], n_f),
            replace=False))
        cluster_frames = sorted(int(f) for f in rng.choice(
            picks, size=min(chk["entropy_frames"], len(picks)),
            replace=False))
        filter_frames = [f for f in picks if f not in cluster_frames]
        ent_frames = sorted({g for f in cluster_frames
                             for g in cluster_window(f, n_f, self.n_window)})
        rows = sorted({w for f in ent_frames for w in window_frames(f, n_f)[0]}
                      | set(ent_frames) | set(filter_frames))
        dev = state.torch_device
        ridx = torch.tensor(rows, device=dev)
        eidx = torch.tensor(ent_frames, device=dev)
        lidx = torch.tensor(cluster_frames + filter_frames, device=dev)
        host = lambda t, i: t[i].cpu().numpy()  # noqa: E731
        seq["rows"] = rows
        seq["ground"] = host(state.device("ground_mask", f_pad, n_pts), ridx)
        seq["ng_src"] = host(state.device("ng_src", f_pad, cap_ng), ridx)
        seq["ng_mask"] = host(state.device("ng_mask", f_pad, cap_ng), ridx)
        seq["ng_xyz"] = host(state.device("ng_xyz", f_pad, cap_ng), ridx)
        seq["entropy_frames"] = ent_frames
        seq["entropy"] = host(state.device("ng_entropy", f_pad, n_ng), eidx)
        seq["cluster_frames"] = cluster_frames
        seq["filter_frames"] = filter_frames
        seq["labels"] = dict(zip(cluster_frames + filter_frames, host(
            state.device("labels", f_pad, n_ng), lidx)))
        seq["plane"] = state.plane_ref[filter_frames].copy()
        seq["points_bucket"] = n_pts
        seq["ng_bucket"] = n_ng
        seq["det_n_max"] = int((state.det_n > 0).sum(axis=1).max())
        seq["tracks_used"] = int(state.det_tid.max()) + 1
        seq["cluster_points_max"] = int(state.det_n.max())
        seq["clusters_over_cap"] = int(
            (state.det_n > state.caps.max_cluster_points).sum())
        seq["raw_points_max"] = int(state.points_mask.sum(axis=1).max())
        seq["ng_points_max"] = int(state._ng_counts.max())

        # the classifier's answers, per view, as the program gave them
        views = {}
        for fids, cids, idx, score in seq.pop("views"):
            idx, score = idx.cpu().numpy(), score.cpu().numpy()
            for j, (f, c) in enumerate(zip(fids, cids)):
                if c >= 0:
                    views[(int(f), int(c))] = (idx[j], score[j])
        seq["view_answers"] = views
        valid = seq.get("valid_at_classify")
        todo = ([] if valid is None else
                [(int(f), int(c)) for f, c in zip(*np.nonzero(valid))])
        seq["classified"] = todo
        sample = []
        if todo:
            pick = rng.choice(len(todo), size=min(chk["detections"],
                                                  len(todo)), replace=False)
            sample = [todo[i] for i in sorted(pick)]
            largest = max(todo, key=lambda fc: state.det_n[fc])
            if largest not in sample:
                sample.append(largest)
        seq["sample"] = sample
        if sample:
            cap = state.caps.max_cluster_points
            fs = torch.tensor([f for f, _ in sample], device=state.torch_device)
            cs = torch.tensor([c for _, c in sample], device=state.torch_device)
            labels = state.device("labels", f_pad, n_ng)[fs]
            mask = state.device("ng_mask", f_pad, cap_ng)[fs][:, :n_ng]
            pos = torch.arange(n_ng, device=fs.device).expand(len(sample), -1)
            key = torch.where((labels == cs[:, None]) & mask, pos, n_ng)
            first = key.sort(dim=1).values[:, :cap]
            src = state.device("ng_src", f_pad, cap_ng)[fs]
            raw = torch.gather(src, 1, first.clamp(max=n_ng - 1))
            seq["sample_raw"] = torch.where(first < n_ng, raw, -1).cpu().numpy()


@contextlib.contextmanager
def hooks(rec: Recorder):
    """The runner's detector class and stage registry replaced by
    recording ones while inside."""
    class Detector(runner.ZeroShotDetector):
        def process(self, spans=False):
            rec.sequence_start(self.name)
            out = super().process(spans)
            rec.sequence_end(self)
            return out

    def wrap(name, fn):
        def stage(state, cfg, **kw):
            rec.stage_start(name, state)
            out = fn(state, cfg, **kw)
            rec.stage_end(name, state)
            return out
        return stage

    registry = dict(runner.STAGE_REGISTRY)
    runner.STAGE_REGISTRY.update(
        {k: wrap(k, v) for k, v in registry.items()})
    original, runner.ZeroShotDetector = runner.ZeroShotDetector, Detector
    try:
        yield
    finally:
        runner.ZeroShotDetector = original
        runner.STAGE_REGISTRY.update(registry)


def build_clip(rec: Recorder, config, cfg, seed, device):
    """The program's classifier over the seeded weights, the tower in the
    configuration's type; its cluster classifier reports every call."""
    class RecordingClip(ClipWrapper):
        def make_cluster_classifier(self, **kw):
            run = super().make_cluster_classifier(**kw)

            def recorded(ng_xyz, tables, table_masks, frame_ids, cluster_ids,
                         transforms):
                idx, score = run(ng_xyz, tables, table_masks, frame_ids,
                                 cluster_ids, transforms)
                rec.classifier_call(frame_ids, cluster_ids, idx, score)
                return idx, score
            return recorded

    t = config["clip"]
    model_cfg = CLIPConfig(**{k: v for k, v in t.items() if k != "dtype"},
                           dtype=getattr(torch, t["dtype"]))
    with torch.device(device):
        model = CLIPModel(model_cfg)
    model.load_state_dict(make_weights(t, seed, device))
    return RecordingClip(cfg["preprocessor"]["clip"], model=model,
                         model_cfg=model_cfg, device=device)


def launches() -> dict:
    return {**kernels.LAUNCHES, **dense_kernels.LAUNCHES,
            **vit_kernels.LAUNCHES}


def start_frames(workload: dict, seed: int, workers: int | None = None
                 ) -> scenes.Pending:
    """Start making the frames of the cell's sequences in workers."""
    return scenes.start_sequences(workload["scene"], seed,
                                  workload["sequences"], workers=workers)


def run(cell_name: str, seed: int, seconds: float, trace: bool, device,
        workers: int | None = None, root=cells.ROOT,
        pending: scenes.Pending | None = None) -> dict:
    """Set-up, window, (traced pass,) samples. Returns the run's record:
    the window's numbers, the recorder, the made sequences, and with
    ``trace`` the traced pass's events. ``pending``: the frames, already
    being made (:func:`start_frames`)."""
    workload, config, limits = cells.load(cell_name, root)
    if pending is None:
        pending = start_frames(workload, seed, workers)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    cfg = cells.program_config(config)
    rec = Recorder(seed, workload, seconds, sync,
                   config["clustering"]["n_frames"])

    parts = {"start": process_age_s()}
    seqs = pending.result()
    parts["frames"] = process_age_s()
    clip = build_clip(rec, config, cfg, seed, dev)
    parts["tower"] = process_age_s()
    # warm-up: the cell's own scene cut to its first frames
    warm = scenes.Dataset([seqs[0].head(WARMUP_FRAMES)], n_names=1)
    run_sequences(warm, cfg, clip_model=clip, device=dev)
    parts["warm_up"] = process_age_s()
    builds_setup = dict(cuda_build.BUILDS)
    loads_setup = dict(cuda_build.LOADS)
    launches0 = launches()

    dataset = scenes.Dataset(seqs)
    with hooks(rec):
        sync()
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        setup_s = process_age_s()
        rec.mode = "window"
        rec.t_open = time.perf_counter()
        try:
            run_sequences(dataset, cfg, clip_model=clip, device=dev)
            raise RuntimeError("the window outlasted its sequences")
        except WindowClosed:
            pass
        rec.mode = None
    window_launches = {k: v - launches0[k] for k, v in launches().items()}
    out = dict(workload=workload, config=config, limits=limits, cfg=cfg,
               rec=rec, seqs=seqs, setup_s=setup_s, setup_parts=parts,
               window_s=rec.t_close - rec.t_open - rec.observe_s,
               builds_setup=builds_setup,
               window_builds={k: v - builds_setup.get(k, 0)
                              for k, v in cuda_build.BUILDS.items()
                              if v != builds_setup.get(k, 0)},
               window_loads={k: v - loads_setup.get(k, 0)
                             for k, v in cuda_build.LOADS.items()
                             if v != loads_setup.get(k, 0)},
               launches=window_launches, clip=clip)
    if trace:
        out["traced"] = traced_pass(rec, cfg, clip, seqs[0], dev)
    return out


def traced_pass(rec, cfg, clip, seq, dev) -> dict:
    """The window's first sequence once more, under the device profiler
    (the card's activity only), a marker kernel at each stage's start and
    at the end; its wall beside the window's untraced one."""
    zsd = runner.ZeroShotDetector(seq, "traced", cfg, clip_model=clip,
                                  device=dev)
    torch.cuda.synchronize(dev)
    rec.mode = "traced"
    rec.marker = lambda: torch.cuda._sleep(1)
    k5 = vit_kernels.LAUNCHES["fused_attention_proj"]
    with hooks(rec), profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        zsd.process()
        rec.marker()
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    rec.mode, rec.marker = None, None
    return dict(events=[(e.name(), e.start_ns(), e.end_ns())
                        for e in prof.profiler.kineto_results.events()
                        if str(e.device_type()).endswith("CUDA")],
                wall_s=wall, frames=seq.sequence_length,
                stages=list(cfg["pipeline_active"]),
                classifier_items=list(rec.traced_calls),
                k5_launches=vit_kernels.LAUNCHES["fused_attention_proj"] - k5)
