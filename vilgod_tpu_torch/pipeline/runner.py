"""Config-driven pipeline runner (the ZeroShotDetector equivalent); the
port of ``vilgod_tpu/pipeline/runner.py``.

The pipeline is an ordered list of ``{name, args}`` entries in the config
and ``pipeline_active`` selects and orders execution; stage names resolve
through :data:`STAGE_REGISTRY`. Per-sequence stage outputs checkpoint to
one ``.npz`` in the JAX package's schema (stage-level resume). With
``profile_dir`` in the config each sequence's run writes a trace there
(:meth:`ZeroShotDetector.process`). Everything runs on ``cuda`` unless the
caller passes another ``device``.
"""
from __future__ import annotations

import contextlib
import logging
from pathlib import Path

import numpy as np
import torch

from ..utils import trace
from ..utils.common import resolve_device
from .stages_boxes import (evaluate_sequence, fit_bounding_boxes_simple,
                           propagate_labels, track_clusters)
from .stages_classify import classification
from .stages_geometry import (calculate_entropy_scores, filter_detections,
                              mask_ground_points, rebuild_ng_buffers,
                              spatial_clustering)
from .state import Capacity, SequenceState

log = logging.getLogger("vilgod_tpu_torch")

STAGE_REGISTRY = {
    "mask_ground_points": mask_ground_points,
    "calculate_entropy_scores": calculate_entropy_scores,
    "spatial_clustering": spatial_clustering,
    "filter_detections": filter_detections,
    "track_clusters": track_clusters,
    "classification": classification,
    "fit_bounding_boxes_simple": fit_bounding_boxes_simple,
    "propagate_labels": propagate_labels,
    "evaluate_sequence": evaluate_sequence,
}


class ZeroShotDetector:
    """Per-sequence pipeline driver over a :class:`SequenceState`."""

    def __init__(self, source, name: str, cfg, clip_model=None,
                 cache_dir: str | Path | None = None, device=None):
        self.cfg = cfg
        self.name = name
        self.source = source
        self.clip_model = clip_model
        self.device = resolve_device(device)
        self.cache_path = (Path(cache_dir) / f"{name}.npz") if cache_dir else None
        self.stage_times: dict[str, float] = {}
        # seconds run_sequences waited for this detector's prefetched build
        self.prefetch_wait_s = 0.0

        caps = Capacity.from_cfg(cfg)
        n = source.sequence_length
        self.state = SequenceState.allocate(name, n, caps, device=self.device)
        for fnr in range(n):
            self.state.set_frame(fnr, source.get_lidar_points(fnr),
                                 source.get_pose(fnr))
        if self.cache_path is not None and self.state.load(self.cache_path):
            log.info("Restored cached state for %s (%s)", name,
                     ",".join(sorted(self.state.done)))
            rebuild_ng_buffers(self.state)
        # the raw-cloud upload starts now, before process()
        self.state.prefetch()
        self.detection_3d_result_list: list[dict] = []

    def process(self, spans: bool = False) -> list[dict]:
        """Run the active pipeline; returns the per-frame detection dicts of
        ``evaluate_sequence`` (empty when that stage is not active). The
        run is span ``sequence`` (the sequence id: its name) and each stage
        a span named after it (:mod:`..utils.trace`, recorded only inside
        ``trace.recording``). With ``cfg["profile_dir"]`` set, the run goes
        under ``torch.profiler`` (the CPU, and the card's kernels on CUDA)
        and a recording whose spans are also ``record_function`` ranges,
        and the Chrome trace is written to
        ``<profile_dir>/<sequence>.trace.json``. ``spans`` is ignored
        (``benchmark/harness.py`` still passes it)."""
        profile_dir = self.cfg.get("profile_dir")
        prof = contextlib.nullcontext()
        if profile_dir:
            from torch.profiler import ProfilerActivity, profile
            activities = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            prof = profile(activities=activities)
        # every span also a profiler range, unless a recording is open
        ranges = contextlib.nullcontext()
        if profile_dir and trace.current() is None:
            ranges = trace.recording(device=self.device, profiler_ranges=True)
        with prof, ranges, trace.span("sequence", sequence=self.name):
            self._process_stages()
        if profile_dir:
            path = Path(profile_dir) / f"{self.name}.trace.json"
            path.parent.mkdir(parents=True, exist_ok=True)
            prof.export_chrome_trace(str(path))
            log.info("Trace written to %s", path)
        if self.state.detection_3d_result_list is not None:
            self.detection_3d_result_list = self.state.detection_3d_result_list
        return self.detection_3d_result_list

    def _process_stages(self):
        """The active stages in order, each timed by one clock pair that is
        also its span (a ``record_function`` range only where the
        recording asks: a range also shows on the card's timeline)."""
        pipeline = {p["name"]: p.get("args", {})
                    for p in self.cfg.get("pipeline", [])}
        for task_name in self.cfg.get("pipeline_active", []):
            if task_name not in pipeline:
                log.warning("%s NOT FOUND!!!", task_name)
                continue
            fn = STAGE_REGISTRY[task_name]
            args = dict(pipeline[task_name])
            if task_name == "classification":
                args["clip_model"] = self.clip_model
            before = self.state.done.get(task_name, False)
            with trace.timed(task_name) as tm:
                fn(self.state, self.cfg, **args)
                if self.device.type == "cuda":
                    # wall time per stage includes its device work
                    torch.cuda.synchronize(self.device)
            self.stage_times[task_name] = tm.seconds
            log.info("[%s] %s: %.2fs", self.name, task_name,
                     self.stage_times[task_name])
            ran = self.state.done.get(task_name, False) and not before
            if ran and self.cache_path is not None:
                self.state.save(self.cache_path)


def process_grid() -> tuple[int, int]:
    """(this process's index, the process count): the rank and world size
    of an initialised ``torch.distributed`` process group, else (0, 1)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def run_sequences(dataset, cfg, clip_model=None, cache_dir=None,
                  result_dir=None, shard_hosts: bool = True,
                  prefetch_next: bool = True,
                  stage_times: dict | None = None, device=None) -> list[dict]:
    """Process every sequence and concatenate the per-frame detection
    dicts in order. The next sequence builds on a worker thread while the
    current one processes (frame copies and quantization overlap the
    device work).

    With ``shard_hosts`` and a process group that the caller initialised
    (:func:`process_grid`), process r of W takes the sequences
    ``names[r::W]``: sequences are independent, so processes need no
    communication; their results land in the shared ``result_dir``, from
    which any process re-scores the union."""
    device = resolve_device(device)
    names = list(dataset.sequence_names())
    rank, world = process_grid()
    if shard_hosts and world > 1:
        names = names[rank::world]

    def cached(seq_name):
        return (Path(result_dir) / f"{seq_name}.npz") if result_dir else None

    def build(seq_name):
        with trace.span("build", sequence=seq_name):
            return ZeroShotDetector(dataset.sequence(seq_name), seq_name,
                                    cfg, clip_model=clip_model,
                                    cache_dir=cache_dir, device=device)

    all_results = []
    prebuilt = None  # (name, Future[ZeroShotDetector])
    from concurrent.futures import ThreadPoolExecutor
    pool = ThreadPoolExecutor(max_workers=1,
                              thread_name_prefix="vilgod-prefetch")
    try:
        for i, seq_name in enumerate(names):
            result_path = cached(seq_name)
            if result_path is not None and result_path.exists():
                with np.load(result_path, allow_pickle=True) as d:
                    all_results.extend(list(d["results"]))
                continue
            if prebuilt is not None and prebuilt[0] == seq_name:
                with trace.timed("prefetch_wait", sequence=seq_name) as tm:
                    zsd = prebuilt[1].result()
                zsd.prefetch_wait_s = tm.seconds
            else:
                if prebuilt is not None:
                    prebuilt[1].result()  # never abandon a running build
                zsd = build(seq_name)
            prebuilt = None
            if prefetch_next:
                for nxt in names[i + 1:]:
                    p = cached(nxt)
                    if p is None or not p.exists():
                        prebuilt = (nxt, pool.submit(build, nxt))
                        break
            results = zsd.process()
            if stage_times is not None:
                for k, v in zsd.stage_times.items():
                    stage_times[k] = stage_times.get(k, 0.0) + v
            if result_path is not None:
                result_path.parent.mkdir(parents=True, exist_ok=True)
                np.savez_compressed(result_path,
                                    results=np.array(results, dtype=object))
            all_results.extend(results)
        if prebuilt is not None:
            prebuilt[1].result()
    finally:
        pool.shutdown(wait=True)
    return all_results
