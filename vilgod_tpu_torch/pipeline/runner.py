"""Config-driven pipeline runner (the ZeroShotDetector equivalent); the
port of ``vilgod_tpu/pipeline/runner.py``.

The pipeline is an ordered list of ``{name, args}`` entries in the config
and ``pipeline_active`` selects and orders execution; stage names resolve
through :data:`STAGE_REGISTRY`. Per-sequence stage outputs checkpoint to
one ``.npz`` in the JAX package's schema (stage-level resume). Everything
runs on ``cuda`` unless the caller passes another ``device``.
"""
from __future__ import annotations

import logging
import time
from pathlib import Path

import numpy as np
import torch

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

    def process(self) -> list[dict]:
        """Run the active pipeline; returns the per-frame detection dicts of
        ``evaluate_sequence`` (empty when that stage is not active)."""
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
            t0 = time.perf_counter()
            before = self.state.done.get(task_name, False)
            fn(self.state, self.cfg, **args)
            if self.device.type == "cuda":
                # wall time per stage includes its device work
                torch.cuda.synchronize(self.device)
            self.stage_times[task_name] = time.perf_counter() - t0
            log.info("[%s] %s: %.2fs", self.name, task_name,
                     self.stage_times[task_name])
            ran = self.state.done.get(task_name, False) and not before
            if ran and self.cache_path is not None:
                self.state.save(self.cache_path)
        if self.state.detection_3d_result_list is not None:
            self.detection_3d_result_list = self.state.detection_3d_result_list
        return self.detection_3d_result_list


def run_sequences(dataset, cfg, clip_model=None, cache_dir=None,
                  result_dir=None, prefetch_next: bool = True,
                  stage_times: dict | None = None, device=None) -> list[dict]:
    """Process every sequence and concatenate the per-frame detection
    dicts in order. The next sequence builds on a worker thread while the
    current one processes (frame copies and quantization overlap the
    device work)."""
    device = resolve_device(device)
    names = list(dataset.sequence_names())

    def cached(seq_name):
        return (Path(result_dir) / f"{seq_name}.npz") if result_dir else None

    def build(seq_name):
        return ZeroShotDetector(dataset.sequence(seq_name), seq_name, cfg,
                                clip_model=clip_model, cache_dir=cache_dir,
                                device=device)

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
                zsd = prebuilt[1].result()
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
