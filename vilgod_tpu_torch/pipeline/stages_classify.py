"""Stage 6: zero-shot CLIP classification of clusters; the port of the
single-device path of ``vilgod_tpu/pipeline/stages_classify.py``.

Valid detections of every frame are batched together; each batch is
gathered, rendered as 4-view depth images and classified by CLIP on the
device, and the per-view classes and scores come down in ONE download at
the end. A detection's class is the majority vote of its views.
"""
from __future__ import annotations

import numpy as np
import torch

from .state import CLS_NONE, MAPPED_CLASSES, SequenceState


def _vote(mapped_names: list[str], scores: np.ndarray) -> tuple[str, float]:
    """View-vote aggregation: the majority class, ties broken by the highest
    per-class mean score; the winner's score is the mean over its views."""
    names, counts = np.unique(mapped_names, return_counts=True)
    arr = np.asarray(mapped_names)
    if np.sum(counts[np.argmax(counts)] == counts) > 1:
        best_name, best_score = None, 0.0
        for name in names:
            s = float(np.mean(scores[arr == name]))
            if s > best_score:
                best_name, best_score = name, s
        return best_name, best_score
    name = names[np.argmax(counts)]
    return name, float(np.mean(scores[arr == name]))


def _render_args(cfg, image_size: int) -> dict:
    proj = cfg.get("preprocessor", {}).get("lidar_image_projection", {})
    return dict(resolution=proj.get("resolution", 112),
                depth=proj.get("depth", 8),
                obj_ratio=proj.get("obj_ratio", 0.8),
                depth_bias=proj.get("depth_bias", 0.2),
                image_size=image_size)


def dump_depth_images(state: SequenceState, cfg, out_dir,
                      image_size: int = 224):
    """Debug artifact: the rendered views of every valid detection, saved
    as ``<frame>_<cluster>_<view>.png`` (``.npy`` without PIL)."""
    from pathlib import Path

    from ..ops.rasterize import render_cluster_views
    from ..ops.transforms import apply_transform
    from .stages_geometry import frame_bucket

    out = Path(out_dir) / state.name
    out.mkdir(parents=True, exist_ok=True)
    f_pad, n_ng = frame_bucket(state.n_frames), state.ng_bucket()
    ng_xyz = state.device("ng_xyz", f_pad, n_ng)
    tables, table_masks = state.det_tables(f_pad, n_ng)
    dev = ng_xyz.device
    todo = [(f, int(c)) for f in range(state.n_frames)
            for c in np.flatnonzero(state.det_valid[f])]
    for i in range(0, len(todo), 16):
        chunk = todo[i:i + 16]
        fids = torch.tensor([f for f, _ in chunk], device=dev)
        cids = torch.tensor([c for _, c in chunk], device=dev)
        ego = torch.from_numpy(np.stack(
            [state.transform_to_ego(f) for f, _ in chunk]).astype(np.float32)
            ).to(dev)
        mask = table_masks[fids, cids]
        pts = ng_xyz[fids[:, None], torch.clamp(tables[fids, cids], min=0).long()]
        pts = torch.where(mask[..., None], apply_transform(pts, ego), 0.0)
        images = render_cluster_views(pts, mask, **_render_args(
            cfg, image_size)).cpu().numpy()
        for j, (f, c) in enumerate(chunk):
            for v in range(images.shape[1]):
                img = (np.clip(images[j, v], 0, 1) * 255).astype(np.uint8)
                try:
                    from PIL import Image
                    Image.fromarray(img).save(out / f"{f:04d}_{c:03d}_{v}.png")
                except ImportError:  # pragma: no cover
                    np.save(out / f"{f:04d}_{c:03d}_{v}.npy", img)


def classification(state: SequenceState, cfg, clip_model=None,
                   image_size: int = 224, aggregation: str = "voting",
                   valid_only: bool = True, missing_only: bool = False,
                   image_out_dir=None, force: bool = False, **_):
    """Classify every valid detection (or every detection, or only the
    unclassified ones) with ``clip_model`` (a :class:`ClipWrapper`);
    without one the stage does nothing (the geometry-only ablation)."""
    if clip_model is None:
        return
    if state.done.get("classification") and not force and not missing_only:
        return
    if aggregation != "voting":
        raise NotImplementedError(aggregation)

    from .stages_geometry import frame_bucket

    batch = state.caps.clip_batch
    mapping = clip_model.class_mapping
    class_list = clip_model.class_list
    f_pad = frame_bucket(state.n_frames)
    n_ng = state.ng_bucket()
    ng_xyz = state.device("ng_xyz", f_pad, n_ng)
    tables, table_masks = state.det_tables(f_pad, n_ng)
    classify = clip_model.make_cluster_classifier(
        state.caps.max_clusters, state.caps.max_cluster_points,
        **_render_args(cfg, image_size))

    # batch across frames: each frame holds few clusters
    todo: list[tuple[int, int]] = []
    for fnr in range(state.n_frames):
        sel = state.det_valid[fnr] if valid_only else state.det_n[fnr] > 0
        todo.extend((fnr, int(c)) for c in np.flatnonzero(sel)
                    if not (missing_only and state.det_cls[fnr, c] != CLS_NONE))
    ego = np.stack([state.transform_to_ego(f) for f in range(state.n_frames)])

    # every batch is enqueued first; the results come down in one download
    pending = []
    tail = min(batch, max(32, batch // 4))
    i = 0
    while i < len(todo):
        # the final sliver runs at the tail size, not a full padded batch
        b = batch if len(todo) - i > tail else tail
        chunk = todo[i:i + b]
        i += b
        fids = np.zeros(b, np.int32)
        cids = np.full(b, -1, np.int32)
        trs = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
        for j, (f, c) in enumerate(chunk):
            fids[j], cids[j] = f, c
            trs[j] = ego[f]
        pending.append((chunk, classify(ng_xyz, tables, table_masks, fids,
                                        cids, trs)))
    if pending:
        packed = torch.cat([torch.cat([idx.float(), sc], dim=-1)
                            for _, (idx, sc) in pending]).cpu().numpy()
        v = packed.shape[-1] // 2
        row0 = 0
        for chunk, (idx_dev, _) in pending:
            cls_idx = packed[row0:row0 + len(chunk), :v].astype(np.int32)
            scores = packed[row0:row0 + len(chunk), v:]
            row0 += idx_dev.shape[0]
            for j, (f, c) in enumerate(chunk):
                mapped = [mapping[class_list[k]] for k in cls_idx[j]]
                name, score = _vote(mapped, scores[j])
                state.det_cls[f, c] = MAPPED_CLASSES.index(name)
                state.det_score[f, c] = score
    if image_out_dir:
        dump_depth_images(state, cfg, image_out_dir, image_size=image_size)
    state.done["classification"] = True
