"""Zero-shot CLIP classification wrapper; the port of
``vilgod_tpu/models/clip_wrapper.py``.

Text prompts are encoded once at construction. The image path follows the
JAX order: grey depth image -> uint8 round trip (the reference's PIL
conversion) -> 3 channels -> CLIP normalisation -> image tower -> cosine
logits x100 -> softmax -> top-1. The cluster classifier adds, before it,
the gather of each cluster's points from the resident sequence buffers,
the transform to the ego frame and the 4-view rendering; only the (B, V)
class indices and scores leave the device.

The tower is the one that the checkpoint's file name, or else the
configuration's ``model_name``, names (``clip.CHECKPOINTS``: ViT-B/16,
ViT-L/14@336px or DFN5B ViT-H/14-378) unless a ``model_cfg`` is given; it
runs in bfloat16 by default, its attention halves through the CUDA kernel
of ``csrc/vit.cu`` on the card. Views are rendered at the
tower's own image size.
"""
from __future__ import annotations

import copy
from pathlib import Path

import numpy as np
import torch

from ..ops.rasterize import render_cluster_views
from ..ops.transforms import apply_transform
from ..utils import trace
from ..utils.common import resolve_device
from .clip import (clip_config_for, convert_openai_checkpoint,
                   init_clip_params, normalize_images)
from .tokenizer import ClipTokenizer, HashTokenizer


class ClipWrapper:
    def __init__(self, clip_cfg: dict, checkpoint_path: str | None = None,
                 bpe_path: str | None = None, dtype=torch.bfloat16,
                 seed: int = 0, model_cfg=None, device=None, model=None):
        """``model``: an already built :class:`CLIPModel` (for example one
        carrying a JAX parameter tree, ``clip.params_from_jax``); otherwise
        the checkpoint at ``checkpoint_path`` or seeded random weights.
        ``model_cfg``: the tower; without it, the one that
        ``checkpoint_path``'s file name names where a path is given, else
        ``clip_cfg``'s ``model_name`` (ViT-B/16 where it names none), in
        ``dtype``."""
        self.device = resolve_device(device)
        self.cfg = clip_cfg
        self.model_cfg = model_cfg or clip_config_for(
            checkpoint_path or clip_cfg.get("model_name", "ViT-B-16.pt"),
            dtype)
        if model is not None:
            self.model = model.to(self.device)
        elif checkpoint_path and Path(checkpoint_path).exists():
            self.model = convert_openai_checkpoint(
                checkpoint_path, self.model_cfg, device=self.device)
        else:
            self.model = init_clip_params(self.model_cfg, seed=seed,
                                          device=self.device)
        if bpe_path and Path(bpe_path).exists():
            self.tokenizer = ClipTokenizer(bpe_path)
        else:
            self.tokenizer = HashTokenizer()

        self.class_list = list(clip_cfg.get("class_list", []))
        self.class_mapping = dict(clip_cfg.get("class_mapping", {}))
        self.text_features = self._encode_prompts()  # (K, D)

    def _encode_prompts(self) -> torch.Tensor:
        template = self.cfg.get("prompt_template",
                                "a point representation of a {}")
        prompts = [template.format(c) for c in self.class_list]
        tokens = torch.from_numpy(self.tokenizer.tokenize(prompts)).long()
        feats = self.model.encode_text(tokens.to(self.device)).float()
        return feats / torch.linalg.norm(feats, dim=-1, keepdim=True)

    def replica(self, device) -> "ClipWrapper":
        """This wrapper on another ``device``: a copy of its model's
        weights there, the same prompts and tokenizer, its text features
        encoded there (the per-device copy of a sharded classification)."""
        other = copy.copy(self)
        other.device = torch.device(device)
        other.model = copy.deepcopy(self.model).to(other.device)
        other.text_features = other._encode_prompts()
        return other

    @torch.no_grad()
    def _classify_images(self, images: torch.Tensor):
        """(N, S, S) grey images in [0, 1] -> (class index (N,) int32,
        score (N,) f32)."""
        img = torch.round(images * 255.0) / 255.0   # the PIL uint8 round trip
        rgb = img[..., None].expand(*img.shape, 3)
        x = normalize_images(rgb).to(self.model_cfg.dtype)
        feats = self.model.encode_image(x).float()
        feats = feats / torch.linalg.norm(feats, dim=-1, keepdim=True)
        logits = 100.0 * feats @ self.text_features.T
        probs = torch.softmax(logits, dim=-1)
        score, idx = torch.max(probs, dim=-1)
        return idx.to(torch.int32), score

    def render_size(self, image_size: int | None = None) -> int:
        """The side of the views the tower takes: its ``image_size``. A
        stated size that differs raises (the tower's positional embedding
        fits one size; views are not resized to it)."""
        size = self.model_cfg.image_size
        if image_size is not None and image_size != size:
            raise ValueError(f"image_size {image_size} differs from the "
                             f"tower's {size}: render at the tower's size")
        return size

    def predict(self, images: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """images (B, H, W) grey depth images in [0, 1] -> (class index
        (B,) into ``class_list``, score (B,))."""
        idx, score = self._classify_images(
            torch.as_tensor(np.asarray(images, np.float32), device=self.device))
        return idx.cpu().numpy(), score.cpu().numpy()

    def make_cluster_classifier(self, num_clusters: int, capacity: int,
                                resolution: int = 112, depth: int = 8,
                                obj_ratio: float = 0.8,
                                depth_bias: float = 0.2,
                                image_size: int | None = None):
        """``run(ng_xyz, tables, table_masks, frame_ids, cluster_ids,
        transforms) -> (class index (B, V) int32, score (B, V) f32)`` on the
        device: gather each (frame, cluster) item's points, transform them
        to the ego frame, render ``V`` views at the tower's image size,
        classify every view. Items may come from different frames, so one
        call fills a whole batch. A stated ``image_size`` must be the
        tower's."""
        image_size = self.render_size(image_size)

        @torch.no_grad()
        def run(ng_xyz, tables, table_masks, frame_ids, cluster_ids,
                transforms):
            dev = ng_xyz.device
            with trace.span("classify.render", device=True):
                fids = torch.as_tensor(frame_ids, dtype=torch.long,
                                       device=dev)
                cids = torch.as_tensor(cluster_ids, dtype=torch.long,
                                       device=dev)
                trs = torch.as_tensor(np.asarray(transforms, np.float32),
                                      device=dev)
                rows = torch.clamp(tables[fids, cids], min=0).long()
                rmask = table_masks[fids, cids] & (cids >= 0)[:, None]
                pts = ng_xyz[fids[:, None], rows]              # (B, cap, 3)
                ego = torch.where(rmask[..., None],
                                  apply_transform(pts, trs), 0.0)
                safe = rmask.clone()
                safe[:, 0] = True
                images = render_cluster_views(
                    ego, safe, resolution=resolution, depth=depth,
                    obj_ratio=obj_ratio, depth_bias=depth_bias,
                    image_size=image_size)                  # (B, V, S, S)
            b, v, s, _ = images.shape
            with trace.span("classify.tower", device=True):
                trace.count("tower_images", b * v)
                idx, score = self._classify_images(
                    images.reshape(b * v, s, s))
            return idx.reshape(b, v), score.reshape(b, v)

        return run
