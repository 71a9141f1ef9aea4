"""The CLIP classifier of the port: the ViT-B/16 and text towers
(``clip``), their kernels (``vit_kernels``), the tokenizers and the
zero-shot wrapper (``clip_wrapper``)."""
from .clip import (CLIPConfig, CLIPModel, clip_vit_b16, convert_openai_checkpoint,
                   init_clip_params)

__all__ = [
    "CLIPConfig",
    "CLIPModel",
    "clip_vit_b16",
    "init_clip_params",
    "convert_openai_checkpoint",
]
