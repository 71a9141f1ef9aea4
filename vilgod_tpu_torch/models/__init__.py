"""The CLIP classifier of the port: the ViT towers (ViT-B/16 and
ViT-L/14@336px) and the text tower (``clip``), their kernels
(``vit_kernels``), the tokenizers and the zero-shot wrapper
(``clip_wrapper``)."""
from .clip import (CHECKPOINTS, CLIPConfig, CLIPModel, clip_config_for,
                   clip_vit_b16, clip_vit_l14_336, convert_openai_checkpoint,
                   init_clip_params)

__all__ = [
    "CHECKPOINTS",
    "CLIPConfig",
    "CLIPModel",
    "clip_config_for",
    "clip_vit_b16",
    "clip_vit_l14_336",
    "init_clip_params",
    "convert_openai_checkpoint",
]
