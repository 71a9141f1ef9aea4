"""CLIP in PyTorch, the zero-shot classifier backbone; the port of
``vilgod_tpu/models/clip.py``. One module set runs every CLIP tower of
OpenAI's block equations at its published sizes: ViT-B/16
(:func:`clip_vit_b16`, the default), ViT-L/14@336px
(:func:`clip_vit_l14_336`) and Apple's DFN5B ViT-H/14-378
(:func:`clip_vit_h14_378`, heads of 80), chosen by checkpoint name through
:data:`CHECKPOINTS` (:func:`clip_config_for`).

The modules mirror the flax modules one for one and hold their weights
in the flax layout (a dense ``kernel`` is (in, out), the patch embedding
(p, p, 3, width)), under the flax tree's names, so :func:`params_from_jax`
carries a JAX parameter tree across unchanged and both packages compute
the same function. Weights are stored in float32 and cast to the model
dtype where they are used, as flax does.

A bf16 tower runs the attention half of each layer through
:func:`vit_kernels.fused_attention_proj` and, at a 128-aligned width, the
MLP half through :func:`vit_kernels.fused_mlp_block` (CUDA kernels on the
card, their plain versions on the CPU; ``VILGOD_FUSED_MLP_BLOCK=0`` and
``VILGOD_FUSED_ATTN=0`` turn them off). The text tower's attention (causal
mask) and every non-bf16 tower take the unfused path, as in JAX.
QuickGELU is ``x * sigmoid(1.702 x)`` (OpenAI CLIP's), not the standard
GELU.
"""
from __future__ import annotations

import dataclasses
import math
from pathlib import Path
from typing import Any

import numpy as np
import torch
from torch import nn

from ..utils.common import resolve_device
from . import vit_kernels as VK


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    image_size: int = 224
    patch_size: int = 16
    vision_width: int = 768
    vision_layers: int = 12
    vision_heads: int = 12
    embed_dim: int = 512
    context_length: int = 77
    vocab_size: int = 49408
    text_width: int = 512
    text_heads: int = 8
    text_layers: int = 12
    dtype: Any = torch.float32


def clip_vit_b16(dtype=torch.float32) -> CLIPConfig:
    """OpenAI CLIP ViT-B/16: 224 px, patch 16 (197 tokens), width 768, 12
    layers of 12 heads; embedding 512; text width 512, 8 heads, 12
    layers."""
    return CLIPConfig(dtype=dtype)


def clip_vit_l14_336(dtype=torch.float32) -> CLIPConfig:
    """OpenAI CLIP ViT-L/14@336px (openai/CLIP ``clip/model.py``
    ``build_model`` on ``ViT-L-14-336px.pt``): 336 px, patch 14 (577
    tokens), width 1024, 24 layers of 16 heads of 64, MLP 4096; embedding
    768; text context 77, vocabulary 49408, width 768, 12 heads, 12
    layers."""
    return CLIPConfig(image_size=336, patch_size=14, vision_width=1024,
                      vision_layers=24, vision_heads=16, embed_dim=768,
                      context_length=77, vocab_size=49408, text_width=768,
                      text_heads=12, text_layers=12, dtype=dtype)


def clip_vit_h14_378(dtype=torch.float32) -> CLIPConfig:
    """Apple's DFN5B-CLIP-ViT-H-14-378 (Fang et al., "Data Filtering
    Networks", arXiv 2309.17425; open_clip ``model_configs/
    ViT-H-14-378-quickgelu.json``, pretrained tag ``dfn5b``): 378 px, patch
    14 (730 tokens), width 1280, 32 layers of 16 heads of 80, MLP 5120,
    QuickGELU; embedding 1024; text context 77, vocabulary 49408, width
    1024, 16 heads, 24 layers. OpenAI's block equations: pre-LN, class
    token, ``ln_pre``, a causal text tower pooled at end-of-text."""
    return CLIPConfig(image_size=378, patch_size=14, vision_width=1280,
                      vision_layers=32, vision_heads=16, embed_dim=1024,
                      context_length=77, vocab_size=49408, text_width=1024,
                      text_heads=16, text_layers=24, dtype=dtype)


# checkpoint file names -> the tower each holds: OpenAI's (openai/CLIP
# clip/clip.py ``_MODELS``), and the open_clip weights of Hugging Face's
# ``apple/DFN5B-CLIP-ViT-H-14-378`` (its ``open_clip_pytorch_model.bin``)
# saved under the repository's name; open_clip keeps OpenAI's state-dict names
CHECKPOINTS = {
    "ViT-B-16.pt": clip_vit_b16,
    "ViT-L-14-336px.pt": clip_vit_l14_336,
    "DFN5B-CLIP-ViT-H-14-378.bin": clip_vit_h14_378,
}


def clip_config_for(model_name: str, dtype=torch.float32) -> CLIPConfig:
    """The tower of the checkpoint ``model_name`` (a file name of
    :data:`CHECKPOINTS`, or a path ending in one) in ``dtype``."""
    name = Path(model_name).name
    if name not in CHECKPOINTS:
        raise ValueError(f"no tower for checkpoint {model_name!r}; known: "
                         f"{', '.join(sorted(CHECKPOINTS))}")
    return CHECKPOINTS[name](dtype)


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def layer_norm(x, p, dtype):
    """The JAX package's ``layer_norm`` (clip.py:119-128): f32 statistics,
    ``((x - mean) * rsqrt(var + 1e-5)) * scale + bias``, cast to ``dtype``
    (the fused kernels' LayerNorm)."""
    return VK.ln32(x, p.scale, p.bias).to(dtype)


def flax_layer_norm(x, p, dtype, eps: float = 1e-6):
    """flax ``nn.LayerNorm(dtype=dtype)`` (``ln_pre``, ``ln_post``,
    ``ln_final``): the same statistics, but ``(x - mean) * (rsqrt(var +
    eps) * scale) + bias``, and flax's default eps, 1e-6."""
    x32, mean, var = VK.ln_stats32(x)
    mul = torch.rsqrt(var + eps) * p.scale.float()
    return ((x32 - mean) * mul + p.bias.float()).to(dtype)


def _param(*shape):
    return nn.Parameter(torch.zeros(*shape), requires_grad=False)


class LayerNormParams(nn.Module):
    """flax LayerNorm parameters: ``scale`` (ones) and ``bias`` (zeros)."""

    def __init__(self, width: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(width), requires_grad=False)
        self.bias = _param(width)


class Dense(nn.Module):
    """flax Dense parameters: ``kernel`` (in, out) and ``bias`` (out,)."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.kernel = _param(d_in, d_out)
        self.bias = _param(d_out)

    def cast(self, dtype):
        return (self.kernel.to(dtype).contiguous(),
                self.bias.to(dtype).contiguous())


class MultiHeadAttention(nn.Module):
    def __init__(self, width: int, heads: int, dtype=torch.float32):
        super().__init__()
        self.width, self.heads, self.dtype = width, heads, dtype
        self.qkv = Dense(width, 3 * width)
        self.out = Dense(width, width)

    def forward(self, x, attn_mask=None, ln=None):
        """With ``ln`` (LayerNorm parameters) the whole attention half of a
        residual block, ``x + out(attn(qkv(LN(x))))``, which a bf16 tower
        runs as one kernel; without it, plain attention over ``x``."""
        dt = self.dtype
        w_qkv, b_qkv = self.qkv.cast(dt)
        w_out, b_out = self.out.cast(dt)
        if (ln is not None and attn_mask is None
                and VK.use_fused_attention(dt, self.width, self.heads)):
            return VK.fused_attention_proj(
                x.to(dt).contiguous(), ln.scale.float().contiguous(),
                ln.bias.float().contiguous(), w_qkv, b_qkv, w_out, b_out,
                self.heads)
        residual = x if ln is not None else None
        if ln is not None:
            x = layer_norm(x, ln, dt)
        qkv = x.to(dt) @ w_qkv + b_qkv
        d = self.width // self.heads

        def heads(t):
            return t.reshape(t.shape[:-1] + (self.heads, d)).transpose(-3, -2)

        q, k, v = (heads(t) for t in qkv.split(self.width, dim=-1))
        logits = torch.matmul(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(d))
        if attn_mask is not None:
            logits = logits + attn_mask
        weights = torch.softmax(logits.float(), dim=-1).to(dt)
        out = torch.matmul(weights, v).transpose(-3, -2).reshape(x.shape)
        out = out @ w_out + b_out
        return out if residual is None else residual + out


class ResidualBlock(nn.Module):
    def __init__(self, width: int, heads: int, dtype=torch.float32):
        super().__init__()
        self.width, self.dtype = width, dtype
        self.ln_1 = LayerNormParams(width)
        self.attn = MultiHeadAttention(width, heads, dtype)
        self.ln_2 = LayerNormParams(width)
        self.mlp_fc = Dense(width, 4 * width)
        self.mlp_proj = Dense(4 * width, width)

    def forward(self, x, attn_mask=None):
        dt, width = self.dtype, self.width
        x = self.attn(x, attn_mask, ln=self.ln_1)
        w_fc, b_fc = self.mlp_fc.cast(dt)
        w_pr, b_pr = self.mlp_proj.cast(dt)
        lead = x.shape[:-1]
        if VK.use_fused_mlp_block(dt, width):
            return VK.fused_mlp_block(
                x.to(dt).reshape(-1, width).contiguous(),
                self.ln_2.scale.float().contiguous(),
                self.ln_2.bias.float().contiguous(),
                w_fc, b_fc, w_pr, b_pr).reshape(*lead, width)
        h = layer_norm(x, self.ln_2, dt)
        if VK.use_fused_mlp(dt, width):
            y = VK.fused_mlp(h.reshape(-1, width).contiguous(), w_fc, b_fc,
                             w_pr, b_pr)
            return x + y.reshape(*lead, width)
        h = quick_gelu(h @ w_fc + b_fc)
        return x + (h @ w_pr + b_pr)


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int,
                 dtype=torch.float32):
        super().__init__()
        self.layers = layers
        for i in range(layers):
            self.add_module(f"block_{i}", ResidualBlock(width, heads, dtype))

    def forward(self, x, attn_mask=None):
        for i in range(self.layers):
            x = getattr(self, f"block_{i}")(x, attn_mask)
        return x


class PatchEmbed(nn.Module):
    """The patch convolution's kernel, flax layout (p, p, 3, width)."""

    def __init__(self, patch: int, width: int):
        super().__init__()
        self.kernel = _param(patch, patch, 3, width)


class VisionTower(nn.Module):
    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        c = self.cfg = cfg
        n_tok = (c.image_size // c.patch_size) ** 2 + 1
        self.patch_embed = PatchEmbed(c.patch_size, c.vision_width)
        self.class_embedding = _param(c.vision_width)
        self.positional_embedding = _param(n_tok, c.vision_width)
        self.ln_pre = LayerNormParams(c.vision_width)
        self.transformer = Transformer(c.vision_width, c.vision_layers,
                                       c.vision_heads, c.dtype)
        self.ln_post = LayerNormParams(c.vision_width)
        self.proj = _param(c.vision_width, c.embed_dim)

    def forward(self, images):
        """images (B, H, W, 3) normalised floats -> (B, embed_dim). The
        stride-p patch convolution is an unfold and one product."""
        c, dt = self.cfg, self.cfg.dtype
        b, h, w, _ = images.shape
        p = c.patch_size
        patches = (images.to(dt).reshape(b, h // p, p, w // p, p, 3)
                   .permute(0, 1, 3, 2, 4, 5)
                   .reshape(b, (h // p) * (w // p), p * p * 3))
        kernel = self.patch_embed.kernel.to(dt).reshape(p * p * 3,
                                                        c.vision_width)
        x = torch.matmul(patches, kernel)
        cls = self.class_embedding.to(dt).expand(b, 1, c.vision_width)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(dt)
        x = flax_layer_norm(x, self.ln_pre, dt)
        x = self.transformer(x)
        x = flax_layer_norm(x[:, 0], self.ln_post, dt)
        return torch.matmul(x, self.proj.to(dt))


class TextTower(nn.Module):
    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        c = self.cfg = cfg
        self.token_embedding = _param(c.vocab_size, c.text_width)
        self.positional_embedding = _param(c.context_length, c.text_width)
        self.transformer = Transformer(c.text_width, c.text_layers,
                                       c.text_heads, c.dtype)
        self.ln_final = LayerNormParams(c.text_width)
        self.text_projection = _param(c.text_width, c.embed_dim)

    def forward(self, tokens):
        """tokens (B, context_length) int -> (B, embed_dim); EOT pooling at
        the first maximum token id."""
        c, dt = self.cfg, self.cfg.dtype
        x = self.token_embedding[tokens].to(dt)
        x = x + self.positional_embedding.to(dt)
        n = c.context_length
        mask = torch.triu(torch.full((n, n), float("-inf"),
                                     device=x.device), diagonal=1).to(dt)
        x = self.transformer(x, mask)
        x = flax_layer_norm(x, self.ln_final, dt)
        eot = torch.argmax(tokens, dim=-1)
        pooled = x[torch.arange(x.shape[0], device=x.device), eot]
        return torch.matmul(pooled, self.text_projection.to(dt))


class CLIPModel(nn.Module):
    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        self.cfg = cfg
        self.visual = VisionTower(cfg)
        self.text = TextTower(cfg)
        self.logit_scale = nn.Parameter(
            torch.tensor(math.log(1 / 0.07), dtype=torch.float32),
            requires_grad=False)

    @torch.no_grad()
    def encode_image(self, images):
        return self.visual(images)

    @torch.no_grad()
    def encode_text(self, tokens):
        return self.text(tokens)

    @torch.no_grad()
    def forward(self, images, tokens):
        img = self.encode_image(images)
        txt = self.encode_text(tokens)
        img = img / torch.linalg.norm(img, dim=-1, keepdim=True)
        txt = txt / torch.linalg.norm(txt, dim=-1, keepdim=True)
        return torch.exp(self.logit_scale) * img @ txt.T


def load_params(model: nn.Module, tree: dict):
    """Copy a nested dict of arrays (the flax parameter tree's names and
    layouts) into ``model``'s parameters; every leaf must match a parameter
    of the same shape."""
    for key, val in tree.items():
        if isinstance(val, dict):
            load_params(getattr(model, key), val)
            continue
        param = getattr(model, key)
        arr = torch.from_numpy(np.array(val, dtype=np.float32))
        if tuple(arr.shape) != tuple(param.shape):
            raise ValueError(f"{key}: shape {tuple(arr.shape)} != "
                             f"{tuple(param.shape)}")
        with torch.no_grad():
            param.copy_(arr)


def params_from_jax(tree: dict, cfg: CLIPConfig, device=None) -> CLIPModel:
    """A :class:`CLIPModel` on ``device`` (``cuda`` unless given) holding a
    JAX parameter tree (nested dicts of arrays, as
    ``vilgod_tpu.models.clip.init_clip_params`` returns it)."""
    model = CLIPModel(cfg)
    load_params(model, tree)
    return model.to(resolve_device(device))


def init_clip_params(cfg: CLIPConfig, seed: int = 0, device=None) -> CLIPModel:
    """A randomly initialised model on ``device`` (``cuda`` unless given),
    drawn on the CPU from an explicit generator (the same weights on every
    device), with
    flax's initialisers: LeCun-normal dense and patch kernels (truncated at
    two standard deviations), zero biases, unit LayerNorm scales, normal
    embeddings (0.02; positions 0.01)."""
    gen = torch.Generator().manual_seed(seed)
    model = CLIPModel(cfg)
    trunc_std = 0.87962566103423978  # std of a unit normal cut at +-2

    def lecun(param, fan_in):
        t = torch.randn(param.shape, generator=gen)
        while (bad := t.abs() > 2).any():
            t[bad] = torch.randn(int(bad.sum()), generator=gen)
        param.copy_(t / trunc_std / math.sqrt(fan_in))

    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, Dense):
                lecun(mod.kernel, mod.kernel.shape[0])
            elif isinstance(mod, PatchEmbed):
                lecun(mod.kernel, math.prod(mod.kernel.shape[:3]))
        for tower in (model.visual, model.text):
            for name, std in (("class_embedding", 0.02), ("proj", 0.02),
                              ("token_embedding", 0.02),
                              ("text_projection", 0.02),
                              ("positional_embedding", 0.01)):
                if hasattr(tower, name):
                    p = getattr(tower, name)
                    p.copy_(torch.randn(p.shape, generator=gen) * std)
    return model.to(resolve_device(device))


# CLIP image normalisation constants
IMAGE_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
IMAGE_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def normalize_images(images_rgb01: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) in [0, 1] -> CLIP-normalised."""
    mean = torch.from_numpy(IMAGE_MEAN).to(images_rgb01.device)
    std = torch.from_numpy(IMAGE_STD).to(images_rgb01.device)
    return (images_rgb01 - mean) / std


def convert_openai_checkpoint(path: str, cfg: CLIPConfig | None = None,
                              device=None) -> CLIPModel:
    """A CLIP checkpoint under OpenAI's state-dict names (OpenAI's
    TorchScript archive or plain state_dict, or open_clip's state_dict of
    the same names) mapped onto the port's modules on ``device`` (``cuda``
    unless given), through the flax tree's names and layouts
    (``in_proj_weight.T`` -> ``qkv/kernel``, the conv weight (O, I, kh, kw)
    -> (kh, kw, I, O)). Without ``cfg`` the tower is the one that
    :data:`CHECKPOINTS` names for the file's name
    (:func:`clip_config_for`), which then has to be one of its names."""
    cfg = cfg or clip_config_for(path)
    try:
        sd = torch.jit.load(path, map_location="cpu").state_dict()
    except RuntimeError:
        obj = torch.load(path, map_location="cpu", weights_only=False)
        sd = obj.state_dict() if hasattr(obj, "state_dict") else obj

    def g(k):
        return sd[k].float().numpy()

    def block(prefix):
        return {
            "ln_1": {"scale": g(f"{prefix}.ln_1.weight"),
                     "bias": g(f"{prefix}.ln_1.bias")},
            "ln_2": {"scale": g(f"{prefix}.ln_2.weight"),
                     "bias": g(f"{prefix}.ln_2.bias")},
            "attn": {
                "qkv": {"kernel": g(f"{prefix}.attn.in_proj_weight").T,
                        "bias": g(f"{prefix}.attn.in_proj_bias")},
                "out": {"kernel": g(f"{prefix}.attn.out_proj.weight").T,
                        "bias": g(f"{prefix}.attn.out_proj.bias")},
            },
            "mlp_fc": {"kernel": g(f"{prefix}.mlp.c_fc.weight").T,
                       "bias": g(f"{prefix}.mlp.c_fc.bias")},
            "mlp_proj": {"kernel": g(f"{prefix}.mlp.c_proj.weight").T,
                         "bias": g(f"{prefix}.mlp.c_proj.bias")},
        }

    tree = {
        "visual": {
            "patch_embed": {"kernel": g("visual.conv1.weight")
                            .transpose(2, 3, 1, 0)},
            "class_embedding": g("visual.class_embedding"),
            "positional_embedding": g("visual.positional_embedding"),
            "ln_pre": {"scale": g("visual.ln_pre.weight"),
                       "bias": g("visual.ln_pre.bias")},
            "ln_post": {"scale": g("visual.ln_post.weight"),
                        "bias": g("visual.ln_post.bias")},
            "proj": g("visual.proj"),
            "transformer": {f"block_{i}": block(f"visual.transformer.resblocks.{i}")
                            for i in range(cfg.vision_layers)},
        },
        "text": {
            "token_embedding": g("token_embedding.weight"),
            "positional_embedding": g("positional_embedding"),
            "ln_final": {"scale": g("ln_final.weight"),
                         "bias": g("ln_final.bias")},
            "text_projection": g("text_projection"),
            "transformer": {f"block_{i}": block(f"transformer.resblocks.{i}")
                            for i in range(cfg.text_layers)},
        },
        "logit_scale": g("logit_scale"),
    }
    return params_from_jax(tree, cfg, device)
