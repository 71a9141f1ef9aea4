"""The CLIP tower's weights, made on the card from the seed.

One ``torch.randn`` call on the device's own generator draws every random
leaf at once; the leaves are views of that draw, scaled as flax's
initialisers scale them (LeCun-normal kernels, 0.02 embeddings, 0.01
positions), with zero biases and unit LayerNorm scales. The names and
layouts are the published CLIP ViT-B/16 checkpoint's in the flax layout
(a dense ``kernel`` is (in, out), the patch kernel (p, p, 3, width)):
the schema the program loads a checkpoint in. The same seed gives the
same weights to the program and, later, to the reference.
"""
from __future__ import annotations

import math

import torch


def _block(prefix: str, w: int) -> list[tuple[str, tuple, str, float]]:
    lecun = "normal"
    return [
        (f"{prefix}.ln_1.scale", (w,), "ones", 0.0),
        (f"{prefix}.ln_1.bias", (w,), "zeros", 0.0),
        (f"{prefix}.attn.qkv.kernel", (w, 3 * w), lecun, 1 / math.sqrt(w)),
        (f"{prefix}.attn.qkv.bias", (3 * w,), "zeros", 0.0),
        (f"{prefix}.attn.out.kernel", (w, w), lecun, 1 / math.sqrt(w)),
        (f"{prefix}.attn.out.bias", (w,), "zeros", 0.0),
        (f"{prefix}.ln_2.scale", (w,), "ones", 0.0),
        (f"{prefix}.ln_2.bias", (w,), "zeros", 0.0),
        (f"{prefix}.mlp_fc.kernel", (w, 4 * w), lecun, 1 / math.sqrt(w)),
        (f"{prefix}.mlp_fc.bias", (4 * w,), "zeros", 0.0),
        (f"{prefix}.mlp_proj.kernel", (4 * w, w), lecun,
         1 / math.sqrt(4 * w)),
        (f"{prefix}.mlp_proj.bias", (w,), "zeros", 0.0),
    ]


def leaves(t: dict) -> list[tuple[str, tuple, str, float]]:
    """(name, shape, init, std) of every leaf of the tower ``t`` (the
    ``clip`` group of a configuration file)."""
    p, w, e = t["patch_size"], t["vision_width"], t["embed_dim"]
    n_tok = (t["image_size"] // p) ** 2 + 1
    wt = t["text_width"]
    out = [
        ("visual.patch_embed.kernel", (p, p, 3, w), "normal",
         1 / math.sqrt(p * p * 3)),
        ("visual.class_embedding", (w,), "normal", 0.02),
        ("visual.positional_embedding", (n_tok, w), "normal", 0.01),
        ("visual.ln_pre.scale", (w,), "ones", 0.0),
        ("visual.ln_pre.bias", (w,), "zeros", 0.0),
    ]
    for i in range(t["vision_layers"]):
        out += _block(f"visual.transformer.block_{i}", w)
    out += [
        ("visual.ln_post.scale", (w,), "ones", 0.0),
        ("visual.ln_post.bias", (w,), "zeros", 0.0),
        ("visual.proj", (w, e), "normal", 0.02),
        ("text.token_embedding", (t["vocab_size"], wt), "normal", 0.02),
        ("text.positional_embedding", (t["context_length"], wt), "normal",
         0.01),
    ]
    for i in range(t["text_layers"]):
        out += _block(f"text.transformer.block_{i}", wt)
    out += [
        ("text.ln_final.scale", (wt,), "ones", 0.0),
        ("text.ln_final.bias", (wt,), "zeros", 0.0),
        ("text.text_projection", (wt, e), "normal", 0.02),
        ("logit_scale", (), "logit_scale", 0.0),
    ]
    return out


def make_weights(tower: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """name -> float32 tensor on ``device``, drawn from ``seed``."""
    spec = leaves(tower)
    n_random = sum(math.prod(s) for _, s, init, _ in spec if init == "normal")
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2**63))
    draw = torch.randn(n_random, generator=gen, device=device,
                       dtype=torch.float32)
    out, at = {}, 0
    for name, shape, init, std in spec:
        if init == "normal":
            n = math.prod(shape)
            out[name] = draw[at:at + n].view(shape).mul_(std)
            at += n
        elif init == "ones":
            out[name] = torch.ones(shape, device=device)
        elif init == "zeros":
            out[name] = torch.zeros(shape, device=device)
        else:
            out[name] = torch.full(shape, math.log(1 / 0.07), device=device)
    return out
