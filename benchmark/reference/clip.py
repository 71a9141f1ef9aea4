"""CLIP ViT-B/16 in plain float32 (OpenAI CLIP's ``clip/model.py``):
patch convolution, class token and positions, pre-LayerNorm residual
blocks of multi-head attention and a QuickGELU MLP, the class token's
LayerNorm and projection; the text tower with a causal mask, pooled at
the end-of-text token. LayerNorm epsilons follow the flax definition the
program ports (1e-6 outside the blocks, 1e-5 inside). Weights are the
name -> tensor dict of ``benchmark/weights.py``."""
from __future__ import annotations

import hashlib
import re

import numpy as np
import torch
import torch.nn.functional as F

from .precision import fp8, matmul

IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


def _store(x, control):
    """An activation as the tower keeps it between operations: float32,
    or rounded to fp8 in the control (where the program keeps bf16). The
    control ``"operands"`` keeps float32 activations and takes only the
    products' operands in fp8."""
    return fp8(x) if control is True else x


def _ln(x, w, prefix, eps, control=False):
    return _store(F.layer_norm(x, x.shape[-1:], w[prefix + ".scale"],
                               w[prefix + ".bias"], eps), control)


def _dense(x, w, prefix, control):
    return _store(matmul(x, w[prefix + ".kernel"], control)
                  + w[prefix + ".bias"], control)


def _attention(x, w, prefix, heads, mask, control):
    b, t, d = x.shape
    hd = d // heads
    qkv = _dense(x, w, prefix + ".qkv", control)
    q, k, v = (z.reshape(b, t, heads, hd).transpose(1, 2)
               for z in qkv.split(d, dim=-1))
    logits = matmul(q, k.transpose(-1, -2), control) / hd ** 0.5
    if mask is not None:
        logits = logits + mask
    weights = _store(torch.softmax(logits, dim=-1), control)
    out = _store(matmul(weights, v, control), control)
    return _dense(out.transpose(1, 2).reshape(b, t, d), w, prefix + ".out",
                  control)


def _blocks(x, w, prefix, layers, heads, mask, control):
    for i in range(layers):
        p = f"{prefix}.block_{i}"
        x = _store(x + _attention(_ln(x, w, p + ".ln_1", 1e-5, control), w,
                                  p + ".attn", heads, mask, control), control)
        h = _dense(_ln(x, w, p + ".ln_2", 1e-5, control), w, p + ".mlp_fc",
                   control)
        h = _store(h * torch.sigmoid(1.702 * h), control)
        x = _store(x + _dense(h, w, p + ".mlp_proj", control), control)
    return x


def encode_image(w, images, tower, control=False):
    """images (B, 3, H, W) normalised -> (B, embed_dim)."""
    p = tower["patch_size"]
    kernel = w["visual.patch_embed.kernel"].permute(3, 2, 0, 1)
    if control:
        x = matmul(F.unfold(images, p, stride=p).transpose(1, 2),
                   kernel.reshape(kernel.shape[0], -1).T, True)
    else:
        x = F.conv2d(images, kernel, stride=p).flatten(2).transpose(1, 2)
    cls = w["visual.class_embedding"].expand(x.shape[0], 1, -1)
    x = _store(torch.cat([cls, x], dim=1) + w["visual.positional_embedding"],
               control)
    x = _ln(x, w, "visual.ln_pre", 1e-6, control)
    x = _blocks(x, w, "visual.transformer", tower["vision_layers"],
                tower["vision_heads"], None, control)
    x = _ln(x[:, 0], w, "visual.ln_post", 1e-6, control)
    return matmul(x, w["visual.proj"], control)


def encode_text(w, tokens, tower, control=False):
    """tokens (K, context) -> (K, embed_dim)."""
    x = w["text.token_embedding"][tokens] + w["text.positional_embedding"]
    n = tokens.shape[1]
    mask = torch.triu(torch.full((n, n), float("-inf"), device=x.device), 1)
    x = _blocks(x, w, "text.transformer", tower["text_layers"],
                tower["text_heads"], mask, control)
    x = _ln(x, w, "text.ln_final", 1e-6)
    pooled = x[torch.arange(x.shape[0]), tokens.argmax(dim=-1)]
    return matmul(pooled, w["text.text_projection"], control)


def tokenize(texts, vocab_size: int, context: int) -> np.ndarray:
    """The stand-in tokenizer of a checkpoint without its BPE table: start
    token, each whitespace word's md5 modulo the vocabulary, end token."""
    sot, eot = vocab_size - 2, vocab_size - 1
    out = np.zeros((len(texts), context), np.int64)
    for i, text in enumerate(texts):
        ids = [sot] + [int(hashlib.md5(word.encode()).hexdigest(), 16)
                       % (vocab_size - 2)
                       for word in re.sub(r"\s+", " ",
                                          text.lower()).strip().split(" ")]
        ids.append(eot)
        out[i, :min(len(ids), context)] = ids[:context]
    return out


def class_logits(w, grey, text_features, tower, control=False):
    """grey (N, S, S) depth images in [0, 1] -> (N, K) logits: the uint8
    round trip, three channels, CLIP's normalisation, the image tower,
    100 x cosine with the prompts' features."""
    img = torch.round(grey * 255.0) / 255.0
    mean = torch.tensor(IMAGE_MEAN, device=grey.device)[None, :, None, None]
    std = torch.tensor(IMAGE_STD, device=grey.device)[None, :, None, None]
    x = (img[:, None].expand(-1, 3, -1, -1) - mean) / std
    f = encode_image(w, x, tower, control)
    f = f / f.norm(dim=-1, keepdim=True)
    return 100.0 * f @ text_features.T
