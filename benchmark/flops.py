"""Operations and bytes of the work the per-layer metrics weigh, from
shapes alone, and the card's peaks (``peaks.json``)."""
from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json")
                   .read_text())


def peaks(device_name: str) -> dict | None:
    """The published peaks of the card named ``device_name``, or None."""
    return PEAKS.get(device_name)


def vit_image_flops(t: dict) -> float:
    """Floating-point operations of one image through the vision tower
    (``t`` the configuration's ``clip`` group): the patch product, per
    layer the qkv, attention, output and MLP products, the projection."""
    p, w = t["patch_size"], t["vision_width"]
    n = (t["image_size"] // p) ** 2
    tok = n + 1
    layer = (2 * tok * w * 3 * w + 4 * tok * tok * w + 2 * tok * w * w
             + 2 * 2 * tok * w * 4 * w)
    return 2 * n * p * p * 3 * w + t["vision_layers"] * layer \
        + 2 * w * t["embed_dim"]


def attention_half(b: int, t: int, d: int) -> tuple[float, float]:
    """(operations, bytes) of one ``fused_attention_proj`` call on x (b, t,
    d) in bf16: LayerNorm, the qkv product, attention, the output product
    and the residual; x, the weights, biases and LayerNorm parameters
    read once and the output written once."""
    ops = 2 * b * t * d * 3 * d + 4 * b * t * t * d + 2 * b * t * d * d
    byts = (2 * b * t * d * 2 + 2 * (d * 3 * d + 3 * d + d * d + d)
            + 4 * 2 * d)
    return float(ops), float(byts)


def attention_half_bound_s(b: int, t: int, d: int, peak: dict) -> float:
    """The least time of one call: the larger of its operations over the
    bf16 peak and its bytes over the memory bandwidth."""
    ops, byts = attention_half(b, t, d)
    return max(ops / peak["bf16_flops"], byts / peak["hbm_bytes_per_s"])
