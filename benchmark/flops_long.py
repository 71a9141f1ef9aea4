"""Operations and bytes of the long attention core of ``csrc/vit.cu``
(``attention_kernel``, 208 < T <= 592: ViT-L/14@336px's 577 tokens), from
shapes alone, and the count of (image, layer) pairs behind the traced
attention halves' least time."""
from __future__ import annotations

from .flops import attention_half


def tokens(tower: dict) -> int:
    """The vision tower's sequence length: patches and the class token."""
    return (tower["image_size"] // tower["patch_size"]) ** 2 + 1


def core(t: int, w: int) -> tuple[float, float]:
    """(operations, bytes) of the core on one image of one layer: q . k and
    w . v over every head (4 T^2 W); q, k and v read once and the output
    written once, in bf16 (4 T W x 2 B)."""
    return 4.0 * t * t * w, 4.0 * t * w * 2


def core_bound_s(t: int, w: int, peak: dict) -> float:
    """The least time of the core on one image of one layer."""
    ops, byts = core(t, w)
    return max(ops / peak["bf16_flops"], byts / peak["hbm_bytes_per_s"])


def halves_compute_bound(t: int, w: int, peak: dict) -> bool:
    """Whether every ``fused_attention_proj`` call at (t, w) is bounded by
    its operations: its operations per byte grow with the images of the
    call, so one image is the least."""
    ops, byts = attention_half(1, t, w)
    return ops / byts >= peak["bf16_flops"] / peak["hbm_bytes_per_s"]


def image_layers(halves_bound_s: float, t: int, w: int, peak: dict) -> float:
    """The (image, layer) pairs of the traced attention halves, from the
    sum of their least times: exact where every half is compute-bound
    (:func:`halves_compute_bound`), each then taking its images' operations
    over the peak."""
    return halves_bound_s * peak["bf16_flops"] / attention_half(1, t, w)[0]
