"""The operation and byte counts behind mfu_pct and
vit_attn_roofline."""
import pytest

from benchmark import flops

VITB16 = dict(image_size=224, patch_size=16, vision_width=768,
              vision_layers=12, embed_dim=512)


def test_attention_half_bound_at_the_full_batch():
    peak = flops.peaks("NVIDIA H100 80GB HBM3")
    # 2048 images (512 clusters x 4 views) of 197 tokens: 2.172 ms, bound
    # by its operations
    bound = flops.attention_half_bound_s(2048, 197, 768, peak)
    assert bound * 1e3 == pytest.approx(2.172, abs=5e-4)
    ops, byts = flops.attention_half(2048, 197, 768)
    assert ops / peak["bf16_flops"] > byts / peak["hbm_bytes_per_s"]


def test_small_batches_are_bound_by_bytes():
    peak = flops.peaks("NVIDIA H100 80GB HBM3")
    ops, byts = flops.attention_half(1, 197, 768)
    assert flops.attention_half_bound_s(1, 197, 768, peak) == \
        byts / peak["hbm_bytes_per_s"]


def test_vit_b16_image_flops():
    # 35.1 GFLOP an image: ~17.6 GMAC, as OpenAI's ViT-B/16 is counted
    assert flops.vit_image_flops(VITB16) / 1e9 == pytest.approx(35.127,
                                                                abs=1e-3)


def test_unknown_card_has_no_peak():
    assert flops.peaks("NVIDIA H100 PCIe") is None
