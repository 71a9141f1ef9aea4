"""The long core's operations and bytes (``flops_long``) and the
reader of ``vit_long_attn_roofline`` on made-up traces."""
import pytest

from benchmark.flops import attention_half_bound_s
from benchmark.flops_long import (core, core_bound_s, halves_compute_bound,
                                  image_layers, tokens)
from benchmark.metrics import read

H100 = {"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12}
L14 = dict(image_size=336, patch_size=14, vision_width=1024,
           vision_layers=24)
B16 = dict(image_size=224, patch_size=16, vision_width=768, vision_layers=12)
CORE = ("void (anonymous namespace)::attention_kernel<19>(__nv_bfloat16 "
        "const*, __nv_bfloat16*, int, int, int, float)")
ONE_PASS = ("void (anonymous namespace)::attention_onepass_kernel<13>("
            "__nv_bfloat16 const*, __nv_bfloat16*, int, int, int, int, "
            "float)")


def test_core_at_577_tokens():
    assert tokens(L14) == 577 and tokens(B16) == 197
    ops, byts = core(577, 1024)
    assert ops == pytest.approx(1.3637e9, rel=1e-4)      # 1.36 GFLOP
    assert byts == pytest.approx(4.727e6, rel=1e-3)      # 4.73 MB
    # the two sides balance: 1.38 us against 1.41 us
    assert ops / H100["bf16_flops"] == pytest.approx(1.379e-6, rel=1e-3)
    assert byts / H100["hbm_bytes_per_s"] == pytest.approx(1.411e-6, rel=1e-3)
    assert core_bound_s(577, 1024, H100) == byts / H100["hbm_bytes_per_s"]


def test_halves_are_compute_bound_only_at_the_long_shape():
    assert halves_compute_bound(577, 1024, H100)
    assert not halves_compute_bound(197, 768, H100)


@pytest.mark.parametrize("images", [1, 3, 2048])
def test_image_layers_recover_the_traced_halves(images):
    bound = 24 * attention_half_bound_s(images, 577, 1024, H100)
    assert image_layers(bound, 577, 1024, H100) == pytest.approx(24 * images)


def _ctx(tower, device_ops, bound):
    trace = {"attention_half_bound_s": bound, "device_ops": device_ops}
    return {"trace": trace, "peak": H100, "tower": tower}


def test_reader_counts_the_long_core_alone():
    items = 2 * 3 * 4 + 4 * 512 * 4        # two calls' images
    bound = sum(24 * attention_half_bound_s(n, 577, 1024, H100)
                for n in (2 * 3 * 4, 4 * 512 * 4))
    least = 24 * items * core_bound_s(577, 1024, H100)
    ops = {CORE[:120]: 2 * least, ONE_PASS[:120]: 5.0,
           "nvjet_tst_192x192": 9.0}
    got = read("vit_long_attn_roofline", _ctx(L14, ops, bound))
    assert got == pytest.approx(50.0)
    assert read("vit_long_attn_roofline", _ctx(
        L14, {ONE_PASS[:120]: 1.0}, bound)) is None
    assert read("vit_long_attn_roofline", {"trace": None, "peak": H100,
                                           "tower": L14}) is None
    # ViT-B/16's halves are bound by bytes at one image: nothing to read
    b16 = sum(12 * attention_half_bound_s(2048, 197, 768, H100) for _ in "ab")
    assert read("vit_long_attn_roofline", _ctx(B16, ops, b16)) is None
