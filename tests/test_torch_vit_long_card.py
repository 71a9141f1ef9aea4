"""Kernel 5 (``fused_attention_proj``, csrc/vit.cu) on the card at
ViT-L/14@336px's width (1024, 16 heads of 64) against its plain version
(models/vit_kernels.attention_proj_plain), across the long attention
core's whole range: T = 209 (its shortest), 257 (ViT-L/14), 320 (its
longest before the range was widened), 321, 577 (ViT-L/14@336px) and 592
(its longest), on ragged batches of 1, 3 and 17 images, with the
tolerances ``chip_smoke.check_vit_kernel`` holds the kernel to (assert_close
rtol 1.6e-2, atol 1e-2, mean |diff| < 1e-3: bf16 outputs of the same
rounding points, products summed in another order). Also: the core a
launch takes, by length, and the refusal past 592 tokens.

The kernel has no CPU mode, so every test here needs a card and skips
without one. On the card, without the JAX package (this file imports none
of it):

    python3 -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_vit_long_card.py
"""
import pytest
import torch

from vilgod_tpu_torch.models import vit_kernels as VK

pytestmark = pytest.mark.card

WIDTH, HEADS = 1024, 16


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def weights(card):
    """One layer's weights at width 1024, drawn from a seed: LayerNorm
    parameters in f32, the products' in bf16 (LeCun-normal kernels)."""
    gen = torch.Generator(device=card).manual_seed(1)

    def draw(*shape, scale=1.0, offset=0.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, device=card, generator=gen)
                .mul_(scale).add_(offset).to(dtype).contiguous())

    return (draw(WIDTH, scale=0.1, offset=1.0, dtype=torch.float32),
            draw(WIDTH, scale=0.05, dtype=torch.float32),
            draw(WIDTH, 3 * WIDTH, scale=WIDTH ** -0.5),
            draw(3 * WIDTH, scale=0.01),
            draw(WIDTH, WIDTH, scale=WIDTH ** -0.5),
            draw(WIDTH, scale=0.01))


def _x(card, b, t, seed):
    gen = torch.Generator(device=card).manual_seed(seed)
    return (torch.randn(b, t, WIDTH, device=card, generator=gen)
            .mul_(0.5).to(torch.bfloat16))


@pytest.mark.parametrize("b", [1, 3, 17])
@pytest.mark.parametrize("t", [209, 257, 320, 321, 577, 592])
def test_kernel_matches_plain_on_the_long_core_range(card, weights, t, b):
    x = _x(card, b, t, seed=1000 * t + b)
    launches = dict(VK.CORE_LAUNCHES)
    got = VK.fused_attention_proj(x, *weights, HEADS)
    torch.cuda.synchronize()
    assert VK.CORE_LAUNCHES["long"] == launches["long"] + 1
    assert VK.CORE_LAUNCHES["onepass"] == launches["onepass"]
    want = VK.attention_proj_plain(x, *weights, HEADS)
    assert got.shape == (b, t, WIDTH) and got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), rtol=1.6e-2,
                               atol=1e-2)
    assert float((got.float() - want.float()).abs().mean()) < 1e-3


def test_one_pass_core_keeps_its_range(card, weights):
    """208 tokens still take the one-pass core, at this width too."""
    x = _x(card, 3, VK.ONE_PASS_TOKENS, seed=7)
    launches = dict(VK.CORE_LAUNCHES)
    got = VK.fused_attention_proj(x, *weights, HEADS)
    torch.cuda.synchronize()
    assert VK.CORE_LAUNCHES["onepass"] == launches["onepass"] + 1
    want = VK.attention_proj_plain(x, *weights, HEADS)
    torch.testing.assert_close(got.float(), want.float(), rtol=1.6e-2,
                               atol=1e-2)


def test_longer_than_the_core_raises(card, weights):
    x = _x(card, 1, VK.MAX_TOKENS + 1, seed=8)
    with pytest.raises(ValueError, match="at most 592 tokens"):
        VK.fused_attention_proj(x, *weights, HEADS)
