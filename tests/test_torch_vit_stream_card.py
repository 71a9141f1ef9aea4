"""Kernel 5 (``fused_attention_proj``, csrc/vit.cu) on the card at DFN5B
ViT-H/14-378's width (1280, 16 heads of 80) against its plain version
(models/vit_kernels.attention_proj_plain), over the streaming attention
core's range: T = 593 (past the long core's 592), 730 (ViT-H/14 at 378 px),
1024, 1025 (ViT-L/14 at 448 px) and 1040 (its longest), on batches of 1
and 64 images; also at width 160 (2 heads of 80, the CPU tests' tiny
tower's). Tolerance: assert_close rtol 1.6e-2, atol 1e-2, and mean |diff|
< 1e-3, as for the other cores. Both sides give bf16 outputs; the core
rounds each softmax weight to bf16 before its normalisation where the
plain version rounds after it (a relative step of at most 2^-9 either
way) and sums its products in another order, so the two differ by a few
bf16 steps of the output. Also: heads of 64 at 197 and 577 tokens keep the
one-pass and long cores, and the refusal past 1040 tokens.

The kernel has no CPU mode, so every test here needs a card and skips
without one. On the card, without the JAX package (this file imports none
of it):

    python3 -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_vit_stream_card.py
"""
import pytest
import torch

from vilgod_tpu_torch.models import vit_kernels as VK

pytestmark = pytest.mark.card

WIDTH, HEADS = 1280, 16


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _weights(card, width, seed=1):
    """One layer's weights at ``width``, drawn from a seed: LayerNorm
    parameters in f32, the products' in bf16 (LeCun-normal kernels)."""
    gen = torch.Generator(device=card).manual_seed(seed)

    def draw(*shape, scale=1.0, offset=0.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, device=card, generator=gen)
                .mul_(scale).add_(offset).to(dtype).contiguous())

    return (draw(width, scale=0.1, offset=1.0, dtype=torch.float32),
            draw(width, scale=0.05, dtype=torch.float32),
            draw(width, 3 * width, scale=width ** -0.5),
            draw(3 * width, scale=0.01),
            draw(width, width, scale=width ** -0.5),
            draw(width, scale=0.01))


@pytest.fixture(scope="module")
def weights(card):
    return _weights(card, WIDTH)


def _x(card, b, t, seed, width=WIDTH):
    gen = torch.Generator(device=card).manual_seed(seed)
    return (torch.randn(b, t, width, device=card, generator=gen)
            .mul_(0.5).to(torch.bfloat16))


def _held(got, want):
    torch.testing.assert_close(got.float(), want.float(), rtol=1.6e-2,
                               atol=1e-2)
    assert float((got.float() - want.float()).abs().mean()) < 1e-3


@pytest.mark.parametrize("b", [1, 64])
@pytest.mark.parametrize("t", [593, 730, 1024, 1025, 1040])
def test_kernel_matches_plain_on_the_stream_core(card, weights, t, b):
    x = _x(card, b, t, seed=1000 * t + b)
    launches = dict(VK.CORE_LAUNCHES)
    got = VK.fused_attention_proj(x, *weights, HEADS)
    torch.cuda.synchronize()
    assert VK.CORE_LAUNCHES == {**launches, "stream": launches["stream"] + 1}
    assert got.shape == (b, t, WIDTH) and got.dtype == torch.bfloat16
    _held(got, VK.attention_proj_plain(x, *weights, HEADS))


def test_two_heads_of_80(card):
    """The CPU tests' tiny tower's width: 160, two heads of 80."""
    w = _weights(card, 160, seed=2)
    x = _x(card, 3, 730, seed=9, width=160)
    got = VK.fused_attention_proj(x, *w, 2)
    torch.cuda.synchronize()
    _held(got, VK.attention_proj_plain(x, *w, 2))


@pytest.mark.parametrize("t,core", [(197, "onepass"), (577, "long")])
def test_heads_of_64_keep_their_cores(card, t, core):
    """ViT-B/16's 197 tokens and ViT-L/14@336px's 577 at heads of 64 take
    the one-pass and the long core as before, one launch a call."""
    w = _weights(card, 1024, seed=3)
    x = _x(card, 2, t, seed=t, width=1024)
    launches = dict(VK.CORE_LAUNCHES)
    got = VK.fused_attention_proj(x, *w, 16)
    torch.cuda.synchronize()
    assert VK.CORE_LAUNCHES == {**launches, core: launches[core] + 1}
    _held(got, VK.attention_proj_plain(x, *w, 16))


def test_longer_than_the_stream_core_raises(card, weights):
    x = _x(card, 1, VK.STREAM_MAX_TOKENS + 1, seed=8)
    with pytest.raises(ValueError, match="at most 1040 tokens at heads of 80"):
        VK.fused_attention_proj(x, *weights, HEADS)
