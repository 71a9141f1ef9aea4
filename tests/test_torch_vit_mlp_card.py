"""Kernel 10 (``fused_mlp_block``, csrc/vit.cu: the LayerNorm pass, the
QuickGELU GEMM and the residual GEMM) on the card against its plain
version (models/vit_kernels.mlp_block_plain) at the large towers' widths:
ViT-L/14@336px's (1024 -> 4096) over images of 577 tokens and DFN5B
ViT-H/14-378's (1280 -> 5120) over images of 730, a few dozen images a
call, so M is no multiple of the GEMM's 128-row tile and its ragged edge is
covered; also one text prompt's 77 rows. Kernel 11 (``fused_mlp``), which
shares the QuickGELU GEMM, at the same widths. Tolerance: kernel 5's card
tests' (assert_close rtol 1.6e-2, atol 1e-2, mean |diff| < 1e-3): the same
rounding points, products summed in another order. Last, a tiny bf16
tower's image call launches kernel 10 once a layer and counts
``mlp_half.fused`` once a layer.

The kernels have no CPU mode, so every test here needs a card and skips
without one. On the card, without the JAX package (this file imports none
of it):

    python3 -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_vit_mlp_card.py
"""
import pytest
import torch

from vilgod_tpu_torch.models import vit_kernels as VK
from vilgod_tpu_torch.utils import trace

pytestmark = pytest.mark.card


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _weights(card, width, seed):
    """One layer's MLP weights at ``width``, drawn from a seed: LayerNorm
    parameters in f32, the products' in bf16 (LeCun-normal kernels, small
    biases)."""
    gen = torch.Generator(device=card).manual_seed(seed)

    def draw(*shape, scale=1.0, offset=0.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, device=card, generator=gen)
                .mul_(scale).add_(offset).to(dtype).contiguous())

    return (draw(width, scale=0.1, offset=1.0, dtype=torch.float32),
            draw(width, scale=0.05, dtype=torch.float32),
            draw(width, 4 * width, scale=width ** -0.5),
            draw(4 * width, scale=0.01),
            draw(4 * width, width, scale=(4 * width) ** -0.5),
            draw(width, scale=0.01))


def _x(card, m, width, seed):
    gen = torch.Generator(device=card).manual_seed(seed)
    return (torch.randn(m, width, device=card, generator=gen)
            .mul_(0.5).to(torch.bfloat16))


def _held(got, want):
    torch.testing.assert_close(got.float(), want.float(), rtol=1.6e-2,
                               atol=1e-2)
    assert float((got.float() - want.float()).abs().mean()) < 1e-3


SHAPES = [(24 * 577, 1024), (40 * 577, 1024), (77, 1024),
          (24 * 730, 1280), (36 * 730, 1280), (77, 1280)]


@pytest.mark.parametrize("m,width", SHAPES)
def test_kernel_10_matches_plain(card, m, width):
    assert m % 128, "M must leave a ragged last tile"
    w = _weights(card, width, seed=width)
    x = _x(card, m, width, seed=m)
    launches = VK.LAUNCHES["fused_mlp_block"]
    got = VK.fused_mlp_block(x, *w)
    torch.cuda.synchronize()
    assert VK.LAUNCHES["fused_mlp_block"] == launches + 1
    assert got.shape == (m, width) and got.dtype == torch.bfloat16
    _held(got, VK.mlp_block_plain(x, *w))


@pytest.mark.parametrize("m,width", [(24 * 577, 1024), (24 * 730, 1280)])
def test_kernel_11_matches_plain(card, m, width):
    w = _weights(card, width, seed=width + 1)
    x = _x(card, m, width, seed=m + 1)
    got = VK.fused_mlp(x, *w[2:])
    torch.cuda.synchronize()
    _held(got, VK.mlp_plain(x, *w[2:]))


def test_tower_takes_kernel_10_once_a_layer(card, monkeypatch):
    """A tiny bf16 tower (width 128, 2 layers, 17 tokens): each image call
    launches kernel 10 once a layer and counts ``mlp_half.fused`` once a
    layer; its features agree with the unfused composite's
    (``VILGOD_FUSED_MLP_BLOCK=0``) to a cosine of 0.999."""
    from vilgod_tpu_torch.models import clip as C

    monkeypatch.delenv("VILGOD_FUSED_MLP_BLOCK", raising=False)
    cfg = C.CLIPConfig(image_size=64, patch_size=16, vision_width=128,
                       vision_layers=2, vision_heads=2, embed_dim=64,
                       text_width=128, text_heads=2, text_layers=1,
                       dtype=torch.bfloat16)
    model = C.init_clip_params(cfg, seed=5, device=card)
    gen = torch.Generator(device=card).manual_seed(6)
    images = torch.rand(3, 64, 64, 3, device=card, generator=gen)
    VK.reset_launches()
    with trace.recording() as t, torch.no_grad():
        got = model.encode_image(images).float()
        model.encode_image(images[:2])
        torch.cuda.synchronize()
    assert VK.LAUNCHES["fused_mlp_block"] == 2 * cfg.vision_layers
    assert t.total("mlp_half.fused") == 2 * cfg.vision_layers
    monkeypatch.setenv("VILGOD_FUSED_MLP_BLOCK", "0")
    with torch.no_grad():
        want = model.encode_image(images).float()
    assert VK.LAUNCHES["fused_mlp_block"] == 2 * cfg.vision_layers
    cos = torch.nn.functional.cosine_similarity(got, want)
    assert float(cos.min()) >= 0.999
