"""The plain PyTorch versions of the three ViT kernels
(vilgod_tpu_torch/models/vit_kernels.py) against the JAX package's Pallas
kernels run in interpret mode, at the shapes of tests/test_clip.py:
attention (3, T, 256) with 4 heads at T = 197, at the edge of the CUDA
core's one-pass path (208, the longest it takes, and 209, the shortest of
the long core), at 321 (past the long core's old limit of 320) and at 577
(ViT-L/14@336px), MLPs (300, 256 -> 1024). In f32 they agree within
1e-4; in bf16 within the tolerance the kernels are held to on the card
(assert_close rtol 1.6e-2, atol 1e-2, mean |diff| < 1e-3): the same
rounding points, products in another summation order. On the CPU the
wrappers take these plain versions and count no launch. The text patches
of ``tools/vit_variants.py`` are held to the CUDA source."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from vilgod_tpu.models import vit_kernels as VJ
from vilgod_tpu_torch.models import vit_kernels as VT
from vilgod_tpu_torch.tools import vit_variants
from vilgod_tpu_torch.utils.cuda_build import CSRC


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per pytest worker (see test_torch_slice.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(seed, shapes, dt):
    """Seeded numpy arrays, rounded to the JAX dtype, as (jax, torch)
    pairs; LayerNorm parameters stay f32."""
    jdt, tdt = DTYPES[dt]
    rng = np.random.default_rng(seed)
    out = []
    for name, (shape, scale, offset) in shapes.items():
        a = (offset + scale * rng.normal(size=shape)).astype(np.float32)
        if name.startswith("ln"):
            out.append((jnp.asarray(a), torch.from_numpy(a)))
            continue
        j = jnp.asarray(a, jdt)
        out.append((j, torch.from_numpy(np.asarray(j, np.float32)).to(tdt)))
    return out


def _compare(got, want, dt):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    if dt == "f32":
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    else:
        torch.testing.assert_close(torch.from_numpy(got),
                                   torch.from_numpy(want), rtol=1.6e-2,
                                   atol=1e-2)
        assert np.abs(got - want).mean() < 1e-3


# T = 197 keeps the ids it had before the boundary cases were added; 321
# lies past the long core's old limit of 320, 577 is ViT-L/14@336px's length
@pytest.mark.parametrize("t,dt", [
    pytest.param(t, dt, id=dt if t == 197 else f"{t}-{dt}")
    for t in (197, VT.ONE_PASS_TOKENS, VT.ONE_PASS_TOKENS + 1, 321, 577)
    for dt in ("f32", "bf16")])
def test_attention_proj_plain_matches_pallas(t, dt):
    b, w, heads = 3, 256, 4
    args = _inputs(0, {"x": ((b, t, w), 0.3, 0), "ln_s": ((w,), 0.1, 1.0),
                       "ln_b": ((w,), 0.05, 0), "wqkv": ((w, 3 * w), 0.05, 0),
                       "bqkv": ((3 * w,), 0.01, 0), "wout": ((w, w), 0.05, 0),
                       "bout": ((w,), 0.01, 0)}, dt)
    want = VJ.fused_attention_proj(*(a for a, _ in args), heads,
                                   interpret=True)
    VT.reset_launches()
    got = VT.fused_attention_proj(*(a for _, a in args), heads)
    assert got.dtype == DTYPES[dt][1] and got.shape == (b, t, w)
    _compare(got, want, dt)
    assert VT.LAUNCHES["fused_attention_proj"] == 0   # CPU: plain version


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_mlp_block_plain_matches_pallas(dt):
    m, k, h = 300, 256, 1024
    args = _inputs(1, {"x": ((m, k), 0.3, 0), "ln_s": ((k,), 0.1, 1.0),
                       "ln_b": ((k,), 0.05, 0), "wf": ((k, h), 0.05, 0),
                       "bf": ((h,), 0.01, 0), "wp": ((h, k), 0.05, 0),
                       "bp": ((k,), 0.01, 0)}, dt)
    want = VJ.fused_mlp_block(*(a for a, _ in args), interpret=True)
    got = VT.fused_mlp_block(*(a for _, a in args))
    _compare(got, want, dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_mlp_plain_matches_pallas(dt):
    m, k, h = 300, 256, 1024
    args = _inputs(2, {"x": ((m, k), 0.5, 0), "wf": ((k, h), 0.05, 0),
                       "bf": ((h,), 0.01, 0), "wp": ((h, k), 0.05, 0),
                       "bp": ((k,), 0.01, 0)}, dt)
    want = VJ.fused_mlp(*(a for a, _ in args), interpret=True)
    got = VT.fused_mlp(*(a for _, a in args))
    _compare(got, want, dt)


def test_switches_follow_the_jax_conditions(monkeypatch):
    """The same type and alignment conditions as the JAX switches (without
    the platform test: the CPU runs the plain version), but for heads of
    80, which the streaming core takes and JAX refuses, and for kernel 10,
    on by default for a bf16 tower (``VILGOD_FUSED_MLP_BLOCK=0`` turns it
    off) where JAX's is opt-in. Kernel 11 stays opt-in."""
    for var in ("VILGOD_FUSED_ATTN", "VILGOD_FUSED_MLP_BLOCK",
                "VILGOD_FUSED_MLP"):
        monkeypatch.delenv(var, raising=False)
    bf16 = torch.bfloat16
    assert VT.use_fused_attention(bf16, 768, 12)
    assert VT.use_fused_attention(bf16, 128, 2)
    assert not VT.use_fused_attention(torch.float32, 768, 12)
    assert VT.use_fused_attention(bf16, 1280, 16)         # heads of 80
    assert VT.use_fused_attention(bf16, 160, 2)
    assert not VT.use_fused_attention(torch.float32, 1280, 16)
    assert not VT.use_fused_attention(bf16, 512, 16)      # head dim 32
    assert not VT.use_fused_attention(bf16, 64, 1)        # width % 128
    monkeypatch.setenv("VILGOD_FUSED_ATTN", "0")
    assert not VT.use_fused_attention(bf16, 768, 12)
    assert not VT.use_fused_attention(bf16, 1280, 16)
    for width in (768, 1024, 1280):          # B/16, L/14@336px, H/14-378
        assert VT.use_fused_mlp_block(bf16, width)
        assert not VT.use_fused_mlp_block(torch.float32, width)
    assert not VT.use_fused_mlp_block(bf16, 64)            # width % 128
    assert not VT.use_fused_mlp_block(bf16, 160)
    monkeypatch.setenv("VILGOD_FUSED_MLP_BLOCK", "1")
    assert VT.use_fused_mlp_block(bf16, 1280)
    monkeypatch.setenv("VILGOD_FUSED_MLP_BLOCK", "0")
    for width in (768, 1024, 1280):
        assert not VT.use_fused_mlp_block(bf16, width)
    assert not VT.use_fused_mlp(bf16, 768)                 # opt-in
    monkeypatch.setenv("VILGOD_FUSED_MLP", "1")
    assert VT.use_fused_mlp(bf16, 768)
    assert not VT.use_fused_mlp(torch.float32, 768)
    assert not VT.use_fused_mlp(bf16, 64)


@pytest.mark.parametrize("variant", sorted(vit_variants.VARIANTS))
def test_vit_variant_anchors_occur_once_in_the_source(variant):
    """Each variant's text patches apply to ``csrc/vit.cu`` as it is: every
    anchor occurs exactly once, so a change of the source cannot silently
    leave a variant timing the unpatched kernels."""
    src = (CSRC / "vit.cu").read_text()
    patched = vit_variants.patched_source(variant, src)
    assert (patched == src) == (variant == "base")
