"""The ViT kernels: CUDA wrappers, plain PyTorch versions, launch counts
and the ``use_*`` switches. The port of ``vilgod_tpu/models/vit_kernels.py``.

Three functions of a ViT residual block, each one kernel on the TPU:

- :func:`fused_attention_proj`: ``x + out(MHA(qkv(LN(x))))`` over
  (B, T, W), the attention half (on by default for a bf16 tower);
- :func:`fused_mlp_block`: ``x + proj(quickGELU(fc(LN(x))))`` over (M, W),
  the MLP half (on by default for a bf16 tower);
- :func:`fused_mlp`: ``proj(quickGELU(fc(x)))`` (opt-in,
  ``VILGOD_FUSED_MLP=1``).

Weights keep the flax layout (``kernel`` is (in, out)). Each wrapper takes
its plain version only for CPU tensors; for CUDA tensors it composes the
device functions of ``csrc/vit.cu`` (a LayerNorm pass, a bf16 GEMM on
Hopper's tensor cores, TMA loads into an mbarrier ring and ``wgmma``, with
a bias / quickGELU / residual epilogue through shared memory and TMA, and
an attention core with S and P in registers) or raises. They need
sm_90a. The plain versions round where the Pallas kernels round (bf16
after the LayerNorm, after each bias, after quickGELU, after each head's
``w @ v``) and multiply the bf16 operands in f32 with TF32 off, so kernel
and plain version differ only in summation order. ``LAUNCHES`` counts
wrapper calls that launched their kernels, ``CORE_LAUNCHES`` the attention
core's launches by core: at heads of 64 "onepass" up to ``ONE_PASS_TOKENS``
and "long" up to ``MAX_TOKENS``, at heads of 80 "stream" up to
``STREAM_MAX_TOKENS``. Inside a recording (``utils/trace``) each attention
half also counts ``attn_core.onepass``, ``attn_core.long`` or
``attn_core.stream``, on either path: on the CPU the core its head width and
length would take on the card, and each MLP half ``mlp_half.fused``.
"""
from __future__ import annotations

import ctypes
import math
import os

import torch

from ..utils import trace
from ..utils.cuda_build import CudaLibrary, launch, stream_of

KERNEL_NAMES = ("fused_attention_proj", "fused_mlp_block", "fused_mlp")
LAUNCHES = {name: 0 for name in KERNEL_NAMES}
CORE_LAUNCHES = {"onepass": 0, "long": 0, "stream": 0}
LN_EPS = 1e-5
HEAD_DIM = 64  # the one-pass and long cores' head width
STREAM_HEAD_DIM = 80  # the streaming core's (vit.cu kStreamHD)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
LIBRARY = CudaLibrary("vit.cu", {
    # x, M, K, ln_scale, ln_bias, h, stream
    "vit_layernorm": (_P, _I, _I, _P, _P, _P, _P),
    # A, W, bias, res, C, M, N, K, gelu, stream
    "vit_gemm": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # qkv, att, B, T, W, heads, scale, stream
    "vit_attention": (_P, _P, _I, _I, _I, _I, _F, _P),
})


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    for kind in CORE_LAUNCHES:
        CORE_LAUNCHES[kind] = 0


# ---------------------------------------------------------------------------
# plain PyTorch versions (the Pallas kernels' arithmetic, step by step)
# ---------------------------------------------------------------------------

def ln_stats32(x):
    """(x in f32, mean, variance) over the last axis: f32 statistics with
    flax's fast variance ``E[x^2] - E[x]^2`` clipped at 0."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = torch.clamp((x32 * x32).mean(dim=-1, keepdim=True) - mean * mean,
                      min=0.0)
    return x32, mean, var


def ln32(x, scale, bias):
    """f32 ``((x - mean) * rsqrt(var + eps)) * scale + bias``, eps 1e-5
    (``_attn_proj_kernel``; ``clip.layer_norm``)."""
    x32, mean, var = ln_stats32(x)
    h = (x32 - mean) * torch.rsqrt(var + LN_EPS)
    return h * scale.float() + bias.float()


def _mm(a, w):
    """bf16 (or f32) operands multiplied in f32: the f32 accumulator."""
    return torch.matmul(a.float(), w.float())


def _quick_gelu_round(f, dtype):
    """``g = round(f * sigmoid(1.702 f))`` over the rounded ``f``."""
    f32 = f.float()
    return (f32 * torch.sigmoid(1.702 * f32)).to(dtype)


def attention_proj_plain(x, ln_scale, ln_bias, w_qkv, b_qkv, w_out, b_out,
                         heads: int):
    dt = x.dtype
    b, t, width = x.shape
    d = width // heads
    h = ln32(x, ln_scale, ln_bias).to(dt)
    qkv = (_mm(h, w_qkv) + b_qkv.float()).to(dt)
    q, k, v = (a.reshape(b, t, heads, d).transpose(1, 2)
               for a in qkv.split(width, dim=-1))
    scale = 1.0 / math.sqrt(d)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    w = torch.softmax(logits, dim=-1).to(dt)
    att = torch.matmul(w.float(), v.float()).to(dt)
    att = att.transpose(1, 2).reshape(b, t, width)
    return (_mm(att, w_out) + b_out.float() + x.float()).to(dt)


def mlp_block_plain(x, ln_scale, ln_bias, w_fc, b_fc, w_proj, b_proj):
    dt = x.dtype
    h = ln32(x, ln_scale, ln_bias).to(dt)
    f = (_mm(h, w_fc) + b_fc.float()).to(dt)
    g = _quick_gelu_round(f, dt)
    return (_mm(g, w_proj) + b_proj.float() + x.float()).to(dt)


def mlp_plain(x, w_fc, b_fc, w_proj, b_proj):
    dt = x.dtype
    f = (_mm(x, w_fc) + b_fc.float()).to(dt)
    g = _quick_gelu_round(f, dt)
    return (_mm(g, w_proj) + b_proj.float()).to(dt)


PLAIN = {
    "fused_attention_proj": attention_proj_plain,
    "fused_mlp_block": mlp_block_plain,
    "fused_mlp": mlp_plain,
}


# ---------------------------------------------------------------------------
# CUDA composition
# ---------------------------------------------------------------------------

def _check(name, device, **tensors):
    """Every CUDA operand on ``device``, contiguous and 16-byte aligned,
    of the type the kernel reads (LayerNorm parameters f32, the rest
    bf16)."""
    for arg, t in tensors.items():
        want = torch.float32 if arg.startswith("ln_") else torch.bfloat16
        if t.device != device:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected {device}")
        if t.dtype != want:
            raise TypeError(f"{name}: {arg} has dtype {t.dtype}, expected {want}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be contiguous and 16-byte aligned")


MAX_TOKENS = 592  # the long core's longest sequence (vit.cu kMaxT)
ONE_PASS_TOKENS = 208  # the one-pass core's longest (vit.cu kOnePassTiles)
STREAM_MAX_TOKENS = 1040  # the streaming core's longest (vit.cu kStreamMaxT)
MAX_LN_WIDTH = 2048  # the LayerNorm pass holds a row in registers (kLnMaxVecs)


def attention_core_kind(t: int, d: int) -> str:
    """The core that takes ``t`` tokens in heads of ``d``: "stream" at
    heads of 80, else "onepass" or "long"."""
    if d == STREAM_HEAD_DIM:
        return "stream"
    return "onepass" if t <= ONE_PASS_TOKENS else "long"


def _check_dims(name, m, k, n):
    """The GEMM's TMA rows and its epilogue's vectors are 16 bytes: inner
    and outer widths in multiples of 8."""
    if m <= 0 or k <= 0 or n <= 0 or k % 8 or n % 8:
        raise ValueError(f"{name}: the CUDA GEMM needs rows > 0 and inner "
                         f"and outer widths in multiples of 8, got "
                         f"({m}, {k}) x ({k}, {n})")


def layernorm_cuda(x2, ln_scale, ln_bias):
    """h = bf16(LN(x2)) over the rows of a (M, K) bf16 CUDA tensor (one
    launch, not counted)."""
    if x2.shape[1] > MAX_LN_WIDTH:
        raise ValueError(f"the CUDA LayerNorm pass takes rows of at most "
                         f"{MAX_LN_WIDTH}, got {x2.shape[1]}")
    h = torch.empty_like(x2)
    launch(LIBRARY.load().vit_layernorm, x2.data_ptr(), x2.shape[0],
           x2.shape[1], ln_scale.data_ptr(), ln_bias.data_ptr(), h.data_ptr(),
           stream_of(x2.device))
    return h


def gemm_cuda(a, w, bias, res=None, gelu=False):
    """epilogue(a (M, K) @ w (K, N) + bias) on the tensor cores, with
    quickGELU or ``+ res`` (M, N) (one launch, not counted)."""
    m, k = a.shape
    n = w.shape[1]
    c = torch.empty((m, n), dtype=torch.bfloat16, device=a.device)
    launch(LIBRARY.load().vit_gemm, a.data_ptr(), w.data_ptr(),
           bias.data_ptr(), None if res is None else res.data_ptr(),
           c.data_ptr(), m, n, k, int(gelu), stream_of(a.device))
    return c


def attention_core_cuda(qkv, b, t, heads, d):
    """softmax(q k^T / sqrt(d)) v per (image, head) over qkv (B*T, 3W) bf16
    in heads of ``d`` -> (B*T, W) (one launch, counted in
    ``CORE_LAUNCHES``). At heads of 64 the one-pass core
    takes T <= ``ONE_PASS_TOKENS`` (ViT-B/16's 197: every logit of a warp's
    16 rows in registers); the long core 208 < T <= ``MAX_TOKENS``
    (ViT-L/14's 257, ViT-L/14@336px's 577) stages the head's K and V whole
    (175,104 B at 577 tokens) and gives each 16-row query tile to two warps,
    each holding the logits of its half of the keys, so the softmax stays
    exact with one q . k. At 577 tokens the core's 1.36 GFLOP and 4.73 MB
    an image (all heads) balance on the H100: 1.38 against 1.41 us at the
    peaks. At heads of 80 the streaming core takes T <= ``STREAM_MAX_TOKENS``
    (DFN5B ViT-H/14-378's 730, whose K and V no longer fit a block's shared
    memory): K and V pass through a ring of 64-key tiles and the softmax is
    online, the weights rounded to bf16 before their normalisation."""
    width = heads * d
    att = torch.empty((b * t, width), dtype=torch.bfloat16, device=qkv.device)
    launch(LIBRARY.load().vit_attention, qkv.data_ptr(), att.data_ptr(), b, t,
           width, heads, 1.0 / math.sqrt(d), stream_of(qkv.device))
    CORE_LAUNCHES[attention_core_kind(t, d)] += 1
    return att


def fused_attention_proj(x, ln_scale, ln_bias, w_qkv, b_qkv, w_out, b_out,
                         heads: int):
    """``x + out_proj(attention(qkv_proj(LN(x))))`` over (B, T, W) pre-LN
    activations. Replaces ``vit_kernels.fused_attention_proj``."""
    name = "fused_attention_proj"
    b, t, width = x.shape
    if w_qkv.shape != (width, 3 * width) or w_out.shape != (width, width):
        raise ValueError(f"{name}: weights {tuple(w_qkv.shape)}, "
                         f"{tuple(w_out.shape)} do not fit width {width}")
    d = width // heads
    trace.count(f"attn_core.{attention_core_kind(t, d)}")
    if not x.is_cuda:
        return attention_proj_plain(x, ln_scale, ln_bias, w_qkv, b_qkv,
                                    w_out, b_out, heads)
    if width != heads * d or d not in (HEAD_DIM, STREAM_HEAD_DIM):
        raise ValueError(f"{name}: the CUDA attention cores take heads of "
                         f"{HEAD_DIM} or {STREAM_HEAD_DIM}, got width {width} "
                         f"over {heads} heads")
    limit = STREAM_MAX_TOKENS if d == STREAM_HEAD_DIM else MAX_TOKENS
    if t > limit:
        raise ValueError(f"{name}: the CUDA attention core takes at most "
                         f"{limit} tokens at heads of {d}, got {t}")
    _check(name, x.device, x=x, ln_scale=ln_scale, ln_bias=ln_bias,
           w_qkv=w_qkv, b_qkv=b_qkv, w_out=w_out, b_out=b_out)
    m = b * t
    _check_dims(name, m, width, 3 * width)
    with torch.cuda.device(x.device):
        x2 = x.reshape(m, width)
        qkv = gemm_cuda(layernorm_cuda(x2, ln_scale, ln_bias), w_qkv, b_qkv)
        att = attention_core_cuda(qkv, b, t, heads, d)
        out = gemm_cuda(att, w_out, b_out, res=x2)
    LAUNCHES[name] += 1
    return out.reshape(b, t, width)


def fused_mlp_block(x, ln_scale, ln_bias, w_fc, b_fc, w_proj, b_proj):
    """``x + proj(quickGELU(fc(LN(x))))`` over (M, W): the LayerNorm pass,
    the QuickGELU GEMM (its epilogue under the next tile's products) and
    the residual GEMM. Replaces ``vit_kernels.fused_mlp_block``."""
    name = "fused_mlp_block"
    trace.count("mlp_half.fused")
    if not x.is_cuda:
        return mlp_block_plain(x, ln_scale, ln_bias, w_fc, b_fc, w_proj,
                               b_proj)
    _check(name, x.device, x=x, ln_scale=ln_scale, ln_bias=ln_bias,
           w_fc=w_fc, b_fc=b_fc, w_proj=w_proj, b_proj=b_proj)
    m, k = x.shape
    _check_dims(name, m, k, w_fc.shape[1])
    _check_dims(name, m, w_fc.shape[1], k)
    with torch.cuda.device(x.device):
        g = gemm_cuda(layernorm_cuda(x, ln_scale, ln_bias), w_fc, b_fc,
                      gelu=True)
        out = gemm_cuda(g, w_proj, b_proj, res=x)
    LAUNCHES[name] += 1
    return out


def fused_mlp(x, w_fc, b_fc, w_proj, b_proj):
    """``proj(quickGELU(fc(x)))`` over (M, W). Replaces
    ``vit_kernels.fused_mlp``."""
    name = "fused_mlp"
    if not x.is_cuda:
        return mlp_plain(x, w_fc, b_fc, w_proj, b_proj)
    _check(name, x.device, x=x, w_fc=w_fc, b_fc=b_fc, w_proj=w_proj,
           b_proj=b_proj)
    m, k = x.shape
    _check_dims(name, m, k, w_fc.shape[1])
    _check_dims(name, m, w_fc.shape[1], k)
    with torch.cuda.device(x.device):
        out = gemm_cuda(gemm_cuda(x, w_fc, b_fc, gelu=True), w_proj, b_proj)
    LAUNCHES[name] += 1
    return out


# ---------------------------------------------------------------------------
# switches (vit_kernels.py:231-277): the same type and alignment
# conditions; kernel 10 is on by default where JAX's is opt-in, and kernel
# 5 takes heads of 80. On the card the wrapper then launches its kernel;
# on the CPU it takes the plain version, the same arithmetic, so the CPU
# tower runs what the card's kernels are held to.
# ---------------------------------------------------------------------------

def use_fused_attention(dtype, width: int, heads: int) -> bool:
    """On for a bf16 tower with 64-aligned heads (JAX's condition), or
    with heads of 80, which the streaming core takes and JAX's switch
    refuses (``VILGOD_FUSED_ATTN=0`` turns it off)."""
    if os.environ.get("VILGOD_FUSED_ATTN") == "0" or dtype != torch.bfloat16:
        return False
    if width == heads * STREAM_HEAD_DIM:
        return True
    return not ((width // heads) % 64 or width % 128)


def use_fused_mlp_block(dtype, width: int) -> bool:
    """On for a bf16 tower whose width and MLP width are 128-aligned
    (JAX's condition, where the switch stays opt-in):
    ``VILGOD_FUSED_MLP_BLOCK=0`` turns it off."""
    if os.environ.get("VILGOD_FUSED_MLP_BLOCK") == "0":
        return False
    return not (dtype != torch.bfloat16 or width % 128 or (4 * width) % 128)


def use_fused_mlp(dtype, width: int) -> bool:
    """Opt-in: ``VILGOD_FUSED_MLP=1``."""
    if os.environ.get("VILGOD_FUSED_MLP") != "1":
        return False
    return not (dtype != torch.bfloat16 or width % 128 or (4 * width) % 128)
