"""Time ``csrc/vit.cu`` against variants of itself on the card.

    python3 -m vilgod_tpu_torch.tools.vit_variants [variant ...]

Each variant is a text patch of the source, built into its own library
under ``build/kernels/`` and run in its own process:

- ``base``: the source as it is;
- ``fdiv``: the attention core divides each weight with ``__fdiv_rn``
  instead of ``div_rn`` (the row's reciprocal and one correcting FMA);
- ``fastexp``: the attention core takes ``__expf`` instead of ``expf``;
- ``noepi``: the GEMM skips its epilogue (products only; its output is
  garbage and is not checked).

For each it checks the kernels against their plain versions on a ragged
batch of 3 images (bf16 tolerance, as ``chip_smoke.py``) and prints one
JSON line: the card, and at x (2048, 197, 768) the LayerNorm pass, the
qkv GEMM, the attention core and the output GEMM of
``fused_attention_proj`` (ms, TFLOP/s), and kernels 5, 10 and 11 (ms).
Without a card it exits 2.
"""
from __future__ import annotations

import json
import subprocess
import sys

VARIANTS = {
    "base": [],
    "fdiv": [("div_rn(expf(__fsub_rn(s[n][e], mx[e / 2])), sum[e / 2], rcp[e / 2])",
              "__fdiv_rn(expf(__fsub_rn(s[n][e], mx[e / 2])), sum[e / 2])")],
    "fastexp": [("__fmul_rn(sum[r], expf(", "__fmul_rn(sum[r], __expf("),
                ("acc = __fadd_rn(acc, expf(", "acc = __fadd_rn(acc, __expf("),
                ("div_rn(expf(", "div_rn(__expf(")],
    "noepi": [("if (row < M && col < N) {", "if (row < M && col < N && gelu == 12345) {")],
}


def _ms(fn, reps=5):
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def run(variant: str) -> dict:
    import torch
    from vilgod_tpu_torch.models import vit_kernels as VK
    from vilgod_tpu_torch.utils import cuda_build

    src = (cuda_build.CSRC / "vit.cu").read_text()
    for old, new in VARIANTS[variant]:
        if old not in src:
            raise ValueError(f"{variant}: {old!r} not in vit.cu")
        src = src.replace(old, new)
    path = cuda_build.BUILD_DIR / f"vit_{variant}.cu"
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path.write_text(src)
    VK.LIBRARY = cuda_build.CudaLibrary(str(path), VK.LIBRARY.signatures)

    gen = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, device="cuda", generator=gen)
                * scale).to(dtype)

    w = 768
    ln = (1 + rnd(w, scale=0.1, dtype=torch.float32),
          rnd(w, scale=0.05, dtype=torch.float32))
    attn_w = (rnd(w, 3 * w, scale=0.03), rnd(3 * w, scale=0.01),
              rnd(w, w, scale=0.03), rnd(w, scale=0.01))
    mlp_w = (rnd(w, 4 * w, scale=0.03), rnd(4 * w, scale=0.01),
             rnd(4 * w, w, scale=0.02), rnd(w, scale=0.01))
    out = {"variant": variant}
    if variant != "noepi":
        x = rnd(3, 197, w, scale=0.5)
        x2 = x.reshape(-1, w)
        for name, got, want in (
                ("fused_attention_proj", VK.fused_attention_proj(x, *ln, *attn_w, 12),
                 VK.attention_proj_plain(x, *ln, *attn_w, 12)),
                ("fused_mlp_block", VK.fused_mlp_block(x2, *ln, *mlp_w),
                 VK.mlp_block_plain(x2, *ln, *mlp_w)),
                ("fused_mlp", VK.fused_mlp(x2, *mlp_w), VK.mlp_plain(x2, *mlp_w))):
            torch.testing.assert_close(got.float(), want.float(), rtol=1.6e-2,
                                       atol=1e-2)
            diff = (got.float() - want.float()).abs()
            if float(diff.mean()) >= 1e-3:
                raise AssertionError(f"{name}: mean |kernel - plain| {float(diff.mean())}")
            out[f"{name}_max_abs_err"] = float(diff.max())

    x = rnd(2048, 197, w, scale=0.5)
    x2 = x.reshape(-1, w)
    m = x2.shape[0]
    h = VK.layernorm_cuda(x2, *ln)
    qkv = VK.gemm_cuda(h, attn_w[0], attn_w[1])
    att = VK.attention_core_cuda(qkv, 2048, 197, 12)
    parts = {
        "layernorm": (lambda: VK.layernorm_cuda(x2, *ln), 0),
        "qkv_gemm": (lambda: VK.gemm_cuda(h, attn_w[0], attn_w[1]), 6 * m * w * w),
        "attention_core": (lambda: VK.attention_core_cuda(qkv, 2048, 197, 12),
                           4 * 2048 * 197 * 197 * w),
        "out_gemm": (lambda: VK.gemm_cuda(att, attn_w[2], attn_w[3], res=x2),
                     2 * m * w * w),
    }
    for part, (fn, flop) in parts.items():
        t = _ms(fn)
        out[part] = {"ms": t, "tflop_per_s": flop / t / 1e9}
    out["fused_attention_proj_ms"] = _ms(lambda: VK.fused_attention_proj(x, *ln, *attn_w, 12))
    out["fused_mlp_block_ms"] = _ms(lambda: VK.fused_mlp_block(x2, *ln, *mlp_w))
    out["fused_mlp_ms"] = _ms(lambda: VK.fused_mlp(x2, *mlp_w))
    return out


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("vit_variants: no CUDA device", file=sys.stderr)
        return 2
    if len(argv) == 1 and argv[0] in VARIANTS:
        print(json.dumps(run(argv[0])), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    rc = 0
    for variant in argv or list(VARIANTS):
        rc |= subprocess.run([sys.executable, "-m", "vilgod_tpu_torch.tools.vit_variants",
                              variant], timeout=600).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
