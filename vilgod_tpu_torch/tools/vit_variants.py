"""Time ``csrc/vit.cu`` against variants of itself on the card.

    python3 -m vilgod_tpu_torch.tools.vit_variants [variant ...]

Each variant is a text patch of the source (every anchor must occur in it
exactly once), built into its own library under ``build/kernels/`` and run
in its own process:

- ``base``: the source as it is;
- ``fdiv``: the one-pass attention core divides each weight with
  ``__fdiv_rn`` instead of ``div_rn`` (the row's reciprocal and one
  correcting FMA);
- ``fastexp``: the one-pass core takes ``__expf`` instead of ``expf``;
- ``regs128``: the one-pass core held to 128 registers a thread (the
  budget of 16 warps an SM, 4 a scheduler) instead of up to 255;
- ``warps16``: the one-pass core with 16 warps a block, so the tiles of
  two heads are in flight at once (128 registers a thread; two query
  tiles in flight per warp would hold 208 logits a thread);
- ``single_buffer``: the one-pass core copies the block's next head in
  only once every warp has left this one, instead of two heads ahead;
- ``smem_logits``: the one-pass core, single-buffered, keeps each thread's
  104 logits in shared memory (13 KB a warp beside Q, K and V) instead of
  registers;
- ``storewait``: the GEMM waits for each tile's TMA store to have read
  shared memory before it goes on to the next tile's products;
- ``nostore``, ``noarith``, ``noepi``: the GEMM skips its epilogue's TMA
  store, its arithmetic and shared-memory writes, or both (products only);
  their outputs are garbage and are not checked.

For each it prints ptxas's registers and spill stores per kernel and checks
the kernels against their plain versions on a ragged batch of 3 images and
on 16 images of 257 tokens (the long core; bf16 tolerance, as
``chip_smoke.py``), then prints one JSON line: at x (2048, 197, 768) the
LayerNorm pass, the qkv GEMM, the attention core and the output GEMM of
``fused_attention_proj`` (ms, TFLOP/s), and kernels 5, 10 and 11 (ms). The
card's name and power limit come first. Without a card it exits 2.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys

# the one-pass core's launch bound, and its two buffers made one
_ONEPASS_BOUND = "__launch_bounds__(32 * kOnePassWarps, 1)"
_SINGLE_BUFFER = [
    ("    bf16* q = bufs + (k & 1) * buf_elems;\n", "    bf16* q = bufs;\n"),
    ("smem_u32(&full[k & 1]))\n", "smem_u32(&full[0]))\n"),
    ("  if (warp == warps - 1 && n_items > 1) load(1);\n", ""),
    ("    mbar_wait(smem_u32(&full[k & 1]), (k >> 1) & 1);\n"
     "    bf16* Qs = bufs + (k & 1) * buf_elems;\n",
     "    mbar_wait(smem_u32(&full[0]), k & 1);\n"
     "    bf16* Qs = bufs;\n"),
    ("last = atomicAdd(&left[k & 1], 1) == warps * (k / 2 + 1) - 1;",
     "last = atomicAdd(&left[0], 1) == warps * (k + 1) - 1;"),
    ("&& k + 2 < n_items) load(k + 2);", "&& k + 1 < n_items) load(k + 1);"),
]

# the GEMM epilogue's arithmetic (and shared-memory writes), its TMA store
_NO_ARITH = [("for (int j = 0; j < kBN / 8; ++j) {\n        const float2 b2",
              "for (int j = 0; j < kBN / 8 && M == -12345; ++j) {\n        const float2 b2")]
_NO_STORE = [("if (row0 < M && n0 + 64 * c < N)", "if (M == -12345)")]

VARIANTS = {
    "base": [],
    "fdiv": [("w[e] = div_rn(s[j][n][e], sum[e / 2], rcp[e / 2]);",
              "w[e] = __fdiv_rn(s[j][n][e], sum[e / 2]);")],
    "fastexp": [("s[j][n][2 * r + e] = expf(", "s[j][n][2 * r + e] = __expf(")],
    "regs128": [(_ONEPASS_BOUND, "__maxnreg__(128)")],
    "warps16": [("constexpr int kOnePassWarps = 8;", "constexpr int kOnePassWarps = 16;")],
    "single_buffer": _SINGLE_BUFFER,
    "smem_logits": _SINGLE_BUFFER + [
        ("      float s[NT][2][4];\n",
         "      float (&s)[NT][2][4] = *reinterpret_cast<float (*)[NT][2][4]>(\n"
         "          reinterpret_cast<float*>(bufs + buf_elems) + threadIdx.x * 105);\n"),
        ("return 2 * sizeof(bf16) * 3 * (size_t)pad16(T) * kKvLd; }",
         "return sizeof(bf16) * 3 * (size_t)pad16(T) * kKvLd + 4 * 105 * 32 * kOnePassWarps; }")],
    "storewait": [("        bulk_commit();\n",
                   "        bulk_commit();\n        bulk_wait_read();\n")],
    "nostore": _NO_STORE,
    "noarith": _NO_ARITH,
    "noepi": _NO_ARITH + _NO_STORE,
}


def patched_source(variant: str, src: str) -> str:
    """``src`` with ``variant``'s patches; each anchor must occur once."""
    for old, new in VARIANTS[variant]:
        if src.count(old) != 1:
            raise ValueError(f"{variant}: {old!r} occurs {src.count(old)} "
                             f"times in vit.cu, not once")
        src = src.replace(old, new)
    return src


def ptxas_kernels(log_text: str) -> dict:
    """{kernel (template arguments in brackets): [registers, spill bytes]}
    from a ptxas report."""
    out = {}
    for entry in log_text.split("Compiling entry function")[1:]:
        fn = re.search(r"\d\d?((?:[a-z]+\d?_)+kernel)(?:I((?:Li\d+E)+)E)?", entry)
        reg = re.search(r"Used (\d+) registers", entry)
        spill = re.search(r"(\d+) bytes spill stores", entry)
        if fn and reg:
            name = fn.group(1)
            if fn.group(2):
                name += f"<{', '.join(re.findall(r'\d+', fn.group(2)))}>"
            out[name] = [int(reg.group(1)), int(spill.group(1)) if spill else 0]
    return out


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


def _check(name, got, want):
    import torch
    torch.testing.assert_close(got.float(), want.float(), rtol=1.6e-2, atol=1e-2)
    diff = (got.float() - want.float()).abs()
    if float(diff.mean()) >= 1e-3:
        raise AssertionError(f"{name}: mean |kernel - plain| {float(diff.mean())}")
    return float(diff.max())


def run(variant: str) -> dict:
    import torch
    from vilgod_tpu_torch.models import vit_kernels as VK
    from vilgod_tpu_torch.utils import cuda_build

    src = patched_source(variant, (cuda_build.CSRC / "vit.cu").read_text())
    path = cuda_build.BUILD_DIR / f"vit_{variant}.cu"
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path.write_text(src)
    VK.LIBRARY = cuda_build.CudaLibrary(str(path), VK.LIBRARY.signatures)
    VK.LIBRARY.load()

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
    out = {"variant": variant, "ptxas": ptxas_kernels(
        VK.LIBRARY.path.with_suffix(".log").read_text())}
    if variant not in ("nostore", "noarith", "noepi"):
        x = rnd(3, 197, w, scale=0.5)
        x2 = x.reshape(-1, w)
        long_x = rnd(16, 257, w, scale=0.5)
        for name, got, want in (
                ("fused_attention_proj", VK.fused_attention_proj(x, *ln, *attn_w, 12),
                 VK.attention_proj_plain(x, *ln, *attn_w, 12)),
                ("fused_attention_proj_t257",
                 VK.fused_attention_proj(long_x, *ln, *attn_w, 12),
                 VK.attention_proj_plain(long_x, *ln, *attn_w, 12)),
                ("fused_mlp_block", VK.fused_mlp_block(x2, *ln, *mlp_w),
                 VK.mlp_block_plain(x2, *ln, *mlp_w)),
                ("fused_mlp", VK.fused_mlp(x2, *mlp_w), VK.mlp_plain(x2, *mlp_w))):
            out[f"{name}_max_abs_err"] = _check(name, got, want)

    x = rnd(2048, 197, w, scale=0.5)
    x2 = x.reshape(-1, w)
    m = x2.shape[0]
    h = VK.layernorm_cuda(x2, *ln)
    qkv = VK.gemm_cuda(h, attn_w[0], attn_w[1])
    att = VK.attention_core_cuda(qkv, 2048, 197, 12, 64)
    parts = {
        "layernorm": (lambda: VK.layernorm_cuda(x2, *ln), 0),
        "qkv_gemm": (lambda: VK.gemm_cuda(h, attn_w[0], attn_w[1]), 6 * m * w * w),
        "attention_core": (lambda: VK.attention_core_cuda(qkv, 2048, 197,
                                                          12, 64),
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
