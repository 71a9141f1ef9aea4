"""Kernel 5's (``fused_attention_proj``) share of its roofline (%): the
least time of the traced sequence's calls, from their shapes
(``flops.attention_half_bound_s``), over the device time of
``csrc/vit.cu``'s kernels, which on the main path only kernel 5
launches."""


def read(ctx):
    t = ctx["trace"]
    if t is None or not t["vit_cu_s"] or not t["attention_half_bound_s"]:
        return None
    return 100.0 * t["attention_half_bound_s"] / t["vit_cu_s"]
