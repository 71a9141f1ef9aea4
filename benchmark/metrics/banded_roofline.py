"""Kernels 1-4's share of their roofline in the spans pass (%): the
least time of every counted banded launch (``spans.banded_bound_s``
over the pairs in its blocks' true spans) over the device time of
``csrc/banded.cu``'s kernels."""


def read(ctx):
    s = ctx.get("spans")
    if s is None or not s["banded_cu_s"] or not s["banded_bound_s"]:
        return None
    return 100.0 * s["banded_bound_s"] / s["banded_cu_s"]
