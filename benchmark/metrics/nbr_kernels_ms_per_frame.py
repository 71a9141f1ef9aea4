"""Device time of the neighbour kernels (``csrc/banded.cu`` and
``csrc/dense.cu``) in the traced sequence, a frame (ms)."""


def read(ctx):
    t = ctx["trace"]
    if t is None or not t["neighbour_cu_s"]:
        return None
    return 1e3 * t["neighbour_cu_s"] / t["frames"]
