"""Device time of the RANSAC Gumbel draw and its top-3 (span
``filter.ransac_draw``, between its two CUDA events) in the spans pass,
a frame (ms)."""


def read(ctx):
    s = ctx.get("spans")
    if s is None or "filter.ransac_draw" not in s["device_s"]:
        return None
    return 1e3 * s["device_s"]["filter.ransac_draw"] / s["frames"]
