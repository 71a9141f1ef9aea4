"""Device time of the classifier's gather, transform and 4-view render
(span ``classify.render``, between its two CUDA events) in the spans
pass, a frame (ms)."""


def read(ctx):
    s = ctx.get("spans")
    if s is None or "classify.render" not in s["device_s"]:
        return None
    return 1e3 * s["device_s"]["classify.render"] / s["frames"]
