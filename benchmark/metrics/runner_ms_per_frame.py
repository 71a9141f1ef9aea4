"""The window's wall less the runner's stage times, a frame (ms): the
state builds the prefetch thread did not hide, and result handling."""


def read(ctx):
    if not ctx["stage_s"]:
        return None
    return 1e3 * (ctx["window_s"] - sum(ctx["stage_s"].values())) \
        / ctx["frames"]
