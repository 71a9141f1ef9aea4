"""The window's wait for the prefetched sequence builds, a frame (ms):
``run_sequences``' clock pair around each prefetched build's result
(``ZeroShotDetector.prefetch_wait_s``), summed over the window's
sequences (``ctx["prefetch_wait_s"]``)."""


def read(ctx):
    if ctx.get("prefetch_wait_s") is None:
        return None
    return 1e3 * ctx["prefetch_wait_s"] / ctx["frames"]
