"""``spatial_clustering``'s wall time over the window, a frame (ms)."""
from . import per_frame_ms


def read(ctx):
    return per_frame_ms(ctx, "spatial_clustering")
