"""``mask_ground_points``'s wall time over the window, a frame (ms)."""
from . import per_frame_ms


def read(ctx):
    return per_frame_ms(ctx, "mask_ground_points")
