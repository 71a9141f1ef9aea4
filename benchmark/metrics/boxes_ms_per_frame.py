"""The box and track stages' wall time over the window, a frame (ms):
``track_clusters``, ``fit_bounding_boxes_simple``, ``propagate_labels``
and ``evaluate_sequence``."""
from . import per_frame_ms


def read(ctx):
    return per_frame_ms(ctx, "track_clusters", "fit_bounding_boxes_simple",
                        "propagate_labels", "evaluate_sequence")
