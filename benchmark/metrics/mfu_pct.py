"""The window's share of the card's bf16 peak (%): the vision tower's
operations for the images the detections need (four views each, not
the padded batches) over the untraced window's wall."""
from ..flops import vit_image_flops


def read(ctx):
    if ctx["peak"] is None or not ctx["images_needed"]:
        return None
    flops = ctx["images_needed"] * vit_image_flops(ctx["tower"])
    return 100.0 * flops / (ctx["window_s"] * ctx["peak"]["bf16_flops"])
