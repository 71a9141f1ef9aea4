"""The streaming attention core's share of its roofline (%): the least
time of the core over the traced sequence's (image, layer) pairs
(``flops_long``: max(4 T^2 W / bf16 peak, 4 T W x 2 B / HBM bandwidth)
an image and layer) over the device time of ``csrc/vit.cu``'s
``attention_stream_kernel`` (heads of 80; the one-pass and long cores'
kernels not counted). The pairs come from the traced attention halves'
least time, so the reader reads only where every half is compute-bound
(DFN5B ViT-H/14-378's 730 tokens at width 1280: about 730 operations a
byte at one image), and nothing where no launch of the core was traced."""
import re

from ..flops_long import (core_bound_s, halves_compute_bound, image_layers,
                          tokens)

CORE = re.compile(
    r"^void \(anonymous namespace\)::attention_stream_kernel(?=[<(])")


def read(ctx):
    t, peak, tower = ctx["trace"], ctx["peak"], ctx["tower"]
    if t is None or peak is None or not t["attention_half_bound_s"]:
        return None
    n, w = tokens(tower), tower["vision_width"]
    if not halves_compute_bound(n, w, peak):
        return None
    device_s = sum(s for name, s in t["device_ops"].items()
                   if CORE.match(name))
    if not device_s:
        return None
    pairs = image_layers(t["attention_half_bound_s"], n, w, peak)
    return 100.0 * pairs * core_bound_s(n, w, peak) / device_s
