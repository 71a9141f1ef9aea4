"""Reduction of the traced pass's device events (name, start ns, end ns)
to what the per-layer metrics and the breakdown read."""
from __future__ import annotations

import re
from collections import defaultdict

from .flops import attention_half_bound_s

MARKER = "spin_kernel"
NUM_VIEWS = 4
# the program's kernels by source, all in each source's anonymous namespace
_OWN = r"^void \(anonymous namespace\)::({})(?=[<(])"
VIT_CU = re.compile(_OWN.format(
    "layernorm_kernel|gemm_kernel|attention_onepass_kernel|attention_kernel"))
NEIGHBOUR_CU = re.compile(_OWN.format(
    "count_kernel|min_label_kernel|nearest_kernel|box_kernel"
    "|nearest_bound_kernel|nearest_unpack_kernel|fill_kernel"))


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(traced: dict, tower: dict, peak: dict | None) -> dict:
    """busy and window seconds, idle seconds by stage, device seconds by
    operation, of ``vit.cu`` and of the neighbour kernels, and the least
    time of the traced attention halves."""
    events = sorted(traced["events"], key=lambda e: e[1])
    marks = [e[1] for e in events if MARKER in e[0]]
    stages = traced["stages"]
    if len(marks) == len(stages) + 1:
        t0, t1 = marks[0], marks[-1]
    else:
        marks = []
        t0, t1 = events[0][1], max(e[2] for e in events)
    inside = [(n, max(s, t0), min(e, t1)) for n, s, e in events
              if e > t0 and s < t1]
    busy = _union([(s, e) for _, s, e in inside])
    by_op = defaultdict(float)
    vit_s = nbr_s = 0.0
    for n, s, e in inside:
        if MARKER in n:
            continue
        by_op[n[:120]] += (e - s) / 1e9
        if VIT_CU.match(n):
            vit_s += (e - s) / 1e9
        elif NEIGHBOUR_CU.match(n):
            nbr_s += (e - s) / 1e9
    idle = defaultdict(float)
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            k = sum(1 for m in marks[1:-1] if m <= a)
            idle[stages[k] if marks else "sequence"] += (b - a) / 1e9
    bound = None
    if peak is not None:
        t = (tower["image_size"] // tower["patch_size"]) ** 2 + 1
        bound = sum(tower["vision_layers"] * attention_half_bound_s(
            items * NUM_VIEWS, t, tower["vision_width"], peak)
            for items in traced["classifier_items"])
    return dict(
        busy_s=sum(e - s for s, e in busy) / 1e9, window_s=(t1 - t0) / 1e9,
        idle_by_stage=dict(idle), device_ops=dict(by_op), vit_cu_s=vit_s,
        neighbour_cu_s=nbr_s, attention_half_bound_s=bound,
        frames=traced["frames"], stage_marks=bool(marks))
