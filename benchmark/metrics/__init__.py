"""One reader per per-layer metric, ``<name>.py`` with ``read(ctx)``:
the metric's value from the run's context, or None where the run has
nothing for it to read (the metric is then left out of the line).

``ctx``: ``frames`` and ``window_s`` of the untraced window,
``stage_s`` (the runner's ``stage_times`` summed over the window's
sequences), ``images_needed`` (four views of every detection valid at
the classifier's start), ``tower`` (the configuration's ``clip`` group),
``peak`` (the card's peaks or None) and ``trace`` (``trace.summarize``
of the traced pass, or None)."""
from __future__ import annotations

import importlib


def read(name: str, ctx: dict):
    return importlib.import_module(f"{__name__}.{name}").read(ctx)


def per_frame_ms(ctx: dict, *stages: str):
    """The stages' summed wall time over the window, a frame, in ms."""
    if not all(s in ctx["stage_s"] for s in stages):
        return None
    return 1e3 * sum(ctx["stage_s"][s] for s in stages) / ctx["frames"]
