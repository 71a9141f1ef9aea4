"""The classifier's padded share of its batches in the spans pass (%):
100 x (items run - items needed) / items run, the counters of span
``classify.batch``."""


def read(ctx):
    s = ctx.get("spans")
    c = None if s is None else s["counters"].get("classify.batch")
    if not c or not c.get("items_run"):
        return None
    return 100.0 * (c["items_run"] - c["items_needed"]) / c["items_run"]
