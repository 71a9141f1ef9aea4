"""The share of the traced sequence's wall in which the card ran no
kernel, copy or set (%), between the markers at its first stage's start
and its end, or, where the trace lost a marker, between its first and its
last event."""


def read(ctx):
    t = ctx["trace"]
    if t is None or not t["window_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
