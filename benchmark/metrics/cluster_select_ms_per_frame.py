"""Host wall of the cluster input's statistics and selection (spans
``cluster.stats`` and ``cluster.select``) in the spans pass, a frame
(ms)."""


def read(ctx):
    s = ctx.get("spans")
    names = ("cluster.stats", "cluster.select")
    if s is None or not any(n in s["wall_s"] for n in names):
        return None
    return 1e3 * sum(s["wall_s"].get(n, 0.0) for n in names) / s["frames"]
