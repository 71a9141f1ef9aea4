"""The card's idle time under span ``ground.scan`` (the ground scan's
per-frame loop) in the spans pass, a frame (ms)."""


def read(ctx):
    s = ctx.get("spans")
    if s is None or "mask_ground_points/ground.scan" not in s["idle_by_path"]:
        return None
    return 1e3 * s["idle_by_path"]["mask_ground_points/ground.scan"] \
        / s["frames"]
