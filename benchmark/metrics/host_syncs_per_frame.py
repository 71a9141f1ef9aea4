"""Host syncs of the spans pass, a frame: the synchronizing calls the
recorder counted (``torch.cuda`` sync-debug warnings; an explicit
``torch.cuda.synchronize`` is not one)."""


def read(ctx):
    s = ctx.get("spans")
    if s is None:
        return None
    return s["syncs"] / s["frames"]
