"""Step layer (``_SolverCtx.step``, RODAS4 and its controller): step
attempts per member, accepted and rejected, active lane-steps over the
members the window's requests submitted (an exact count)."""


def read(ctx):
    if not ctx.get("members") or not ctx.get("iterations"):
        return None
    return ctx["active"] / ctx["members"]
