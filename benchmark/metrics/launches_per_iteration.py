"""Device layer: CUDA kernel launches in the profiled sub-window over its
loop iterations."""


def read(ctx):
    prof = ctx.get("profile") or {}
    if not prof or not ctx.get("prof_iterations"):
        return None
    return prof["kernels"] / ctx["prof_iterations"]
