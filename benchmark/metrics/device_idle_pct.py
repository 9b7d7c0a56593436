"""Device layer (the H100): the share of the profiled sub-window in
which no operation ran on the card (``torch.profiler``, CUDA activity)."""


def read(ctx):
    prof = ctx.get("profile") or {}
    if not prof.get("window_s"):
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
