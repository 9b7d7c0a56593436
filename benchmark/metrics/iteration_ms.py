"""Step layer: milliseconds a loop iteration of the scheduler, over the
window's iterations outside the profiled sub-window (whose profiler
slows the host)."""


def read(ctx):
    n = ctx.get("iterations", 0) - ctx.get("prof_iterations", 0)
    if n <= 0:
        return None
    return 1e3 * (ctx["window_s"] - ctx.get("prof_host_s", 0.0)) / n
