"""Kernel layer: host milliseconds a loop iteration in the program's
``rhs`` spans (every right-hand side the step evaluates, ``lane_rhs``),
over the window's iterations outside the profiled sub-window (the
recorder, ``harness/recording.py``)."""


def read(ctx):
    return (ctx.get("recorded") or {}).get("rhs_host_ms")
