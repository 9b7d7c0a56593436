"""Kernel layer: host milliseconds a loop iteration in the program's
``factor`` and ``solve`` spans (``cr_factor_lanes``, ``cr_solve_lanes``),
less the host reads they wait in, over the window's iterations outside
the profiled sub-window (the recorder, ``harness/recording.py``)."""


def read(ctx):
    return (ctx.get("recorded") or {}).get("linalg_host_ms")
