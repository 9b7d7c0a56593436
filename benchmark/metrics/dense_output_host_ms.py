"""Step layer (the save path, ``_SolverCtx.dense_output``): host
milliseconds a loop iteration in the program's ``dense_output`` spans,
less their ``rhs`` and ``sync`` children, over the window's iterations
outside the profiled sub-window (the recorder,
``harness/recording.py``)."""


def read(ctx):
    return ((ctx.get("recorded") or {}).get("exclusive_ms")
            or {}).get("dense_output")
