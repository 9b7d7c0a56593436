"""Step layer (``_SolverCtx.step``, RODAS4 and its controller): host
milliseconds a loop iteration in the program's ``step`` spans, less the
host reads they wait in (``sync``), over the window's iterations outside
the profiled sub-window (the recorder, ``harness/recording.py``)."""


def read(ctx):
    return (ctx.get("recorded") or {}).get("step_host_ms")
