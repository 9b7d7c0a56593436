"""Kernel layer: host milliseconds a loop iteration in the program's
``bands`` spans (the Jacobian's block bands, ``lane_bands``), over the
window's iterations outside the profiled sub-window (the recorder,
``harness/recording.py``)."""


def read(ctx):
    return (ctx.get("recorded") or {}).get("bands_host_ms")
