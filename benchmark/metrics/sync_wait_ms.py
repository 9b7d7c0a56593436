"""Scheduler layer: host milliseconds a loop iteration in the program's
``sync`` spans, the host reads of device values (``host_read``), each
waiting for the queued work, over the window's iterations outside the
profiled sub-window (the recorder, ``harness/recording.py``)."""


def read(ctx):
    return (ctx.get("recorded") or {}).get("sync_wait_ms")
