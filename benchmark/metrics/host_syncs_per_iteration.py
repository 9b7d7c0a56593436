"""Scheduler layer: the program's host reads of device values
(``host_syncs``) over its loop iterations (``iterations``), both counted
by the recorder over the whole window (``harness/recording.py``)."""


def read(ctx):
    return (ctx.get("recorded") or {}).get("host_syncs_per_iteration")
