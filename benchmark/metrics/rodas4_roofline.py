"""Kernel layer (the CUDA kernels a RODAS4 step launches): the least
time of the profiled sub-window's active member-steps (``work/rodas4.py``
against the device's peaks, ``work/peaks.json``) over the device's busy
time in that sub-window."""

import json
import pathlib

PEAKS = pathlib.Path(__file__).resolve().parent.parent / "work" / "peaks.json"


def read(ctx):
    prof = ctx.get("profile") or {}
    if not prof.get("busy_s") or not ctx.get("prof_active"):
        return None
    peaks = json.loads(PEAKS.read_text())["devices"].get(ctx["device_kind"])
    if peaks is None:
        return None
    from harness import spec
    work = spec.load_module("work", ctx["config"]["method"])
    least = work.least_time_s(ctx["config"], peaks)
    return 100.0 * ctx["prof_active"] * least / prof["busy_s"]
