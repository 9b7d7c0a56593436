"""Scheduler layer (``ops/batch_stiff.py``'s lane refill under
``ensemble/engine.py``): the share of lane slots that stepped a member,
active lane-steps over loop iterations times lanes, over the window."""


def read(ctx):
    if not ctx.get("lane_slots"):
        return None
    return 100.0 * ctx["active"] / ctx["lane_slots"]
