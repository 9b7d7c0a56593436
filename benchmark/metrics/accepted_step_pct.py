"""Step layer (RODAS4's controller): the share of the step attempts that
were accepted, the harvested members' accepted steps
(``accepted_steps``) over all active lane-steps (``active_lane_steps``),
both counted by the recorder over the whole window
(``harness/recording.py``)."""


def read(ctx):
    return (ctx.get("recorded") or {}).get("accepted_step_pct")
