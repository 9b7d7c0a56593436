"""Step layer (the save path): passes of ``_SolverCtx.dense_output``'s
write loop (``save_passes``) over the scheduler's loop iterations
(``iterations``), both counted by the program's recorder over the whole
window (``harness/recording.py``); nothing where the program counts no
save passes."""


def read(ctx):
    c = (ctx.get("recorded") or {}).get("counters") or {}
    if "save_passes" not in c or not c.get("iterations"):
        return None
    return c["save_passes"] / c["iterations"]
