"""Step layer (``_SolverCtx.step``, RODAS4 and its controller): the share
of the scheduler's loop iterations (``iterations``) whose step replayed
its body from a CUDA graph (``graph_replays``), both counted by the
program's recorder over the whole window (``harness/recording.py``);
nothing where the program counts no graph replays."""


def read(ctx):
    c = (ctx.get("recorded") or {}).get("counters") or {}
    if "graph_replays" not in c or not c.get("iterations"):
        return None
    return 100.0 * c["graph_replays"] / c["iterations"]
