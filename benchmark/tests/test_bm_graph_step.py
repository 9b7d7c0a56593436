"""``graph_step_pct``'s reader: the share of loop iterations whose step
replayed a CUDA graph, from the recorder's counters; nothing where the
program counts no graph replays (a program that predates them)."""

from __future__ import annotations

import pytest

from harness import spec


def _read(ctx):
    return spec.load_module("metrics", "graph_step_pct").read(ctx)


def _ctx(**counters):
    return dict(recorded=dict(counters=dict(iterations=40, **counters)))


@pytest.mark.parametrize("replays,pct", [(40, 100.0), (30, 75.0), (0, 0.0)])
def test_reads_replays_over_iterations(replays, pct):
    assert _read(_ctx(graph_replays=replays, graph_captures=1)) == pct


@pytest.mark.parametrize("ctx", [{}, dict(recorded={}), _ctx(),
                                 dict(recorded=dict(counters=dict(
                                     graph_replays=3)))])
def test_reads_nothing_without_the_program_counter(ctx):
    assert _read(ctx) is None
