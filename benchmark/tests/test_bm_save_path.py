"""The save path's per-layer readers: ``dense_output_host_ms`` from the
recorder's exclusive span times, ``save_passes_per_iteration`` from its
counters; each reads nothing where the program records no such span or
counter (a program that predates them)."""

from __future__ import annotations

import pytest

from harness import spec

READERS = ("dense_output_host_ms", "save_passes_per_iteration")


def _ctx(**counters):
    return dict(recorded=dict(exclusive_ms=dict(dense_output=25.5),
                              counters=dict(iterations=40, **counters)))


def test_readers_hand_on_the_save_path():
    ctx = _ctx(save_passes=520)
    read = {n: spec.load_module("metrics", n).read(ctx) for n in READERS}
    assert read["dense_output_host_ms"] == 25.5
    assert read["save_passes_per_iteration"] == 13.0


@pytest.mark.parametrize("ctx", [{}, dict(recorded={}), _ctx()])
def test_readers_read_nothing_without_the_program_numbers(ctx):
    for name in READERS[1:]:
        assert spec.load_module("metrics", name).read(ctx) is None, name
    if "recorded" not in ctx or not ctx["recorded"]:
        assert spec.load_module("metrics", READERS[0]).read(ctx) is None
