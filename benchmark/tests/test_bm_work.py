"""The least-work count against a hand count at a small grid."""

from __future__ import annotations

import pytest

from harness import spec

work = spec.load_module("work", "rodas4")


def test_hand_count_two_interior_nodes():
    M, n = 2, 10
    rhs = 110 * M + 118                       # 338
    unknowns = n * M + 8                      # 28
    stage = (4 * (0 + 1 + 2 + 3 + 4 + 5) + 9) * unknowns   # 69 * 28
    bands = 83 * M + 448                      # 614
    w = 110 * M + 448                         # 668
    factor = (2000 + 300) * M + 1600 + 1280 + 1024 + 1600   # 10104
    solve = 420 * M + 304                     # 1144
    got = work.member_step(M, "float64", "float32")
    assert got["ops"] == {"float64": 6 * rhs + stage}
    assert got["la_ops"] == {"float32": bands + w + factor + 6 * solve}
    assert got["bytes"] == 8 * ((unknowns + 26) + (unknowns + 3))


def test_least_time_is_the_larger_bound():
    peaks = {"flops": {"float64": 34e12, "float32": 67e12},
             "bytes_per_s": 3.35e12}
    cfg = {"R": 10.0, "dr": 0.2, "state_dtype": "float64",
           "linsolve_dtype": "float32"}
    w = work.member_step(49, "float64", "float32")
    t_ops = w["ops"]["float64"] / 34e12 + w["la_ops"]["float32"] / 67e12
    assert work.least_time_s(cfg, peaks) == pytest.approx(
        max(t_ops, w["bytes"] / 3.35e12))
    # compute bound at the cells' sizes: a few nanoseconds a member-step
    assert 2e-9 < work.least_time_s(cfg, peaks) < 2e-8
    cfg32 = dict(cfg, state_dtype="float32")
    assert work.least_time_s(cfg32, peaks) < work.least_time_s(cfg, peaks)
