"""The reduction of a device trace, on a hand-made trace: busy time is
the union of the device intervals, launches count kernels only, and each
idle gap is charged to the innermost host operation running at its
middle, however many operations started inside that one; the
``record_function`` ranges of the program's recorder, on the host and on
the card's timeline, change none of the numbers."""

from __future__ import annotations

import types

from torch.autograd import DeviceType

from harness import profile

MS = 1_000_000   # ns


class Ev:
    def __init__(self, name, dev, start, dur, annotation=False):
        self._n, self._d, self._s, self._t = name, dev, start, dur
        self._a = annotation

    def is_user_annotation(self):
        return self._a

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._t


def trace(events):
    res = types.SimpleNamespace(events=lambda: events)
    return types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=res))


cpu, gpu = DeviceType.CPU, DeviceType.CUDA


def _plain():
    return [
        Ev("aten::einsum", cpu, 0, 4 * MS),
        Ev("cudaLaunchKernel", cpu, 1 * MS, 1 * MS),
        Ev("gemm", gpu, 2 * MS, 2 * MS),
        Ev("add", gpu, 3 * MS, 2 * MS),          # overlaps gemm
        Ev("aten::item", cpu, 5 * MS, 4 * MS),
        Ev("Memcpy DtoH (Device -> Pageable)", gpu, 8 * MS, 1 * MS),
        Ev("gemm", gpu, 9 * MS, 1 * MS),
    ]


def _spans():
    """The recorder's ranges around the same work: an iteration over the
    whole of it, a step and its rhs, each on the host and, as the
    profiler shows a range, on the card's timeline too."""
    out = []
    for name, start, dur in (("iteration", 0, 10 * MS),
                             ("step", 0, 9 * MS), ("rhs", 1 * MS, 3 * MS)):
        out += [Ev(name, cpu, start, dur, annotation=True),
                Ev(name, gpu, start, dur, annotation=True)]
    return out


def test_reduce():
    r = profile.reduce(trace(_plain()))
    assert r["window_s"] == 10e-3
    assert r["busy_s"] == 5e-3                  # [2,5] + [8,10]
    assert r["kernels"] == 3                    # the copy is no launch
    assert r["device_ops"][0] == ["gemm", 3e-3]
    gaps = dict(r["idle_gaps"])
    # [0,2]: middle 1 ms, inside cudaLaunchKernel (inner) of einsum
    assert gaps["cudaLaunchKernel"] == 2e-3
    # [5,8]: middle 6.5 ms, inside aten::item
    assert gaps["aten::item"] == 3e-3


def test_recorder_ranges_change_nothing():
    plain = profile.reduce(trace(_plain()))
    spanned = profile.reduce(trace(_spans() + _plain()))
    assert spanned == plain
    assert spanned["kernels"] == 3
    assert all(not name.startswith(("iteration", "step", "rhs"))
               for name, _ in spanned["device_ops"] + spanned["idle_gaps"])


def test_gap_inside_a_long_host_operation():
    """An idle gap at the end of a host read that ran a thousand short
    host operations first is the read's."""
    ev = [Ev("aten::item", cpu, 0, 2000 * MS),
          Ev("gemm", gpu, 0, 1000 * MS)]
    ev += [Ev("aten::add", cpu, i * MS, MS // 2) for i in range(1000)]
    gaps = dict(profile.reduce(trace(ev))["idle_gaps"])
    assert gaps == {"aten::item": 1.0}


def test_no_device_events():
    ev = [Ev("aten::add", DeviceType.CPU, 0, MS)]
    assert profile.reduce(trace(ev)) == {}
