"""The reduction of a device trace, on a hand-made trace: busy time is
the union of the device intervals, launches count kernels only, and each
idle gap is charged to the innermost host operation running at its
middle."""

from __future__ import annotations

import types

from torch.autograd import DeviceType

from harness import profile

MS = 1_000_000   # ns


class Ev:
    def __init__(self, name, dev, start, dur):
        self._n, self._d, self._s, self._t = name, dev, start, dur

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


def test_reduce():
    cpu, gpu = DeviceType.CPU, DeviceType.CUDA
    ev = [
        Ev("aten::einsum", cpu, 0, 4 * MS),
        Ev("cudaLaunchKernel", cpu, 1 * MS, 1 * MS),
        Ev("gemm", gpu, 2 * MS, 2 * MS),
        Ev("add", gpu, 3 * MS, 2 * MS),          # overlaps gemm
        Ev("aten::item", cpu, 5 * MS, 4 * MS),
        Ev("Memcpy DtoH (Device -> Pageable)", gpu, 8 * MS, 1 * MS),
        Ev("gemm", gpu, 9 * MS, 1 * MS),
    ]
    r = profile.reduce(trace(ev))
    assert r["window_s"] == 10e-3
    assert r["busy_s"] == 5e-3                  # [2,5] + [8,10]
    assert r["kernels"] == 3                    # the copy is no launch
    assert r["device_ops"][0] == ["gemm", 3e-3]
    gaps = dict(r["idle_gaps"])
    # [0,2]: middle 1 ms, inside cudaLaunchKernel (inner) of einsum
    assert gaps["cudaLaunchKernel"] == 2e-3
    # [5,8]: middle 6.5 ms, inside aten::item
    assert gaps["aten::item"] == 3e-3


def test_no_device_events():
    ev = [Ev("aten::add", DeviceType.CPU, 0, MS)]
    assert profile.reduce(trace(ev)) == {}
