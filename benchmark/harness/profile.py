"""The device trace of a steady sub-window, kept in memory.

``torch.profiler`` with CPU and CUDA activity (CUPTI) records every
host operation and every device operation of the sub-window; nothing is
exported.  ``reduce`` turns the raw events into what the per-layer
readers and the result line need: the sub-window's length, the seconds
in which some operation ran on the device (the union of the device
intervals), the kernel launches, the device operations that took most
time and the idle gaps by what the host was doing.
"""

from __future__ import annotations

import bisect
from collections import defaultdict


TOP = 10


def make_profiler():
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts, record_shapes=False, with_stack=False,
                   profile_memory=False)


def _events(prof):
    """(kind, name, start ns, end ns) of every event; kind is "kernel",
    "device" (a copy or a fill on the card) or "host"."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        end = start + (e.duration_ns() if hasattr(e, "duration_ns")
                       else int(e.duration_us() * 1000))
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            kind = "device" if name.startswith(("Memcpy", "Memset")) \
                else "kernel"
        else:
            kind = "host"
        out.append((kind, name, start, end))
    return out


def _union(intervals):
    """Merge (start, end) intervals; returns the merged list."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def _host_doing(host, mid):
    """The innermost host operation running at ``mid`` (the latest to
    start among those that cover it), or None."""
    starts = host[0]
    i = bisect.bisect_right(starts, mid) - 1
    # nested operations start after their parents: walk back a little
    for j in range(i, max(i - 64, -1), -1):
        if host[1][j] >= mid:
            return host[2][j]
    return None


def reduce(prof) -> dict:
    """The sub-window's numbers, or an empty dict when the trace holds
    no device operation (CUPTI gave nothing)."""
    ev = _events(prof)
    dev = [(n, s, e) for k, n, s, e in ev if k != "host"]
    if not dev:
        return {}
    lo = min(s for _, _, s, _ in ev)
    hi = max(e for _, _, _, e in ev)
    busy = _union([(s, e) for _, s, e in dev])
    busy_ns = sum(e - s for s, e in busy)
    by_op = defaultdict(int)
    for n, s, e in dev:
        by_op[n] += e - s
    host_ev = sorted((s, e, n) for k, n, s, e in ev if k == "host")
    host = ([h[0] for h in host_ev], [h[1] for h in host_ev],
            [h[2] for h in host_ev])
    gaps = defaultdict(int)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    for s, e in zip(edges[0::2], edges[1::2]):
        if e > s:
            doing = _host_doing(host, (s + e) // 2)
            gaps[doing or "host between operations"] += e - s

    def top(d):
        return [[k, v / 1e9] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return dict(window_s=(hi - lo) / 1e9, busy_s=busy_ns / 1e9,
                kernels=sum(1 for k, *_ in ev if k == "kernel"),
                device_ops=top(by_op), idle_gaps=top(gaps))
