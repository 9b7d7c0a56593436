"""The device trace of a steady sub-window, kept in memory.

``torch.profiler`` with CPU and CUDA activity (CUPTI) records every
host operation and every device operation of the sub-window; nothing is
exported.  ``reduce`` turns the raw events into what the per-layer
readers and the result line need: the sub-window's length, the seconds
in which some operation ran on the device (the union of the device
intervals), the kernel launches, the device operations that took most
time and the idle gaps by what the host was doing.

A ``record_function`` range, as each span of the program's recorder is
when the traced run switches it on, stands in the trace on the host and
on the card's timeline; it marks time and runs nothing, so it is left
out of all of these: the numbers read the same with the recorder on as
with it off.
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
    """(kind, name, start ns, end ns) of every event but the
    ``record_function`` ranges; kind is "kernel", "device" (a copy or a
    fill on the card) or "host"."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            continue
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


def _parents(starts, ends):
    """Each host operation's parent, the innermost one open when it
    started (-1 for none), over operations sorted by start, the longer
    first among those that start together."""
    parent, open_ = [], []
    for s, e in zip(starts, ends):
        while open_ and ends[open_[-1]] < s:
            open_.pop()
        parent.append(open_[-1] if open_ else -1)
        open_.append(len(parent) - 1)
    return parent


def _host_doing(host, mid):
    """The innermost host operation running at ``mid`` (the latest to
    start among those that cover it), or None."""
    starts, ends, names, parent = host
    i = bisect.bisect_right(starts, mid) - 1
    # an operation that covers ``mid`` holds the latest to start before
    # it: walk up from that one
    while i >= 0 and ends[i] < mid:
        i = parent[i]
    return names[i] if i >= 0 else None


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
    host_ev = sorted((s, -e, n) for k, n, s, e in ev if k == "host")
    starts = [h[0] for h in host_ev]
    ends = [-h[1] for h in host_ev]
    host = (starts, ends, [h[2] for h in host_ev],
            _parents(starts, ends))
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
