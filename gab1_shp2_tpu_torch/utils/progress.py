"""Progress reporting and lightweight profiling.

Counterpart of ``gab1_shp2_tpu/utils/progress.py``.  The reference
instruments with ``ProgressMeter`` bars and interactive ``@time`` macros
(``get_param_posteriors.jl:143``, ``run_base_model.jl:83``).  Here: a
chunk-loop progress printer for the host-side driver loops, a timer that
waits for every visible card before it reads the clock, the port's one
recorder of spans and counters, and a trace helper wrapping
``torch.profiler`` that switches the recorder on.

The recorder is off unless a block asks for it (``with record() as
rec``); the solver's instrumented sites test :data:`RECORDER` (or a
copy of it taken when a solve starts) and otherwise do nothing.  Host
reads of device tensors go through :func:`host_read`.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import sys
import tempfile
import threading
import time
from collections import defaultdict
from time import perf_counter_ns, time_ns
from typing import (Callable, Dict, Iterable, Iterator, List, NamedTuple,
                    Optional, TypeVar)

import torch

T = TypeVar("T")


def progress(it: Iterable[T], total: Optional[int] = None,
             desc: str = "", every: float = 2.0) -> Iterator[T]:
    """Wrap an iterable with a rate/ETA line on stderr."""
    if total is None:
        try:
            total = len(it)  # type: ignore[arg-type]
        except TypeError:
            total = None
    t0 = time.time()
    last = 0.0
    for i, item in enumerate(it):
        yield item
        now = time.time()
        if now - last >= every or (total and i + 1 == total):
            rate = (i + 1) / max(now - t0, 1e-9)
            eta = ((total - i - 1) / rate) if (total and rate > 0) else None
            msg = f"\r{desc} {i + 1}"
            if total:
                msg += f"/{total}"
            msg += f" ({rate:.2f}/s"
            if eta is not None:
                msg += f", eta {eta:.0f}s"
            msg += ")"
            print(msg, end="", file=sys.stderr, flush=True)
            last = now
    print(file=sys.stderr)


def _synchronize_all() -> None:
    """Wait for the queued work of every visible card; on a host without
    a card there is nothing to wait for."""
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


@contextlib.contextmanager
def timer(label: str):
    """``with timer("solve"): ...`` prints the block's wall time on
    stderr.  The cards are synchronized before each reading of the
    clock, so the time is that of the block's device work, not of its
    enqueueing."""
    _synchronize_all()
    t0 = time.perf_counter()
    yield
    _synchronize_all()
    print(f"[{label}] {time.perf_counter() - t0:.3f}s", file=sys.stderr)


# ---------------------------------------------------------------------------
# the recorder of spans and counters
# ---------------------------------------------------------------------------

# the span of one run_ensemble call: its id is the request id of every
# span under it; an ``iteration`` span (one pass of the refill loop) is
# numbered from when the recorder was switched on, and the spans under it
# carry that number
REQUEST = "request"
ITERATION = "iteration"

# what an instrumented block enters when its solve is not recorded
NULL = contextlib.nullcontext()


class Span(NamedTuple):
    """One finished span.  Times are nanoseconds on ``torch.profiler``'s
    clock (Unix time, advanced by the steady clock), so a span lines up
    with the host and device events of a profile taken meanwhile."""

    id: int
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]       # the id of the span that caused it
    request: Optional[int]      # the id of its ``request`` span
    iteration: Optional[int]    # the refill-loop pass it lies in


class _Open(NamedTuple):
    """A span in progress, as its children see it."""

    id: int
    request: Optional[int]
    iteration: Optional[int]


class _ThreadLog(NamedTuple):
    spans: List[Span]
    counters: Dict[str, int]
    stack: List[_Open]


class Recording(NamedTuple):
    """What a recorder holds: its spans, by start, and its counters
    summed over threads."""

    spans: List[Span]
    counters: Dict[str, int]

    def self_ns(self, name: str, less=("sync",),
                skip: Callable[[Optional[int]], bool] = lambda i: False
                ) -> int:
        """Nanoseconds in the spans ``name``, less the time of their
        descendants named in ``less``, over the spans whose iteration
        ``skip`` does not reject."""
        children = defaultdict(list)
        for s in self.spans:
            children[s.parent].append(s)

        def hidden(s):
            out = 0
            for c in children[s.id]:
                out += (c.end_ns - c.start_ns if c.name in less
                        else hidden(c))
            return out

        return sum(s.end_ns - s.start_ns - hidden(s) for s in self.spans
                   if s.name == name and not skip(s.iteration))


# Unix-time readings the recorder's clock offset is chosen from
CLOCK_READINGS = 32


def clock_offset_ns() -> int:
    """Unix time less the steady clock, in nanoseconds: of
    ``CLOCK_READINGS`` Unix-time readings, each bracketed by two
    steady-clock readings, the one with the tightest bracket, against its
    bracket's midpoint.  A reading that the host preempted has a wide
    bracket and is passed over."""
    best = None
    for _ in range(CLOCK_READINGS):
        before = perf_counter_ns()
        wall = time_ns()
        after = perf_counter_ns()
        if best is None or after - before < best[0]:
            best = (after - before, wall - (before + after) // 2)
    return best[1]


class Recorder:
    """Spans and counters of the solves run while it is switched on
    (:func:`record`).  Each thread keeps its own lists (the mesh's worker
    threads record beside the caller's); :meth:`read` merges them.  A
    span is also entered as ``torch.profiler.record_function(name)``, so
    under a running profiler it stands beside the operations it
    launched, also where the profiler starts or stops inside it."""

    def __init__(self):
        self._lock = threading.Lock()
        self._local = threading.local()
        self._logs: List[_ThreadLog] = []
        self._ids = itertools.count()
        self._iterations = itertools.count()
        # the profiler's clock from the steady one, fixed once
        self._offset_ns = clock_offset_ns()
        # a process's first record_function returns a millisecond after
        # it reads the clock: pay that here, not in the first span
        with torch.profiler.record_function("recorder"):
            pass

    def _log(self) -> _ThreadLog:
        log = getattr(self._local, "log", None)
        if log is None:
            log = self._local.log = _ThreadLog([], defaultdict(int), [])
            with self._lock:
                self._logs.append(log)
        return log

    def current(self) -> Optional[_Open]:
        """The innermost span open on this thread, or None: the parent
        to hand a span that another thread opens on its behalf."""
        stack = self._log().stack
        return stack[-1] if stack else None

    @contextlib.contextmanager
    def span(self, name: str, parent: Optional[_Open] = None):
        """Record the block as a span ``name``; its parent is ``parent``
        or else the innermost span open on this thread."""
        log = self._log()
        up = parent if parent is not None else (
            log.stack[-1] if log.stack else None)
        sid = next(self._ids)
        request = sid if name == REQUEST else (
            None if up is None else up.request)
        iteration = next(self._iterations) if name == ITERATION else (
            None if up is None else up.iteration)
        before = time.perf_counter_ns()
        with torch.profiler.record_function(name):
            # the profiler reads its clock inside the entry: the midpoint
            # of the readings around it stands nearest to its reading
            start = (before + time.perf_counter_ns()) // 2
            log.stack.append(_Open(sid, request, iteration))
            try:
                yield
            finally:
                log.stack.pop()
                end = time.perf_counter_ns()
                off = self._offset_ns
                log.spans.append(Span(sid, name, start + off, end + off,
                                      None if up is None else up.id,
                                      request, iteration))

    def wrap(self, name: str, fn: Callable) -> Callable:
        """``fn`` with every call recorded as a span ``name``."""

        def spanned(*args, **kwargs):
            with self.span(name):
                return fn(*args, **kwargs)

        return spanned

    def count(self, **amounts: int) -> None:
        counters = self._log().counters
        for k, v in amounts.items():
            counters[k] += v

    def read(self) -> Recording:
        with self._lock:
            logs = list(self._logs)
        spans = sorted((s for log in logs for s in log.spans),
                       key=lambda s: (s.start_ns, s.id))
        counters = defaultdict(int)
        for log in logs:
            for k, v in list(log.counters.items()):
                counters[k] += v
        return Recording(spans, dict(counters))


# the recorder switched on, or None (the default): the one test every
# instrumented site makes
RECORDER: Optional[Recorder] = None


@contextlib.contextmanager
def record():
    """Switch a new :class:`Recorder` on for the block (the one switched
    on before, if any, is switched back on after it); yields it, and
    ``rec.read()`` returns what it holds, also after the block."""
    global RECORDER
    before, rec = RECORDER, Recorder()
    RECORDER = rec
    try:
        yield rec
    finally:
        RECORDER = before


def host_read(x: torch.Tensor, kind: Callable = bool):
    """``kind(x)`` of a device tensor: the host waits for the queued
    work.  With the recorder on the read is counted (``host_syncs``)
    and recorded as a ``sync`` span."""
    rec = RECORDER
    if rec is None:
        return kind(x)
    rec.count(host_syncs=1)
    with rec.span("sync"):
        return kind(x)


class TraceRun(NamedTuple):
    """What :func:`trace` yields: the running profiler, the path of the
    Chrome trace it writes when the block ends, and the recorder
    switched on for the block (``run.recorder.read()``)."""

    profile: torch.profiler.profile
    path: str
    recorder: Recorder


@contextlib.contextmanager
def trace(dirname: Optional[str] = None):
    """Profile the block with ``torch.profiler`` (CPU activity, and CUDA
    activity where a card is present), with the recorder switched on,
    and write a Chrome trace (``chrome://tracing``, Perfetto) into
    ``dirname`` when it ends; the recorder's spans stand in it as host
    events of their names.  ``dirname`` defaults to ``torch-trace`` in
    the temporary directory (``/tmp/torch-trace`` unless ``TMPDIR`` says
    otherwise)."""
    if dirname is None:
        dirname = os.path.join(tempfile.gettempdir(), "torch-trace")
    os.makedirs(dirname, exist_ok=True)
    path = os.path.join(dirname, f"trace_{os.getpid()}_{time.time_ns()}.json")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        with record() as rec:
            yield TraceRun(prof, path, rec)
    prof.export_chrome_trace(path)
