"""Progress reporting and lightweight profiling.

Counterpart of ``gab1_shp2_tpu/utils/progress.py``.  The reference
instruments with ``ProgressMeter`` bars and interactive ``@time`` macros
(``get_param_posteriors.jl:143``, ``run_base_model.jl:83``).  Here: a
chunk-loop progress printer for the host-side driver loops, a timer that
waits for every visible card before it reads the clock, and a trace
helper wrapping ``torch.profiler``.
"""

from __future__ import annotations

import contextlib
import os
import sys
import tempfile
import time
from typing import Iterable, Iterator, NamedTuple, Optional, TypeVar

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


class TraceRun(NamedTuple):
    """What :func:`trace` yields: the running profiler and the path of
    the Chrome trace it writes when the block ends."""

    profile: torch.profiler.profile
    path: str


@contextlib.contextmanager
def trace(dirname: Optional[str] = None):
    """Profile the block with ``torch.profiler`` (CPU activity, and CUDA
    activity where a card is present) and write a Chrome trace
    (``chrome://tracing``, Perfetto) into ``dirname`` when it ends.
    ``dirname`` defaults to ``torch-trace`` in the temporary directory
    (``/tmp/torch-trace`` unless ``TMPDIR`` says otherwise)."""
    if dirname is None:
        dirname = os.path.join(tempfile.gettempdir(), "torch-trace")
    os.makedirs(dirname, exist_ok=True)
    path = os.path.join(dirname, f"trace_{os.getpid()}_{time.time_ns()}.json")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield TraceRun(prof, path)
    prof.export_chrome_trace(path)
