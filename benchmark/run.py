"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1> [--control]

from the root of a checkout.  The cell, its configuration, its traffic
mix, its check's limits and its per-layer readers are found by name
(``BENCHMARK.json``, ``benchmark/configs``, ``traffic``, ``limits``,
``metrics``).  The program under test is ``gab1_shp2_tpu_torch``; the
timed window drives its ``ensemble.engine.run_ensemble`` (the stiff
solver under the lane-refill scheduler), the entry every driver of the
port uses.

Set-up (timed as ``setup_s``): imports, the CUDA context, the system and
the traffic, one short ``run_ensemble`` at the cell's lanes and dtypes,
and with ``--trace 1`` one short profile.  Then requests run back to
back until the first one that completes after ``--seconds``; with
``--trace 1`` under the program's recorder of spans and counters
(``harness/recording.py``), which ``--trace 0`` never switches on.
After the window: the device's peak memory, the check against the plain
reference (``harness/check.py``), and the result as the last line of
standard output; each number compared, beside its limit, also ends
standard error.

``--control`` runs the program with the configuration's control switched
on (the next precision down, from ``limits/<cell>.json``), to read the
upper end of each limit; the benchmark's own runs never pass it.

The run fails (exit 2, no result) without a CUDA card, with fewer cards
than the cell asks for, or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "gab1_shp2_tpu")


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


# the host cores the run's process keeps to: the third and fourth it may
# use (core 0 takes the machine's interrupts), when it may use four or more
PIN_CORES = slice(2, 4)


def environment():
    """Every build and kernel cache inside the checkout, at fixed paths
    (neither cell builds a kernel today; a later one would find them),
    and one host thread for the program's CPU-side operations: the load
    comes from one process, whose dispatch thread shares no core with
    idle-spinning worker threads.  The process keeps to two fixed host
    cores, so that the eager step's dispatch does not move between cores
    (``harness/check.py`` frees the reference's workers of this)."""
    cache = BENCH / "_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["OMP_NUM_THREADS"] = "1"
    os.environ["MKL_NUM_THREADS"] = "1"
    if hasattr(os, "sched_setaffinity"):
        cores = sorted(os.sched_getaffinity(0))
        if len(cores) >= 4:
            os.sched_setaffinity(0, cores[PIN_CORES])


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX
    package's (compared whole: the port's name starts with the JAX
    package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true")
    return ap.parse_args(argv)


def main(argv=None, device=None, t_start=None):
    """One run; returns the result dict (also printed).  ``device``
    other than None skips the look for a card (tests on the CPU)."""
    args = parse(argv)
    environment()
    sys.path[:0] = [str(BENCH), str(ROOT)]
    import torch
    torch.set_num_threads(1)

    from harness import spec
    from harness.cell_run import run_cell

    cell = spec.load_cell(args.workload, BENCH)
    if device is None:
        if not torch.cuda.is_available():
            _log("no CUDA card: torch.cuda.is_available() is False")
            raise SystemExit(2)
        if torch.cuda.device_count() < cell.chips:
            _log(f"the cell needs {cell.chips} cards, "
                 f"{torch.cuda.device_count()} present")
            raise SystemExit(2)
        device = "cuda"
    result, checks_lines = run_cell(
        cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
        control=args.control, device=device,
        t_start=T_START if t_start is None else t_start)
    found = forbidden_modules()
    if found:
        _log(f"JAX or the JAX package was loaded: {found}")
        raise SystemExit(2)
    for line in checks_lines:
        _log(line)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
