"""The benchmark's own tests: its modules import from benchmark/ and the
program from the repository root, as benchmark/run.py arranges."""

import pathlib
import sys

BENCH = pathlib.Path(__file__).resolve().parent.parent
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)
