"""On the card: each cell's control (the configuration's next precision
down, ``limits/<cell>.json``) run through the whole harness at the
cell's own size, one request, comes out not correct.  Skips without a
card.

    python -m pytest -m gpu benchmark/tests/test_bm_gpu.py -q
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from harness import spec

CELLS = [w["name"] for w in json.loads(
    (spec.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(card, cell):
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        cell, "--seed", "424242", "--seconds", "1",
                        "--trace", "0", "--control"], capture_output=True,
                       text=True, cwd=spec.ROOT, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] is False, res["checks"]
