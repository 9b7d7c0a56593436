"""Nothing the benchmark runs loads JAX or the JAX package: a fresh
process imports the harness, every reader, work count and reference,
and the program, and then holds no module whose top-level name is
jax, jaxlib, flax or gab1_shp2_tpu (compared whole: the port's name
begins with the JAX package's)."""

from __future__ import annotations

import json
import os
import subprocess
import sys

from harness import spec

CODE = r"""
import json, pathlib, sys
bench = pathlib.Path(sys.argv[1])
sys.path[:0] = [str(bench), str(bench.parent)]
import run
import harness.cell_run, harness.check, harness.profile, harness.recording
import harness.spec
import harness.traffic, harness.window
import gab1_shp2_tpu_torch
import gab1_shp2_tpu_torch.ensemble.engine, gab1_shp2_tpu_torch.ops.batch_stiff
for kind in ("metrics", "work", "reference"):
    for f in sorted((bench / kind).glob("*.py")):
        harness.spec.load_module(kind, f.stem)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_no_jax_loaded():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", CODE, str(spec.BENCH_DIR)],
                       capture_output=True, text=True, timeout=300, env=env,
                       cwd=spec.BENCH_DIR.parent)
    assert p.returncode == 0, p.stderr[-3000:]
    tops = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert "gab1_shp2_tpu_torch" in tops and "torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "gab1_shp2_tpu"}, tops
