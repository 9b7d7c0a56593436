"""The port's bench entry point (gab1_shp2_tpu_torch.bench) against the JAX
package's bench.py, at a small size on the CPU.

The ensemble is held bit-equal to bench.py's draw, recomputed here from
``bench.py:88-92``.  Each row's port function is held against the JAX
calls bench.py makes for that row (``bench.py:97-117``, ``:143-170``), at
dr=1, tf=0.5 over 4 members on 2 lanes:

* f32 rows (the refill headline, the contiguous-chunk row): max
  |port - jax| / (|jax| + 1e-6) below 2e-3, the f32 parity bound for a
  different op order (``tests/test_utils_and_pallas.py:164-168``; 1.2e-6
  seen here); step counts within 3 (f32 reassociation moves accept/reject
  decisions; equal here);
* f64-state rows with f32 linear algebra (the north star, the GSA
  recipe): the same measure below 1e-6 (4.2e-8 for the GSA recipe and
  9.6e-9 for the north star seen here: the two packages' f32 stage solves
  round differently, and the f64 state carries that rounding); step
  counts within 3 (the north star's differ by 1 here).

The roofline model is bench.py's own formula at NB=51, B=256, the line
has bench.py's keys plus ``power_limit`` (read from bench.py's source),
and the mesh row runs over two slots of the CPU.
"""

import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gab1_shp2_tpu as jg
from gab1_shp2_tpu.models.params import Params as JParams
from gab1_shp2_tpu.ops.batch_stiff import (
    solve_stiff_batch as j_batch,
    solve_stiff_refill as j_refill,
)

from gab1_shp2_tpu_torch import bench

torch.set_num_threads(2)

N, LANES = 4, 2
KW = dict(dr=1.0, tf=0.5)
F32_REL, F64_REL, STEPS = 2e-3, 1e-6, 3
BENCH_PY = pathlib.Path(__file__).resolve().parents[1] / "bench.py"


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / (np.abs(b) + 1e-6)))


def _bench_py_batch(n):
    """bench.py:88-92, with the JAX package's default parameters."""
    rng = np.random.default_rng(0)
    p0 = np.asarray(jg.default_params().pack())
    batch = p0[None, :] * np.exp(rng.normal(0.0, 0.10, size=(n, 24)))
    batch[:, 21] = p0[21]
    return batch


def _j_final_C(sol):
    return sol.C[-1]


def _j_rows(batch):
    """bench.py's runners (``bench.py:97-117``) at the small size: each
    row's final C, failed count and loop steps."""
    system = jg.base_system()
    Co64 = jg.default_co()
    Co32 = Co64.astype(jnp.float32)

    def refill(Co, **kw):
        out, ok, steps = j_refill(
            system, Co, JParams.unpack(jnp.asarray(batch, Co.dtype)),
            extract=_j_final_C, Nts=2, lanes=LANES, method="rodas4",
            **KW, **kw)
        return (np.asarray(out), int((~np.asarray(ok)).sum()),
                int(np.asarray(steps).max()))

    outs, failed, steps = [], 0, 0
    for s in range(0, N, LANES):
        pb = JParams.unpack(jnp.asarray(batch[s:s + LANES], jnp.float32))
        sol, st = j_batch(system, Co32, pb, Nts=2, return_stats=True,
                          method="rodas4", rtol=1e-4, atol=1e-7, **KW)
        outs.append(np.asarray(sol.C[:, -1]))
        failed += int(np.asarray(st.failed).sum())
        steps += int(np.asarray(st.n_accepted + st.n_rejected).max())
    return {
        "headline": refill(Co32, rtol=1e-4, atol=1e-7),
        "chunked": (np.concatenate(outs), failed, steps),
        "north_star": refill(Co64, rtol=1e-6, atol=1e-9,
                             linsolve_dtype=jnp.float32),
        "gsa_config": refill(Co64, rtol=1e-4, atol=1e-7,
                             linsolve_dtype=jnp.float32),
    }


@pytest.fixture(scope="module")
def rows():
    """The port's rows (one warm-up and one timed run each) and the JAX
    package's, on the same members."""
    batch = bench.bench_ensemble(N)
    return (bench.measure_rows(batch, device="cpu", lanes=LANES, runs=1,
                               **KW),
            _j_rows(batch))


def _key_tree(node):
    """The nested keys of a dict literal in bench.py's source."""
    return {k.value: (_key_tree(v) if isinstance(v, ast.Dict) else None)
            for k, v in zip(node.keys, node.values)}


def _bench_py_lines():
    """bench.py's two JSON lines' key trees: main()'s and run_mesh()'s."""
    tree = ast.parse(BENCH_PY.read_text())
    found = {}
    for fn in tree.body:
        if isinstance(fn, ast.FunctionDef) and fn.name in ("main",
                                                           "run_mesh"):
            for node in ast.walk(fn):
                if (isinstance(node, ast.Dict) and node.keys
                        and isinstance(node.keys[0], ast.Constant)
                        and node.keys[0].value == "metric"
                        and any(isinstance(k, ast.Constant)
                                and k.value == "details"
                                for k in node.keys)):
                    found[fn.name] = _key_tree(node)
    return found["main"], found["run_mesh"]


def _keys_of(d):
    return {k: (_keys_of(v) if isinstance(v, dict) else None)
            for k, v in d.items()}


def test_ensemble_bit_equal_to_bench_py():
    np.testing.assert_array_equal(bench.bench_ensemble(), _bench_py_batch(
        1024))
    assert bench.bench_ensemble().shape == (1024, 24)


@pytest.mark.parametrize("row,rel", [("headline", F32_REL),
                                     ("chunked", F32_REL),
                                     ("north_star", F64_REL),
                                     ("gsa_config", F64_REL)])
def test_row_matches_jax(rows, row, rel):
    port, jax_rows = rows
    (run,) = port[row]
    j_out, j_failed, j_steps = jax_rows[row]
    assert run.failed == j_failed == 0
    assert run.out.dtype == bench.ROWS[row][1]
    assert _rel(run.out.numpy(), j_out) < rel
    assert abs(run.steps - j_steps) <= STEPS, (run.steps, j_steps)


def test_roofline_model_is_bench_pys():
    assert bench.roofline_model(dr=0.2, lanes=256) == (276_951_040,
                                                       288_972_800)
    assert bench.HBM_PEAK_GBPS == 3350.0
    block = bench.roofline(1000, 2.0)
    assert block["steps_per_sec"] == 500.0
    assert block["achieved_GBps_model"] == round(276_951_040 * 500 / 1e9, 1)
    assert block["config"] == ("headline f32 rodas4 chunk (B=256, NB=51, "
                               "n=10)")


def test_line_has_bench_pys_keys(rows):
    port, _ = rows
    # the north star's member 0 stands in for the tight reference here
    # (solve_stiff at rtol 1e-8 takes ~2,000 steps even at this size)
    Cref = port["north_star"][0].out[0]
    line = bench.bench_line(port, Cref, device="cpu", lanes=LANES, **KW)
    want, _ = _bench_py_lines()
    want["details"]["power_limit"] = None
    assert _keys_of(line) == want
    d = line["details"]
    assert d["N"] == N and d["failed"] == 0
    assert d["backend"] == "cpu" and d["power_limit"] is None
    assert d["roofline"]["hbm_peak_GBps"] == 3350.0
    assert d["max_rel_err_vs_f64_rtol1e-8"] < 1e-3
    assert line["metric"] == ("stiff MoL ensemble solves/sec (dr=1, "
                              "tf=0.5min, rtol=1e-4)")


def test_run_mesh_over_two_cpu_slots():
    line = bench.run_mesh(2, cpu=True, lanes=LANES, **KW)
    _, want = _bench_py_lines()
    assert _keys_of(line) == want
    d = line["details"]
    assert d["per_device_consistency_vs_single_queue"] is True
    assert d["failed"] == 0 and d["devices"] == 2 and d["N"] == 2 * LANES
    assert d["backend"] == "cpu"


def test_entry_points_raise_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.main()
    with pytest.raises(RuntimeError, match="is_available"):
        bench.run_mesh()
