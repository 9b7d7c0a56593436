"""The harness end to end on the CPU, at a tiny size, in a throwaway copy
of the benchmark: it finds an added configuration, traffic mix, limits
file and metric reader by name alone; a sound run comes out correct; a
run with the timed path broken underneath comes out not correct; a cell
that keeps each member's whole trajectory is checked at every save, so a
save shifted in time fails it where a final-state cell cannot see it;
without a card, or without the program beside it, a run prints no
result."""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

HERE = pathlib.Path(__file__).resolve().parent
BENCH = HERE.parent
REPO = BENCH.parent
# tiny cells: each configuration at dr = 1 and 0.5 min on 8 lanes, with
# 16-member posterior requests and the limits of the real cell named; the
# traj16 requests keep each member's 5 saves
CELLS = {"tiny_f32.tiny16": ("base_f32", "base_f32.posterior1024"),
         "tiny_f64mix.tiny16": ("base_f64mix", "base_f64mix.efast65"),
         "tiny_f32.traj16": ("base_f32", "base_f32.posterior1024")}
CELL = "tiny_f32.tiny16"
TRAJ = "tiny_f32.traj16"
# the check's numbers of CELL on seed 7 as the harness gave them before it
# could keep trajectories (torch on the CPU, one thread)
FINAL_NUMBERS_SEED_7 = dict(err_max=0.10724931834302816,
                            err_p90=0.10003672919935164,
                            err_median=0.06352407492947151)
PROBE = '''"""A throwaway reader: the loop iterations of the window."""


def read(ctx):
    return float(ctx["iterations"]) if ctx.get("iterations") else None
'''


def _dump(path, obj):
    path.write_text(json.dumps(obj, indent=1))


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    """A copy of BENCHMARK.json and benchmark/ with the tiny cells of
    ``CELLS`` (a step cap of 200 keeps a control's lost members short)
    and one more per-layer metric."""
    root = tmp_path_factory.mktemp("checkout")
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    b = root / "benchmark"
    spec = json.loads((root / "BENCHMARK.json").read_text())
    traffic = json.loads((b / "traffic" / "posterior1024.json").read_text())
    traffic["members"] = 16
    _dump(b / "traffic" / "tiny16.json", traffic)
    _dump(b / "traffic" / "traj16.json", dict(traffic, keep="trajectory",
                                              Nts=4))
    for cell, (config, real) in CELLS.items():
        name, mix = cell.split(".")
        cfg = json.loads((b / "configs" / f"{config}.json").read_text())
        cfg.update(dr=1.0, tf=0.5, lanes=8, max_steps=200)
        _dump(b / "configs" / f"{name}.json", cfg)
        limits = json.loads((b / "limits" / f"{real}.json").read_text())
        limits["sample"] = 6
        _dump(b / "limits" / f"{cell}.json", limits)
        if name not in {c["name"] for c in spec["configs"]}:
            spec["configs"].append(dict(
                name=name, source="a test",
                file=f"benchmark/configs/{name}.json",
                reduced=["dr", "tf", "lanes", "max_steps"], why="a test"))
        spec["workloads"].append(dict(name=cell, config=name, traffic=mix,
                                      chips=1, why="a test"))
    (b / "metrics" / "tiny_probe.py").write_text(PROBE)
    for m in spec["per_layer"]:
        m["workloads"] += list(CELLS)
    spec["per_layer"].append(dict(name="tiny_probe", unit="iterations",
                                  better="lower", source="program_counter",
                                  layer="scheduler", moves="solves_per_s",
                                  workloads=[CELL]))
    _dump(root / "BENCHMARK.json", spec)
    return root


def drive(checkout, fault="none", trace=0, seed=3_000_000_019, cell=CELL,
          extra=()):
    """One run through drive_cpu.py; returns (exit code, result or None,
    standard error)."""
    args = [sys.executable, str(HERE / "drive_cpu.py"), str(checkout),
            fault, "--workload", cell, "--seed", str(seed), "--seconds",
            "0.1", "--trace", str(trace), *extra]
    env = dict(os.environ, OMP_NUM_THREADS="2")
    p = subprocess.run(args, capture_output=True, text=True, timeout=600,
                       env=env, cwd=checkout)
    lines = p.stdout.strip().splitlines()
    result = json.loads(lines[-1]) if p.returncode == 0 and lines else None
    return p.returncode, result, p.stderr


def test_added_cell_found_by_name_and_correct(checkout):
    rc, res, err = drive(checkout, trace=1)
    assert rc == 0, err[-3000:]
    assert res["correct"] is True, err[-3000:]
    assert res["attempted"] == 16 and res["failed"] == 0
    m = res["metrics"]
    assert m["tiny_probe"]["unit"] == "iterations"
    assert m["tiny_probe"]["value"] > 0
    assert 0 < m["lane_occupancy_pct"]["value"] <= 100
    assert m["member_steps"]["value"] > 1
    # the CPU has no device trace: the device readers return nothing
    assert "device_idle_pct" not in m and "rodas4_roofline" not in m
    assert list(res)[-1] == "checks"
    limits = json.loads((checkout / "benchmark" / "limits" / f"{CELL}.json")
                        .read_text())["numbers"]
    assert list(res["checks"]) == list(limits)
    for name, shown in res["checks"].items():
        assert shown["limit"] == limits[name]["limit"]
        assert 0 <= shown["value"] <= shown["limit"]
    # each number beside its limit ends standard error
    tail = err.strip().splitlines()[-len(limits):]
    assert [line.split(":")[0] for line in tail] == [
        f"check {name}" for name in limits]


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_end_to_end_line(checkout, cell):
    rc, res, err = drive(checkout, trace=0, seed=7, cell=cell)
    assert rc == 0, err[-3000:]
    assert res["correct"] is True, err[-3000:]
    assert set(res["metrics"]) == {"solves_per_s", "setup_s"}
    assert res["metrics"]["solves_per_s"]["value"] > 0


@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("fault", ["frozen_step", "half_batch",
                                   "altered_answer"])
def test_broken_timed_path_is_not_correct(checkout, fault, cell):
    rc, res, err = drive(checkout, fault=fault, cell=cell)
    assert rc == 0, err[-3000:]
    assert res["correct"] is False, res["checks"]


def test_final_state_numbers_unchanged(checkout):
    """A traffic that names no ``keep`` is checked over the final state
    alone, to the last bit as before trajectories could be kept."""
    rc, res, err = drive(checkout, seed=7)
    assert rc == 0, err[-3000:]
    assert {k: v["value"] for k, v in res["checks"].items()} == \
        FINAL_NUMBERS_SEED_7


@pytest.mark.parametrize("cell, correct", [(TRAJ, False), (CELL, True)])
def test_shifted_save(checkout, cell, correct):
    """The middle save of every member replaced by the next: a
    trajectory cell fails, a final-state cell, which never sees that
    save, does not."""
    rc, res, err = drive(checkout, fault="shifted_save", cell=cell)
    assert rc == 0, err[-3000:]
    assert res["correct"] is correct, res["checks"]


def test_control_is_not_correct(checkout):
    """The posterior cell's control, bfloat16 linear algebra, fails its
    limits already at the tiny size (the eFAST cell's float32 state
    does so only at its own size: ``test_bm_gpu.py``)."""
    rc, res, err = drive(checkout, extra=["--control"])
    assert rc == 0, err[-3000:]
    assert res["correct"] is False, res["checks"]


def test_no_card_no_result(checkout):
    """Without a CUDA card the run exits non-zero and prints nothing on
    standard output."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        CELL, "--seed", "1", "--seconds", "1", "--trace",
                        "0"], capture_output=True, text=True, cwd=checkout,
                       env=env, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_alone_no_result(checkout):
    """In a directory with only BENCHMARK.json and benchmark/, the program
    cannot be imported: the run fails and prints no result, even past the
    look for a card."""
    code = ("import sys, time; sys.path.insert(0, 'benchmark'); "
            "import run; run.main(['--workload', %r, '--seed', '1', "
            "'--seconds', '1', '--trace', '0'], device='cpu', "
            "t_start=time.perf_counter())" % CELL)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=checkout, timeout=300,
                       env=dict(os.environ, PYTHONPATH=""))
    assert p.returncode != 0
    assert "gab1_shp2_tpu_torch" in p.stderr
    assert p.stdout.strip() == ""
