"""Find a cell's pieces by name.

``BENCHMARK.json`` at the checkout's root names every cell, every
configuration and every metric.  Everything that belongs to one of them
lives in a file of its own under ``benchmark/``, found by name alone:

* ``configs/<config>.json``: the deployment (sizes, precision, solver
  settings, the reference that re-derives its results);
* ``traffic/<traffic>.json``: the parameters of one traffic mix, read by
  the one general generator in ``harness/traffic.py``, with the save
  times a request asks for (``Nts``) and what it keeps of each member
  (``keep``: ``final``, the default, or ``trajectory``;
  ``harness/cell_run.py``);
* ``limits/<workload>.json``: how many members the check samples and the
  limit of each number compared;
* ``metrics/<metric>.py``: the reader of one per-layer metric;
* ``work/<method>.py``: the least work of one step of a solver method;
* ``reference/<reference>.py``: a plain reference solver.
"""

from __future__ import annotations

import importlib.util
import json
import math
import pathlib
from typing import NamedTuple

BENCH_DIR = pathlib.Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict        # configs/<config>.json
    traffic: dict       # traffic/<traffic>.json
    limits: dict        # limits/<workload>.json
    end_to_end: list    # BENCHMARK.json entries this cell reports
    per_layer: list


def _load_json(path: pathlib.Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(workload: str, bench_dir: pathlib.Path = BENCH_DIR) -> Cell:
    """The cell ``workload`` of ``BENCHMARK.json`` (one level above
    ``bench_dir``) with its configuration, traffic and limits."""
    spec = _load_json(bench_dir.parent / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    config = _load_json(bench_dir.parent / configs[w["config"]]["file"])
    traffic = _load_json(bench_dir / "traffic" / f"{w['traffic']}.json")
    limits = _load_json(bench_dir / "limits" / f"{workload}.json")
    if (traffic["kind"] == "efast" and "efast_samples" in config
            and config["efast_samples"] != traffic["samples"]):
        raise ValueError(f"{w['traffic']} samples {traffic['samples']} "
                         f"curves, {w['config']} states "
                         f"{config['efast_samples']}")
    return Cell(name=workload, chips=int(w["chips"]),
                config=config, traffic=traffic, limits=limits,
                end_to_end=[m for m in spec["end_to_end"]
                            if _reports(m, workload)],
                per_layer=[m for m in spec["per_layer"]
                           if _reports(m, workload)])


def load_module(kind: str, name: str, bench_dir: pathlib.Path = BENCH_DIR):
    """Import ``benchmark/<kind>/<name>.py`` by path (no package needed,
    and nothing of the program's import path is touched)."""
    path = bench_dir / kind / f"{name}.py"
    mod_name = f"_bench_{kind}_{name.replace('.', '_')}"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def initial_concentrations(config: dict) -> list:
    """The five initial concentrations from the configuration's copies
    per cell: cytosolic species per volume, EGFR per surface area of a
    sphere of radius R (``run_base_model.jl:67-76``)."""
    R = float(config["R"])
    vol = 4.0 / 3.0 * math.pi * R**3
    surf = 4.0 * math.pi * R**2
    c = config["copies_per_cell"]
    return [c["SFK"] / vol, c["GRB2"] / vol, c["GAB1"] / vol,
            c["SHP2"] / vol, c["EGFR"] / surf]
