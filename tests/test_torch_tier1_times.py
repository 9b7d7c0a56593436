"""``scripts/tier1_times.py``: the per-file worker seconds of a tier-1
run from its junit XML record, and the plugin that adds each test's
worker and clock readings to the record."""

import importlib.util
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")

_spec = importlib.util.spec_from_file_location(
    "tier1_times", os.path.join(SCRIPTS, "tier1_times.py"))
tier1_times = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(tier1_times)


def _case(classname, name, time, worker=None, start=None, end=None):
    props = ""
    if worker is not None:
        props = ("<properties>"
                 f'<property name="worker" value="{worker}"/>'
                 f'<property name="start" value="{start}"/>'
                 f'<property name="end" value="{end}"/>'
                 "</properties>")
    return (f'<testcase classname="{classname}" name="{name}" '
            f'time="{time}">{props}</testcase>')


def test_sums_per_file_and_total_over_workers(tmp_path):
    """Three files, one of them the port's, one a class's tests, one
    without clock readings."""
    cases = [
        _case("tests.test_a", "test_x", 1.5, "gw0", 100.0, 101.5),
        _case("tests.test_a.TestK", "test_y", 2.5, "gw0", 101.5, 104.0),
        _case("tests.test_torch_b", "test_z[1]", 3.0, "gw1", 100.5, 103.5),
        _case("tests.test_torch_b", "test_z[2]", 1.1, "gw1", 103.5, 104.6),
        _case("tests.test_c", "test_w", 4.0),
    ]
    xml = tmp_path / "run.xml"
    xml.write_text('<?xml version="1.0" encoding="utf-8"?><testsuites>'
                   '<testsuite name="pytest" tests="5">' + "".join(cases)
                   + "</testsuite></testsuites>")
    files = tier1_times.per_file(str(xml))
    assert set(files) == {"tests/test_a.py", "tests/test_torch_b.py",
                          "tests/test_c.py"}
    a, b, c = (files[f"tests/{n}.py"] for n in ("test_a", "test_torch_b",
                                                "test_c"))
    assert (a["seconds"], a["tests"], a["workers"]) == (4.0, 2, {"gw0"})
    assert (a["start"], a["end"]) == (100.0, 104.0)
    assert (b["tests"], b["workers"]) == (2, {"gw1"})
    assert b["seconds"] == pytest.approx(4.1, abs=1e-12)
    assert (b["start"], b["end"]) == (100.5, 104.6)
    assert (c["seconds"], c["tests"], c["start"]) == (4.0, 1, None)
    out = tier1_times.table(files)
    assert ("total worker seconds 12.1 (port files 4.1); total / 6 = 2.0"
            in out)
    assert "first start to last end 4.6 s" in out
    assert out.splitlines()[1].split()[:2] == ["tests/test_torch_b.py",
                                               "4.1"]


def test_plugin_writes_worker_and_clock(tmp_path):
    """A run with the plugin: every case carries its worker and clock
    readings, and its time (setup, call and teardown) lies within them."""
    # each case sleeps, so that junit's three-decimal time reads above 0
    for name, body in (("test_p.py", "import time\n\n\ndef test_one():\n"
                                     "    time.sleep(0.01)\n"),
                       ("test_q.py", "import time\n\n\ndef test_two():\n"
                                     "    time.sleep(0.05)\n")):
        (tmp_path / name).write_text(body)
    xml = tmp_path / "run.xml"
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PYTEST_")}
    env["PYTHONPATH"] = SCRIPTS
    try:
        out = subprocess.run(
            [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
             "-p", "tier1_times", f"--junitxml={xml}", str(tmp_path)],
            cwd=tmp_path, env=env, capture_output=True, text=True,
            timeout=120)
    except subprocess.TimeoutExpired:
        pytest.fail("the plugin's pytest run did not end within its 120 s "
                    "limit")
    assert out.returncode == 0, out.stdout + out.stderr
    files = tier1_times.per_file(str(xml))
    assert set(files) == {"test_p.py", "test_q.py"}
    for row in files.values():
        assert row["tests"] == 1 and row["workers"] == {"main"}
        assert 0 < row["seconds"] <= row["end"] - row["start"] + 1e-3
    assert files["test_q.py"]["end"] - files["test_q.py"]["start"] >= 0.05
