"""The general generator: the same seed gives the same requests, another
seed others; the draws have the traffic files' shapes; the posterior
rows are the shipped ensemble's; each eFAST request is the design the
port's sweep submits, a new one each request."""

from __future__ import annotations

import json

import numpy as np
import pytest

from harness import spec
from harness.traffic import Requests

CONFIG = json.loads((spec.BENCH_DIR / "configs" / "base_f64mix.json")
                    .read_text())
TRAFFIC = {n: json.loads((spec.BENCH_DIR / "traffic" / f"{n}.json")
                         .read_text()) for n in ("posterior1024", "efast65")}
SEEDS = (0, 12345, 2**31 + 11, 3_000_000_007)


def draws(name, seed, n=2):
    r = Requests(TRAFFIC[name], CONFIG["params"], seed)
    return [r.next() for _ in range(n)]


@pytest.mark.parametrize("name", sorted(TRAFFIC))
@pytest.mark.parametrize("seed", SEEDS)
def test_same_seed_same_requests(name, seed):
    a, b = draws(name, seed), draws(name, seed)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(a[0], a[1]), "requests repeat"


@pytest.mark.parametrize("name", sorted(TRAFFIC))
def test_seeds_differ(name):
    firsts = [draws(name, s, 1)[0] for s in SEEDS]
    for i in range(len(firsts)):
        for j in range(i):
            assert not np.array_equal(firsts[i], firsts[j])


def test_posterior_rows_are_the_files():
    """Each request is 1,024 distinct rows of the shipped ensemble, in
    the configuration's parameter order, EGF at its value."""
    path = spec.BENCH_DIR / TRAFFIC["posterior1024"]["file"]
    header = path.read_text().splitlines()[0].split(",")
    assert header == list(CONFIG["params"])
    table = np.loadtxt(path, delimiter=",", skiprows=1)
    assert table.shape == (5000, 24)
    rows = {tuple(r) for r in table}
    p0 = np.array(list(CONFIG["params"].values()))
    egf = header.index("EGF")
    for X in draws("posterior1024", 2**31 + 3, 2):
        assert X.shape == (1024, 24) and X.dtype == np.float64
        got = {tuple(r) for r in X}
        assert len(got) == 1024 and got <= rows
        np.testing.assert_array_equal(X[:, egf], p0[egf])


def test_efast_is_the_ports_design_in_curve_order():
    """Request k holds the design the port's gsa/efast.py builds with the
    traffic's design seed + k, whole curves in a seeded order; no two
    requests share a member, and every seed solves the same designs."""
    from gab1_shp2_tpu_torch.gsa.efast import efast_design, log_bounds_around

    t = TRAFFIC["efast65"]
    p0 = np.array(list(CONFIG["params"].values()))

    def design(k):
        d = efast_design(log_bounds_around(p0, t["factor"]), t["samples"],
                         num_harmonics=t["harmonics"],
                         rng=np.random.default_rng(t["design_seed"] + k))
        assert np.all(d.X >= p0 / 1000 * (1 - 1e-12))
        assert np.all(d.X <= p0 * 1000 * (1 + 1e-12))
        return d.X.reshape(24, 65, 24)

    orders = []
    for seed in (77, 78):
        reqs = draws("efast65", seed, 2)
        assert not np.isin(reqs[0], reqs[1]).all(axis=1).any()
        for k, X in enumerate(reqs):
            assert X.shape == (24 * 65, 24)
            curves, got = design(k), X.reshape(24, 65, 24)
            order = [int(np.argmin(np.abs(curves - c).max(axis=(1, 2))))
                     for c in got]
            assert sorted(order) == list(range(24))
            np.testing.assert_allclose(got, curves[order], rtol=1e-12)
            orders.append(order)
    assert orders[0] != orders[1] and orders[0] != orders[2]
