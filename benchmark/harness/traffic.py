"""The one general generator of ensemble requests.

A traffic file (``traffic/<name>.json``) holds only parameters; its
``kind`` picks one of the draws below.  Every request is one ensemble
of packed (N, 24) float64 parameter rows (7 diffusivities, then 17 rate
constants, the order of the configuration's ``params``), drawn from one
stream seeded by ``--seed``: the same seed gives the same requests, in
the same order.

Kinds:

* ``rows``: ``members`` rows drawn without replacement from the CSV
  ``file`` (relative to ``benchmark/``; a header of parameter names, one
  parameter set a line), a fresh draw a request, as the upstream
  ensemble drivers subsample their shipped parameter ensemble; the
  parameters named in ``fixed`` held at the configuration's value.
* ``efast``: one whole extended-FAST design a request, as an eFAST sweep
  submits it: ``samples`` points on each parameter's search curve
  (``harmonics`` harmonics), in log space between value / ``factor`` and
  value * ``factor``; d * ``resamples`` * ``samples`` rows, curve by
  curve.  Request k's random phases come from ``design_seed`` + k, so no
  two requests of a window share a member, and every run seed solves the
  same designs in the same order (the corners a design hits set its
  cost); each request takes the curves in an order drawn from the run's
  stream.  The design's arithmetic is Saltelli, Tarantola & Chan (1999),
  as GlobalSensitivity.jl and the port's ``gsa/efast.py`` compute it,
  copied here so that the yardstick does not move with the program.
"""

from __future__ import annotations

import math
import pathlib

import numpy as np

BENCH_DIR = pathlib.Path(__file__).resolve().parent.parent


def efast_design(lo, hi, samples: int, harmonics: int, resamples: int,
                 rng: np.random.Generator) -> np.ndarray:
    """The eFAST sample matrix (d * resamples * samples, d) in the
    coordinates of ``lo``/``hi`` (log coordinates for a log-space
    design)."""
    d = len(lo)
    omega_max = (samples - 1) // (2 * harmonics)
    if omega_max < harmonics:
        raise ValueError("samples too small for the harmonic count")
    # complementary frequencies: at most omega_max / (2 * harmonics),
    # cycled over the other parameters
    m = max(omega_max // (2 * harmonics), 1)
    comp = 1 + (np.arange(d - 1) % m)
    s = (2.0 * math.pi / samples) * np.arange(samples)
    X = np.empty((d, resamples, samples, d))
    for i in range(d):
        omega = np.empty(d)
        omega[i] = omega_max
        omega[np.arange(d) != i] = comp
        for c in range(resamples):
            phi = rng.uniform(0.0, 2.0 * math.pi, size=d)
            g = 0.5 + (1.0 / math.pi) * np.arcsin(
                np.sin(omega[None, :] * s[:, None] + phi[None, :]))
            X[i, c] = lo + g * (hi - lo)
    return X.reshape(d * resamples * samples, d)


class Requests:
    """The stream of requests of one traffic mix under one seed."""

    def __init__(self, traffic: dict, params: dict, seed: int):
        if traffic["kind"] not in ("rows", "efast"):
            raise ValueError(f"unknown traffic kind {traffic['kind']!r}")
        self.spec = traffic
        names = list(params)
        self.center = np.array([params[n] for n in names], dtype=np.float64)
        self.fixed = [names.index(n) for n in traffic.get("fixed", ())]
        self.rng = np.random.default_rng(int(seed))
        self.k = 0
        if traffic["kind"] == "rows":
            path = BENCH_DIR / traffic["file"]
            with open(path) as fh:
                header = fh.readline().strip().split(",")
            table = np.loadtxt(path, delimiter=",", skiprows=1, ndmin=2)
            # the configuration's parameter order, whatever the file's
            self.table = table[:, [header.index(n) for n in names]]

    def next(self) -> np.ndarray:
        """The next request's (N, 24) float64 rows."""
        t, p0 = self.spec, self.center
        self.k += 1
        if t["kind"] == "rows":
            idx = self.rng.choice(len(self.table), int(t["members"]),
                                  replace=False)
            X = self.table[idx]
            X[:, self.fixed] = p0[self.fixed]
            return X
        f, n = float(t["factor"]), int(t["samples"])
        lo, hi = np.log(p0 / f), np.log(p0 * f)
        X = np.exp(efast_design(
            lo, hi, n, int(t["harmonics"]), int(t.get("resamples", 1)),
            np.random.default_rng(int(t["design_seed"]) + self.k - 1)))
        curves = X.reshape(-1, n, X.shape[1])
        order = self.rng.permutation(len(curves))
        return curves[order].reshape(-1, X.shape[1])
