"""The comparison that decides ``correct``.

After the window has closed, a sample of the members it solved, drawn
from the seed, is solved again by the configuration's plain reference
(``reference/<name>.py``: NumPy and SciPy, nothing of the program) from
the same parameter rows the program was given, in worker processes on
the host's CPU.  Each sampled member that the program marked valid is
compared over all that its request kept: by default its final state,
every bulk species on every node and every membrane species; under a
traffic's ``"keep": "trajectory"`` that state at every save time after
t = 0.  A member's error is the largest

    |program - reference| / (atol + rtol * scale)

with the configuration's rtol and atol, and as scale the largest
magnitude of that bulk species over the profile (for a membrane
species, of the membrane state), and over every save time kept, t = 0
included: the error in units of the solver's own tolerance, against
each species' own size.  The numbers are the
largest, the 90th percentile and the median of the sampled members'
errors; a cell's limits file names those it compares.

This module imports neither torch nor the program: the reference's
worker processes import it.
"""

from __future__ import annotations

import os
from multiprocessing import get_context

import numpy as np

from harness import spec


def pick(sizes, n: int, seed: int):
    """``n`` (request, member) pairs drawn from the seed over requests of
    ``sizes`` members (all pairs when there are fewer)."""
    pairs = [(r, i) for r, size in enumerate(sizes) for i in range(size)]
    if len(pairs) <= n:
        return pairs
    rng = np.random.default_rng([int(seed), 20261017])
    idx = np.sort(rng.choice(len(pairs), n, replace=False))
    return [pairs[i] for i in idx]


def _solve(job):
    name, rows, Co, geom, tol, t_save = job
    ref = spec.load_module("reference", name)
    C, m, _ = ref.solve_member(rows, Co, R=geom["R"], dr=geom["dr"],
                               tf=geom["tf"], rtol=tol["rtol"],
                               atol=tol["atol"], t_save=t_save)
    return C, m


def reference(name: str, rows, Co, config: dict, tol: dict, t_save=None):
    """The reference's final states (K, 10, Nr+1) and (K, 8) of the
    parameter rows (K, 24), or with ``t_save`` its states at those times,
    (K, T, 10, Nr+1) and (K, T, 8); one worker process per CPU core, none
    of which touches the card."""
    geom = dict(R=float(config["R"]), dr=float(config["dr"]),
                tf=float(config["tf"]))
    jobs = [(name, r, list(Co), geom, tol, t_save) for r in rows]
    saved = {k: os.environ.get(k) for k in ("CUDA_VISIBLE_DEVICES",
                                            "OMP_NUM_THREADS")}
    os.environ.update(CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    if hasattr(os, "sched_setaffinity"):
        # the window kept to two cores; the workers take every core
        os.sched_setaffinity(0, range(os.cpu_count() or 1))
    try:
        workers = max(1, min(len(jobs), os.cpu_count() or 1))
        with get_context("spawn").Pool(workers) as pool:
            res = pool.map(_solve, jobs, chunksize=1)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return np.stack([r[0] for r in res]), np.stack([r[1] for r in res])


def member_errors(C, m, C_ref, m_ref, rtol: float, atol: float):
    """Each member's largest error in units of the tolerance, against
    each species' own scale (see the module docstring).  Final states
    are (K, 10, Nr+1) and (K, 8); trajectories (K, T, 10, Nr+1) and
    (K, T, 8), whose first save, t = 0, sets no error."""
    first = 1
    if m.ndim == 2:
        # one save, the final one, compared
        C, m, C_ref, m_ref = (a[:, None] for a in (C, m, C_ref, m_ref))
        first = 0
    sC = np.abs(C_ref).max(axis=(1, 3), keepdims=True)
    sm = np.abs(m_ref).max(axis=(1, 2), keepdims=True)
    eC = np.abs(C - C_ref)[:, first:] / (atol + rtol * sC)
    em = np.abs(m - m_ref)[:, first:] / (atol + rtol * sm)
    e = np.maximum(eC.reshape(len(C), -1).max(axis=1),
                   em.reshape(len(m), -1).max(axis=1))
    # a non-finite output is as wrong as it gets
    return np.where(np.isfinite(e), e, np.inf)


def numbers(errors) -> dict:
    """The numbers; no valid member sampled reads as wrong."""
    if len(errors) == 0:
        return dict(err_max=np.inf, err_p90=np.inf, err_median=np.inf)
    return dict(err_max=float(np.max(errors)),
                err_p90=float(np.quantile(errors, 0.9)),
                err_median=float(np.median(errors)))


def verdict(nums: dict, limits: dict):
    """``correct`` and each compared number beside its limit (a number
    that is not finite shows as null)."""
    ok = all(nums[k] <= v["limit"] for k, v in limits.items())
    shown = {k: {"value": nums[k] if np.isfinite(nums[k]) else None,
                 "limit": v["limit"]} for k, v in limits.items()}
    return ok, shown
