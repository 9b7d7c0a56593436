"""The plain reference: it agrees with itself under refinement, its
complex-step Jacobian agrees with finite differences and its pattern
holds every nonzero, and at a tiny grid it lands where the program's own
tight float64 solve does (two independent codes of one semi-discrete
system)."""

from __future__ import annotations

import json

import numpy as np
import pytest

from harness import spec

ref = spec.load_module("reference", "mol_spherical")
CONFIG = json.loads((spec.BENCH_DIR / "configs" / "base_f64mix.json")
                    .read_text())
P0 = np.array(list(CONFIG["params"].values()))
CO = spec.initial_concentrations(CONFIG)
TINY = dict(R=10.0, dr=1.0, tf=0.5)


def member(scale_seed=None):
    if scale_seed is None:
        return P0
    rng = np.random.default_rng(scale_seed)
    return P0 * np.exp(rng.uniform(-np.log(10), np.log(10), P0.size))


def rel(a, b):
    return np.max(np.abs(a - b) / (np.abs(b).max(axis=-1, keepdims=True)
                                   + 1e-12))


@pytest.mark.parametrize("seed", [None, 1])
def test_refinement(seed):
    p = member(seed)
    outs = [ref.solve_member(p, CO, rtol=r, atol=r * 1e-2, **TINY)
            for r in (1e-5, 1e-7, 1e-9)]
    e_coarse = rel(outs[0][0], outs[2][0])
    e_fine = rel(outs[1][0], outs[2][0])
    assert e_fine < 1e-6
    assert e_fine < e_coarse or e_coarse < 1e-9
    assert outs[2][2] > outs[0][2]          # more steps when tighter


def test_jacobian_and_pattern():
    mb = ref.Member(member(3), CO, 10.0, 1.0)
    u = mb.y0() * (1.0 + 0.3 * np.random.default_rng(0).random(mb.n)) + 1.0
    J = mb.jac(0.0, u).toarray()
    fd = np.empty_like(J)
    for c in range(mb.n):
        e = np.zeros(mb.n)
        e[c] = 1e-6 * max(1.0, abs(u[c]))
        fd[:, c] = (mb.rhs(0.0, u + e) - mb.rhs(0.0, u - e)) / (2 * e[c])
    scale = np.abs(J).max()
    np.testing.assert_allclose(J, fd, atol=1e-7 * scale)
    # nothing outside the pattern
    assert np.all(fd[J == 0] == 0)
    # the vectorised right-hand side equals the column-wise one
    U = np.stack([u, 2 * u, u + 3], axis=1)
    np.testing.assert_allclose(
        mb.rhs(0.0, U), np.stack([mb.rhs(0.0, U[:, k]) for k in range(3)],
                                 axis=1), rtol=1e-13, atol=1e-13 * scale)


@pytest.mark.parametrize("seed", [None, 2])
def test_trajectory_at_the_save_points(seed):
    """With save times the reference gives the state at each: the first
    is the initial state, the last the final state of the plain call, and
    at rtol 1e-7 every save after t = 0 lies within 0.01 tolerance units
    (rtol 1e-4, atol 1e-7, each scale as the check takes it) of a
    run at rtol 1e-9 that stops at every save."""
    from scipy.integrate import solve_ivp

    p, tol = member(seed), dict(rtol=1e-7, atol=1e-9)
    t_save = np.linspace(0.0, TINY["tf"], 6)
    C, m, steps = ref.solve_member(p, CO, t_save=t_save, **tol, **TINY)
    Cf, mf, steps_f = ref.solve_member(p, CO, **tol, **TINY)
    assert C.shape == (6, 10, 11) and m.shape == (6, 8)
    assert steps == steps_f
    np.testing.assert_allclose(C[-1], Cf, rtol=1e-12, atol=0)
    np.testing.assert_allclose(m[-1], mf, rtol=1e-12, atol=1e-300)
    mb = ref.Member(p, CO, TINY["R"], TINY["dr"])
    np.testing.assert_allclose(C[0], mb.profile(mb.y0()), rtol=1e-12)
    u, tight = mb.y0(), [mb.y0()]
    for a, b in zip(t_save[:-1], t_save[1:]):
        u = solve_ivp(mb.rhs, (a, b), u, method="Radau", rtol=1e-9,
                      atol=1e-11, jac=mb.jac).y[:, -1]
        tight.append(u)
    U = np.stack(tight, axis=1)
    Ct, mt = mb.profile(U).transpose(2, 0, 1), mb.split(U)[1].T
    sC = np.abs(Ct).max(axis=(0, 2), keepdims=True)
    sm = np.abs(mt).max()
    err = max((np.abs(C - Ct) / (1e-7 + 1e-4 * sC))[1:].max(),
              (np.abs(m - mt) / (1e-7 + 1e-4 * sm))[1:].max())
    assert err < 0.01


def test_matches_the_programs_tight_solve():
    import torch

    import gab1_shp2_tpu_torch as tg

    p = member(4)
    C, m, _ = ref.solve_member(p, CO, rtol=1e-9, atol=1e-11, **TINY)
    pb = tg.Params.unpack(torch.tensor(p, dtype=torch.float64)[None])
    sol = tg.solve_stiff_batch(tg.base_system(),
                               torch.tensor(CO, dtype=torch.float64), pb,
                               device="cpu", dr=1.0, tf=0.5, Nts=2,
                               rtol=1e-9, atol=1e-11, method="rodas4")
    assert rel(sol.C[0, -1].numpy(), C) < 1e-7
    assert rel(sol.m[0, -1].numpy()[None], m[None]) < 1e-7
