"""The fused explicit solve's plain version against the JAX Pallas kernel
(interpret mode on the CPU) and the f64 explicit path; the wrapper's CPU
dispatch, its limits, the fixed-point contraction and the flop count.

Tolerances.  ``solve_explicit_plain`` against ``solve_explicit_pallas``
(f32, dr=0.5, maxiters 20): the JAX test's own bounds
(``tests/test_utils_and_pallas.py:81-86``), C within rtol 3e-5 + atol
1e-4 and m within rtol 3e-5 + atol 1e-6.  The two differ in the Laplacian
form (the Pallas kernel uses up-2C+um with an f32 1/(j dr^2) metric row,
the port the production (up-uc)-(uc-um) with 1/(r dr)) and in f32 op
order over ~830 steps; measured max |dC| 3e-5 on values up to 143.  The
same bounds hold against the port's f64 ``solve_explicit(tol=0,
maxiters=20)``, as in the JAX test.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gab1_shp2_tpu as jg
from gab1_shp2_tpu.models.params import Params as JParams
from gab1_shp2_tpu.ops.explicit_pallas import solve_explicit_pallas

import gab1_shp2_tpu_torch as tg
from gab1_shp2_tpu_torch.gsa.runner import dk_bounds
from gab1_shp2_tpu_torch.models.params import stability_dt
from gab1_shp2_tpu_torch.ops import explicit_cuda
from gab1_shp2_tpu_torch.ops.rhs import (
    bc_closure,
    effective_diffusivities,
    kdict,
    memb_rates,
)

torch.set_num_threads(2)

CO = tg.default_co(device="cpu")


def _pair(**second):
    """Two members: the defaults, and the defaults scaled."""
    p0 = tg.default_params(device="cpu")
    p1 = p0.scale(**second)
    return tg.Params(D=torch.stack([p0.D, p1.D]), k=torch.stack([p0.k, p1.k]))


def _k105():
    p0 = tg.default_params(device="cpu")
    return tg.Params(D=torch.stack([p0.D, p0.D]),
                     k=torch.stack([p0.k, p0.k * 1.05]))


def _plain(variant, pb, tf):
    return explicit_cuda.solve_explicit_plain(
        getattr(tg, variant)(), CO, pb, dr=0.5, tf=tf, maxiters=20,
        device="cpu")


@pytest.fixture(scope="module")
def base_plain():
    """The plain solve of the JAX test's ensemble (shared by two tests)."""
    return _plain("base_system", _k105(), 0.5)


def _assert_close(C, m, C_ref, m_ref):
    C, m = C.numpy().astype(np.float64), m.numpy().astype(np.float64)
    assert np.isfinite(C).all() and np.isfinite(m).all()
    np.testing.assert_allclose(C, np.asarray(C_ref, np.float64), rtol=3e-5,
                               atol=1e-4)
    np.testing.assert_allclose(m, np.asarray(m_ref, np.float64), rtol=3e-5,
                               atol=1e-6)


def _pallas(variant, pb, tf):
    pj = JParams(D=jnp.asarray(pb.D.numpy()), k=jnp.asarray(pb.k.numpy()))
    return solve_explicit_pallas(getattr(jg, variant)(), jg.default_co(), pj,
                                 dr=0.5, tf=tf, maxiters=20,
                                 block=pb.k.shape[0], interpret=True)


def test_plain_matches_pallas_interpret_base(base_plain):
    C, m = base_plain
    assert tuple(C.shape) == (2, 10, 21) and tuple(m.shape) == (2, 8)
    assert C.dtype == m.dtype == torch.float32
    _assert_close(C, m, *_pallas("base_system", _k105(), 0.5))


@pytest.mark.parametrize("variant", ["rect_system", "memb_sfk_system"])
def test_plain_matches_pallas_interpret_variants(variant):
    """One member at tf=0.2, the shape of the JAX rect test."""
    p0 = tg.default_params(device="cpu")
    pb = tg.Params(D=p0.D[None], k=p0.k[None])
    C, m = _plain(variant, pb, 0.2)
    _assert_close(C, m, *_pallas(variant, pb, 0.2))


def test_plain_matches_pallas_with_one_iteration():
    """With one iteration per step the result rests on the warm start
    from the previous step's membrane state: both kernels must carry it
    the same way (same bounds as above; 166 steps)."""
    p0 = tg.default_params(device="cpu")
    pb = tg.Params(D=p0.D[None], k=p0.k[None])
    C, m = explicit_cuda.solve_explicit_plain(
        tg.base_system(), CO, pb, dr=0.5, tf=0.1, maxiters=1, device="cpu")
    pj = JParams(D=jnp.asarray(pb.D.numpy()), k=jnp.asarray(pb.k.numpy()))
    _assert_close(C, m, *solve_explicit_pallas(
        jg.base_system(), jg.default_co(), pj, dr=0.5, tf=0.1, maxiters=1,
        block=1, interpret=True))


def test_plain_matches_f64_explicit(base_plain):
    C, m = base_plain
    ref = tg.solve_explicit(tg.base_system(), CO, _k105(), device="cpu",
                            dr=0.5, tf=0.5, Nts=2, maxiters=20, tol=0.0)
    _assert_close(C, m, ref.C[:, -1].numpy(), ref.m[:, -1].numpy())


def test_members_with_different_step_counts_equal_solo():
    """A member with D x 2 takes twice the steps of its neighbour; both
    equal their solo solves bit for bit (masking freezes the short one),
    with or without ``block``."""
    pb = _pair(Dsfk=2.0, Dg2=2.0, Dg2g1=2.0, Dg2g1s2=2.0, Dg1=2.0,
               Dg1s2=2.0, Ds2=2.0)
    nt = torch.ceil(0.1 / stability_dt(pb, 0.5))
    assert int(nt[1]) > 1.5 * int(nt[0])
    kw = dict(dr=0.5, tf=0.1, maxiters=4, device="cpu")
    C, m = explicit_cuda.solve_explicit_plain(tg.base_system(), CO, pb, **kw)
    Cb, mb = explicit_cuda.solve_explicit_plain(tg.base_system(), CO, pb,
                                                block=1, **kw)
    assert torch.equal(C, Cb) and torch.equal(m, mb)
    for i in range(2):
        solo = tg.Params(D=pb.D[i:i + 1], k=pb.k[i:i + 1])
        Ci, mi = explicit_cuda.solve_explicit_plain(tg.base_system(), CO,
                                                    solo, **kw)
        assert torch.equal(C[i], Ci[0]) and torch.equal(m[i], mi[0]), i


def test_wrapper_on_cpu_is_the_plain_version():
    pb = _k105()
    kw = dict(dr=1.0, tf=0.05, maxiters=4, device="cpu")
    before = explicit_cuda.LAUNCHES
    got = explicit_cuda.solve_explicit_fused(tg.base_system(), CO, pb, **kw)
    want = explicit_cuda.solve_explicit_plain(tg.base_system(), CO, pb, **kw)
    assert explicit_cuda.LAUNCHES == before
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # f64 inputs are cast: the result is float32 either way
    assert got[0].dtype == torch.float32


@pytest.mark.parametrize("fn", ["solve_explicit_fused",
                                "solve_explicit_plain"])
def test_limits_raise(fn):
    solve = getattr(explicit_cuda, fn)
    pb = _k105()
    # 1026 nodes is the most: one thread per interior node, 1024 a block
    assert explicit_cuda.MAX_NODES == 1026
    with pytest.raises(ValueError, match="1026-node"):
        solve(tg.base_system(), CO, pb, R=10.26, dr=0.01, tf=1e-6,
              device="cpu")
    with pytest.raises(ValueError, match="at least 3 nodes"):
        solve(tg.base_system(), CO, pb, dr=10.0, tf=0.01, device="cpu")
    with pytest.raises(ValueError, match="maxiters"):
        solve(tg.base_system(), CO, pb, dr=1.0, tf=0.01, maxiters=0,
              device="cpu")
    with pytest.raises(ValueError, match="batched"):
        solve(tg.base_system(), CO, tg.default_params(device="cpu"), dr=1.0,
              tf=0.01, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            solve(tg.base_system(), CO, pb, dr=1.0, tf=0.01)


def test_finer_grid_than_the_tpu_kernel_runs():
    """dr=0.05 (201 nodes) is beyond the Pallas kernel's 128-lane layout;
    the port takes it."""
    p0 = tg.default_params(device="cpu")
    pb = tg.Params(D=p0.D[None], k=p0.k[None])
    C, m = explicit_cuda.solve_explicit_plain(
        tg.base_system(), CO, pb, dr=0.05, tf=2e-5, maxiters=4, device="cpu")
    assert tuple(C.shape) == (1, 10, 201) and torch.isfinite(C).all()


def test_fixed_iterations_converge_at_gsa_corners():
    """The port's form of ``TestMembraneFixedPointAtCorners``: the kernel
    replaces the tolerance loop by a fixed iteration count.  At x1000
    bounds GSA corner draws, mid-transient (150 steps of the
    tolerance-looped solver), the kernel's exact map with its warm start
    reaches <= 3e-5 relative residual within the default count, and
    contracts by at least 0.6x per iteration, with the port's own
    ``bc_closure`` and ``memb_rates`` in f32."""
    default_iters = inspect.signature(
        explicit_cuda.solve_explicit_fused).parameters["maxiters"].default
    system, dr, B, n_pre = tg.base_system(), 0.2, 6, 150
    rng = np.random.default_rng(42)
    bounds = dk_bounds(tg.default_params(device="cpu"))
    lo, hi = np.log(bounds[:, 0]), np.log(bounds[:, 1])
    draws = np.exp(lo + (hi - lo) * rng.random((B, 24)))
    pb = tg.Params.unpack(torch.as_tensor(draws, dtype=torch.float32))
    dts = stability_dt(pb, dr)
    Co32 = CO.float()
    Cs, ms = [], []
    for i in range(B):      # each member to its own t = n_pre * dt
        sol = tg.solve_explicit(
            system, Co32, tg.Params(D=pb.D[i], k=pb.k[i]), device="cpu",
            dr=dr, tf=float(n_pre * dts[i]), Nts=2, maxiters=100, tol=1e-7)
        Cs.append(sol.C[-1])
        ms.append(sol.m[-1])
    Cs, m_prev = torch.stack(Cs), torch.stack(ms)
    assert float(m_prev[:, 3:].abs().max()) > 0      # mid-transient
    C_near, CR_warm = Cs[:, :, -2], Cs[:, :, -1]
    k, d_eff = kdict(pb.k), effective_diffusivities(system, pb)

    def fp_iter(carry):
        _, mm = carry
        CR = bc_closure(system, C_near, mm, k, d_eff, dr)
        return CR, m_prev + dts[:, None] * memb_rates(system, m_prev, CR, k)

    ref = (CR_warm, m_prev)
    for _ in range(60):
        ref = fp_iter(ref)
    assert torch.isfinite(ref[0]).all()
    scale = ref[0].abs() + 1e-3
    carry, errs = (CR_warm, m_prev), []
    for _ in range(default_iters):
        carry = fp_iter(carry)
        errs.append(float(((carry[0] - ref[0]).abs() / scale).max()))
    assert errs[-1] < 3e-5, errs
    for a, b in zip(errs, errs[1:]):
        assert b <= 0.6 * a + 1e-7, errs


def test_explicit_flops_hand_count():
    """Nr=2 (one interior node), one fixed-point iteration, base system,
    in the kernel's hoisted form (1/dr^2, 1/(r dr), dr/d_eff taken once).

    Bulk reactions: five reversible bindings A+B<->C at 7 each (2 mults,
    1 mult, 1 sub, 3 accumulations) = 35; two catalysed
    phosphorylations at 6 each (2 mults, 1 mult, 1 sub, 2
    accumulations) = 12; aSFK->iSFK 3: 50.  Stencil and update: 10
    species x (4 + 3 spherical + 4) = 110.  Node: 160.
    Once a step: the membrane reactions, mE<->mES with the EGF scale 6
    (2 mults, 1 mult, 1 sub, 2 accumulations), 2 mES<->mESmES 7 (2 mults,
    1 mult, 1 sub, 2 + 1 accumulations), mESmES<->E 5: 18; the 8
    bindings' off terms kr*m 8: 26.
    Iteration: 8 bindings x 2 mults (kr*m, kf*m; one binding a species,
    so no adds) 16; g*q + cn and l*q + 1 on the 8 species with a binding
    32; 8 quotients; binding nets (kf*CR)*m - off and two accumulations
    8 x 5 = 40; membrane update 16: 112.
    Boundary values of the last iterate: Etot 4 adds + 1 mult 5; iSFK's
    kSa*Etot, l*q + 1 and quotient 4; aSFK's cn + kq*CR*Et 3: 12.
    Step: 160 + 26 + 112 + 12 = 310."""
    assert explicit_cuda.explicit_flops(tg.base_system(), 2, 1) == 310
    # rect drops the metric term: 10 x 3 fewer per node
    assert explicit_cuda.explicit_flops(tg.rect_system(), 2, 1) == 280
    # linear in the interior nodes and in the iterations
    assert explicit_cuda.explicit_flops(tg.base_system(), 50, 4) == \
        49 * 160 + 26 + 4 * 112 + 12
