"""The port's double-f32 arithmetic (ops/df32.py), its compensated RHS
(ops/rhs_df32.py) and ``rhs_mixed`` of the batched stiff solver, against
the JAX package on the CPU.

Tolerances.
* ``two_sum``/``two_prod``: exact (s + e equals a + b, resp. a * b, in
  float64) on 10^4 seeded float32 pairs; the df32 operations within
  1e-13 of float64 arithmetic on the represented inputs (the JAX test's
  bound).
* The compensated RHS against the JAX package's, evaluated op by op on
  the same state (dr 0.5, B 8): both compute the same float32
  operations; bit-equal for the base and rect systems, 7.2e-15 relative
  for memb_sfk, bound 1e-13.  Against the port's float64 RHS at the
  df32-rounded state: < 1e-10 (4.5e-12 seen; the JAX test's bound).
* A tangent through the compensated RHS against the float64 RHS's:
  1e-5 of its largest entry (the JAX test's bound).
* Solves (f64, dr 1, tf 0.25, B 4, Rosenbrock23 at rtol 1e-4): the same
  accepted and rejected steps as the JAX package's.  ``"df32"``: within
  1e-12 of the JAX package's native float64 solve (its RHS carries
  ~2^-48); the JAX package's own df32 solve is compiled by XLA, whose
  CPU backend does not keep every float32 rounding of the transforms
  (its jitted df32 RHS lands ~2e-5 from float64, its op-by-op one
  ~2e-10), so the two df32 solves agree within 2e-6.  ``True`` (the
  jvp split, ~1e-7 floor) within 2e-6 of the JAX package's: the f32
  RHS of the two packages differ in their last bits.  Relative errors
  are taken against |C| + 1e-6 max |C|, as the JAX test takes them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gab1_shp2_tpu as jg
from gab1_shp2_tpu.models.params import Params as JParams
from gab1_shp2_tpu.ops import df32 as jd3
from gab1_shp2_tpu.ops.batch_stiff import _lanes_y0
from gab1_shp2_tpu.ops.rhs_df32 import make_mol_rhs_lanes_df32 as j_rhs_df32

import gab1_shp2_tpu_torch as tg
from gab1_shp2_tpu_torch.ops import df32 as d3
from gab1_shp2_tpu_torch.ops.batch_stiff import make_mol_rhs_lanes
from gab1_shp2_tpu_torch.ops.rhs_df32 import make_mol_rhs_lanes_df32

torch.set_num_threads(2)


def _pairs(seed, spread):
    rng = np.random.default_rng(seed)
    a = (rng.normal(size=10_000) * 10.0 ** rng.integers(-spread, spread,
                                                        10_000))
    b = (rng.normal(size=10_000) * 10.0 ** rng.integers(-spread, spread,
                                                        10_000))
    return a.astype(np.float32), b.astype(np.float32)


def test_two_sum_and_two_prod_exact():
    a, b = _pairs(0, 6)
    s, e = d3.two_sum(torch.as_tensor(a), torch.as_tensor(b))
    got = s.numpy().astype(np.float64) + e.numpy().astype(np.float64)
    np.testing.assert_array_equal(got, a.astype(np.float64) + b)
    a, b = _pairs(1, 4)
    p, e = d3.two_prod(torch.as_tensor(a), torch.as_tensor(b))
    got = p.numpy().astype(np.float64) + e.numpy().astype(np.float64)
    # a*b in f64 is exact (24+24 <= 53 bits)
    np.testing.assert_array_equal(got, a.astype(np.float64) * b)
    # the same pairs through the JAX package's transforms: bit-equal
    pj, ej = jd3.two_prod(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(p.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(e.numpy(), np.asarray(ej))


def test_roundtrip_and_ops():
    rng = np.random.default_rng(2)
    x = torch.as_tensor(rng.lognormal(0, 3, 512))
    y = torch.as_tensor(rng.lognormal(0, 3, 512))
    xd, yd = d3.from_f64(x), d3.from_f64(y)
    # hi + lo carries ~48 bits: the round trip is accurate to ~2^-48
    np.testing.assert_allclose(d3.to_f64(xd).numpy(), x.numpy(), rtol=1e-14)
    xr, yr = d3.to_f64(xd), d3.to_f64(yd)
    for name, got, want in [
        ("add", d3.to_f64(xd + yd), xr + yr),
        ("sub", d3.to_f64(xd - yd), xr - yr),
        ("mul", d3.to_f64(xd * yd), xr * yr),
        ("div", d3.to_f64(xd / yd), xr / yr),
        ("pow", d3.to_f64(xd ** 3), xr ** 3),
        ("rsub", d3.to_f64(1.5 - xd), 1.5 - xr),
    ]:
        rel = float(((got - want).abs() / want.abs()).max())
        assert rel < 1e-13, (name, rel)
    with pytest.raises(ValueError):
        xd ** 0.5


def _rhs_state(B, dr, seed=3, R=10.0):
    rng = np.random.default_rng(seed)
    Co = np.asarray(jg.default_co())
    CoT = np.repeat(Co[:, None], B, 1) * rng.lognormal(0, 0.2, (5, B))
    M = int(round(R / dr)) - 1
    y0 = np.asarray(_lanes_y0(jnp.asarray(CoT), M, jnp.float64))
    p0 = np.asarray(jg.default_params().pack())
    P = p0[None, :] * rng.lognormal(0, 0.2, (B, 24))
    # evolve off the initial state so every species is populated
    y = y0 + 0.01 * rng.lognormal(0, 0.5, y0.shape) * (y0 + 1e-3)
    return y, P


@pytest.mark.parametrize("system", ["base_system", "rect_system",
                                    "memb_sfk_system"])
def test_rhs_df32_matches_jax_and_f64(system):
    R, dr, B = 10.0, 0.5, 8
    y, P = _rhs_state(B, dr)
    fj, _ = j_rhs_df32(getattr(jg, system)(), R, dr)
    want = np.asarray(fj(jnp.asarray(y), JParams.unpack(jnp.asarray(P))))
    ft, r = make_mol_rhs_lanes_df32(getattr(tg, system)(), R, dr)
    assert r.dtype == torch.float64 and r.shape == (int(R / dr) + 1,)
    yt, pt = torch.as_tensor(y), tg.Params.unpack(torch.as_tensor(P))
    got = ft(yt, pt).numpy()
    denom = np.abs(want) + 1e-30 * np.abs(want).max()
    assert np.max(np.abs(got - want) / denom) <= 1e-13
    # operation error alone: the port's float64 RHS at the df32-rounded
    # state and parameters
    f64, _ = make_mol_rhs_lanes(getattr(tg, system)(), R, dr)
    y_r = d3.to_f64(d3.from_f64(yt))
    p_r = tg.Params.unpack(d3.to_f64(d3.from_f64(torch.as_tensor(P))))
    ref = f64(y_r, p_r).numpy()
    assert np.max(np.abs(ref - got) / denom) < 1e-10


def test_tangent_through_rhs_df32():
    """Forward-mode tangents flow through the compensated RHS."""
    R, dr, B = 10.0, 1.0, 4
    system = tg.base_system()
    fdf, _ = make_mol_rhs_lanes_df32(system, R, dr)
    f64, _ = make_mol_rhs_lanes(system, R, dr)
    y, P = _rhs_state(B, dr)
    yt, pt = torch.as_tensor(y), tg.Params.unpack(torch.as_tensor(P))
    v = torch.ones_like(yt)
    _, ta = torch.func.jvp(lambda yy: f64(yy, pt), (yt,), (v,))
    _, tb = torch.func.jvp(lambda yy: fdf(yy, pt), (yt,), (v,))
    assert float((ta - tb).abs().max() / ta.abs().max()) < 1e-5


SOLVE = dict(R=10.0, dr=1.0, tf=0.25, Nts=2, rtol=1e-4, atol=1e-7,
             method="rosenbrock23")


@pytest.fixture(scope="module")
def solve_inputs():
    rng = np.random.default_rng(0)
    p0 = np.asarray(jg.default_params().pack())
    return np.array(jg.default_co()), p0[None] * rng.lognormal(
        0, 0.15, (4, 24))


def _j_solve(Co, P, rhs_mixed):
    return jg.solve_stiff_batch(jg.base_system(), jnp.asarray(Co),
                                JParams.unpack(jnp.asarray(P)),
                                return_stats=True, rhs_mixed=rhs_mixed,
                                **SOLVE)


@pytest.fixture(scope="module")
def t_solve(solve_inputs):
    """The port's solve of ``solve_inputs``, once per ``rhs_mixed`` in
    this module."""
    Co, P = solve_inputs
    done = {}

    def solve(rhs_mixed):
        if rhs_mixed not in done:
            done[rhs_mixed] = tg.solve_stiff_batch(
                tg.base_system(), torch.as_tensor(Co),
                tg.Params.unpack(torch.as_tensor(P)), device="cpu",
                return_stats=True, rhs_mixed=rhs_mixed, **SOLVE)
        return done[rhs_mixed]

    return solve


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b) / (np.abs(a) + 1e-6 * np.abs(a).max()))


@pytest.mark.parametrize("rhs_mixed,ref_mixed,bound", [
    ("df32", False, 1e-12), ("df32", "df32", 2e-6), (True, True, 2e-6)],
    ids=["df32-vs-f64", "df32-vs-df32", "jvp-split"])
def test_solve_rhs_mixed_matches_jax(solve_inputs, t_solve, rhs_mixed,
                                     ref_mixed, bound):
    Co, P = solve_inputs
    js, jst = _j_solve(Co, P, ref_mixed)
    ts, tst = t_solve(rhs_mixed)
    np.testing.assert_array_equal(tst.n_accepted.numpy(),
                                  np.asarray(jst.n_accepted))
    np.testing.assert_array_equal(tst.n_rejected.numpy(),
                                  np.asarray(jst.n_rejected))
    assert not bool(tst.failed.any())
    assert _rel(js.C, ts.C.numpy()) < bound
    assert _rel(js.m, ts.m.numpy()) < bound


def test_refill_takes_rhs_mixed(solve_inputs, t_solve):
    """The lane-refill scheduler builds its RHS as the chunked one does:
    each member's final profile equals the chunked solve's within
    1e-12."""
    Co, P = solve_inputs
    ts, _ = t_solve(True)
    out, ok, _ = tg.solve_stiff_refill(
        tg.base_system(), torch.as_tensor(Co),
        tg.Params.unpack(torch.as_tensor(P)), device="cpu",
        extract=lambda s: s.C[-1], rhs_mixed=True, lanes=2, **SOLVE)
    assert bool(ok.all())
    assert _rel(ts.C[:, -1].numpy(), out.numpy()) < 1e-12


@pytest.mark.parametrize("entry", ["batch", "refill"])
@pytest.mark.parametrize("rhs_mixed", ["df32", True])
def test_rhs_mixed_needs_f64_state(entry, rhs_mixed):
    Co = tg.default_co(dtype=torch.float32, device="cpu")
    p = tg.default_params(dtype=torch.float32, device="cpu")
    pb = tg.Params(D=p.D[None].repeat(2, 1), k=p.k[None].repeat(2, 1))
    fn = tg.solve_stiff_batch if entry == "batch" else tg.solve_stiff_refill
    with pytest.raises(ValueError, match="float64 state"):
        fn(tg.base_system(), Co, pb, device="cpu", dr=1.0, tf=0.1, Nts=1,
           rhs_mixed=rhs_mixed)
