"""The port's lane-minor MoL right-hand side and Jacobian bands against the
JAX package (make_mol_rhs_lanes, fast_block_jacobian_lanes) for the three
system variants, on random states.

Tolerances: float64 agrees to <= 1e-12 relative (op order only).  float32
uses the bound of the JAX package's own band test (rtol 2e-5, atol 1e-5,
tests/test_utils_and_pallas.py): the two packages round in other orders.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gab1_shp2_tpu as jg
from gab1_shp2_tpu.models.params import Params as JParams
from gab1_shp2_tpu.ops import batch_stiff as jbs
from gab1_shp2_tpu.ops.jacobian import fast_block_jacobian_lanes as jbands
from gab1_shp2_tpu.ops.rhs import initial_state as j_initial_state

import gab1_shp2_tpu_torch as tg
from gab1_shp2_tpu_torch.models.params import Params as TParams
from gab1_shp2_tpu_torch.ops import batch_stiff as tbs
from gab1_shp2_tpu_torch.ops.jacobian import (
    fast_block_jacobian_lanes as tbands,
)
from gab1_shp2_tpu_torch.ops.rhs import initial_state as t_initial_state

torch.set_num_threads(2)

VARIANTS = {"base": ("base_system",), "rect": ("rect_system",),
            "memb_sfk": ("memb_sfk_system",)}


def _inputs(variant, dtype, seed):
    rng = np.random.default_rng(seed)
    B, R, dr = 3, 10.0, 1.0
    Nr = int(round(R / dr))
    p0 = np.asarray(jg.default_params().pack())
    P = (p0[None] * np.exp(rng.normal(0, 0.3, (B, 24)))).astype(dtype)
    y = rng.uniform(0.1, 5.0, (Nr, 10, B)).astype(dtype)
    make = VARIANTS[variant][0]
    return (getattr(jg, make)(), getattr(tg, make)(), P, y, R, dr, Nr)


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(a)) + 1e-300))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_rhs_and_bands_f64(variant):
    js, ts, P, y, R, dr, Nr = _inputs(variant, np.float64, 0)
    pj = JParams.unpack(jnp.asarray(P))
    pt = TParams.unpack(torch.as_tensor(P))
    fj, rj = jbs.make_mol_rhs_lanes(js, R, dr)
    ft, rt = tbs.make_mol_rhs_lanes(ts, R, dr)
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    want = np.asarray(fj(jnp.asarray(y), pj))
    got = ft(torch.as_tensor(y), pt).numpy()
    assert _rel(want, got) < 1e-12
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 *
                               np.abs(want).max())
    for a, b, name in zip(jbands(js, jnp.asarray(y), pj, rj, dr),
                          tbands(ts, torch.as_tensor(y), pt, rt, dr),
                          ("lower", "diag", "upper")):
        a, b = np.asarray(a), b.numpy()
        assert _rel(a, b) < 1e-12, name
        np.testing.assert_allclose(b, a, rtol=1e-12,
                                   atol=1e-12 * np.abs(a).max(),
                                   err_msg=name)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_rhs_and_bands_f32(variant):
    js, ts, P, y, R, dr, Nr = _inputs(variant, np.float32, 1)
    pj = JParams.unpack(jnp.asarray(P))
    pt = TParams.unpack(torch.as_tensor(P))
    fj, rj = jbs.make_mol_rhs_lanes(js, R, dr)
    ft, rt = tbs.make_mol_rhs_lanes(ts, R, dr)
    want = np.asarray(fj(jnp.asarray(y), pj))
    got = ft(torch.as_tensor(y), pt).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=2e-5,
                               atol=1e-5 * np.abs(want).max())
    for a, b, name in zip(jbands(js, jnp.asarray(y), pj, rj, dr),
                          tbands(ts, torch.as_tensor(y), pt, rt, dr),
                          ("lower", "diag", "upper")):
        assert b.dtype == torch.float32
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=2e-5,
                                   atol=1e-5, err_msg=name)


def test_bands_match_finite_differences():
    """The dual-number bands are the Jacobian of the port's own RHS: a
    central difference of the RHS along random directions agrees."""
    _, ts, P, y, R, dr, Nr = _inputs("base", np.float64, 2)
    pt = TParams.unpack(torch.as_tensor(P))
    ft, rt = tbs.make_mol_rhs_lanes(ts, R, dr)
    yt = torch.as_tensor(y)
    L, D, U = tbands(ts, yt, pt, rt, dr)
    v = torch.as_tensor(np.random.default_rng(3).normal(size=y.shape))
    Jv = tbs.mv_lanes(D, v)
    Jv[1:] += tbs.mv_lanes(L[1:], v[:-1])
    Jv[:-1] += tbs.mv_lanes(U[:-1], v[1:])
    eps = 1e-6
    fd = (ft(yt + eps * v, pt) - ft(yt - eps * v, pt)) / (2 * eps)
    assert _rel(fd.numpy(), Jv.numpy()) < 1e-6


def test_initial_state_matches_jax():
    co = np.asarray(jg.hela_co())
    want = j_initial_state(jnp.asarray(co), 10)
    got = t_initial_state(torch.tensor(co), 10)
    np.testing.assert_array_equal(got.C_int.numpy(), np.asarray(want.C_int))
    np.testing.assert_array_equal(got.m.numpy(), np.asarray(want.m))
