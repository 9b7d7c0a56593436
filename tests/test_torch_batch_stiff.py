"""The port's chunked stiff ensemble solver (solve_stiff_batch) against the
JAX package on the same inputs.

float64 state: the same step sequence (equal accepted and rejected counts
per lane) and values within 1e-10 relative to the largest value — the
packages differ only in op order.  float32: within the JAX package's own
bound for a different op order, relative error < 2e-3
(tests/test_utils_and_pallas.py::TestFusedRos23Step); f32 step counts may
differ by a few.  Solves are small (dr=1, tf=0.5, B=4) and the JAX
reference solves are shared through module-scoped fixtures.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gab1_shp2_tpu as jg
from gab1_shp2_tpu.models.params import Params as JParams
from gab1_shp2_tpu.ops.batch_stiff import solve_stiff_batch as j_solve

import gab1_shp2_tpu_torch as tg
from gab1_shp2_tpu_torch.models.params import Params as TParams

torch.set_num_threads(2)

B = 4
KW = dict(dr=1.0, tf=0.5, Nts=2, rtol=1e-5, atol=1e-8)

# case -> (method, extra keyword arguments, per-lane Co)
CASES = {
    "trbdf2": ("trbdf2", {}, False),
    "rosenbrock23": ("rosenbrock23", {}, False),
    "rodas4": ("rodas4", {}, False),
    "rodas3_prechase_per_lane_co": ("rodas3", dict(t_prechase=0.25), True),
}


def _ensemble(dtype=np.float64, seed=0, spread=0.2):
    rng = np.random.default_rng(seed)
    p0 = np.asarray(jg.default_params().pack())
    return (p0[None] * np.exp(rng.normal(0, spread, (B, 24)))).astype(dtype)


def _co(per_lane, dtype=np.float64):
    co = np.asarray(jg.default_co()).astype(dtype)
    if per_lane:
        co = np.stack([co * (1.0 - 0.1 * i) for i in range(B)])
    return co


def _both(P, co, **kw):
    """The same solve through both packages: (jax sol, stats), (torch)."""
    sj, stj = j_solve(jg.base_system(), jnp.asarray(co),
                      JParams.unpack(jnp.asarray(P)), return_stats=True,
                      **kw)
    st, stt = tg.solve_stiff_batch(
        tg.base_system(), torch.as_tensor(co),
        TParams.unpack(torch.as_tensor(P)), device="cpu", return_stats=True,
        **kw)
    return (sj, stj), (st, stt)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(a)))


@pytest.fixture(scope="module", params=sorted(CASES))
def f64_case(request):
    method, extra, per_lane = CASES[request.param]
    return _both(_ensemble(), _co(per_lane), method=method, **extra, **KW)


def test_f64_matches_jax(f64_case):
    (sj, stj), (st, stt) = f64_case
    np.testing.assert_array_equal(stt.n_accepted.numpy(),
                                  np.asarray(stj.n_accepted))
    np.testing.assert_array_equal(stt.n_rejected.numpy(),
                                  np.asarray(stj.n_rejected))
    np.testing.assert_array_equal(stt.failed.numpy(), np.asarray(stj.failed))
    assert not stt.failed.any()
    assert _rel(sj.C, st.C.numpy()) < 1e-10
    assert _rel(sj.m, st.m.numpy()) < 1e-10
    np.testing.assert_allclose(st.t.numpy(), np.asarray(sj.t), rtol=1e-15)
    np.testing.assert_array_equal(st.r.numpy(), np.asarray(sj.r))
    np.testing.assert_array_equal(st.CoEGFR.numpy(), np.asarray(sj.CoEGFR))


def test_f64_state_f32_linear_algebra_matches_jax():
    """float64 state with float32 bands, factor and stage solves (the
    GSA recipe): values agree to the f32 factor's rounding, far inside
    the tolerance; step counts may move by the odd accept/reject."""
    kw = dict(KW, rtol=1e-4, atol=1e-7, method="rodas4")
    P, co = _ensemble(), _co(False)
    sj, stj = j_solve(jg.base_system(), jnp.asarray(co),
                      JParams.unpack(jnp.asarray(P)), return_stats=True,
                      linsolve_dtype=jnp.float32, **kw)
    st, stt = tg.solve_stiff_batch(
        tg.base_system(), torch.as_tensor(co),
        TParams.unpack(torch.as_tensor(P)), device="cpu", return_stats=True,
        linsolve_dtype=torch.float32, **kw)
    assert st.C.dtype == torch.float64
    assert not stt.failed.any()
    steps_t = (stt.n_accepted + stt.n_rejected).numpy()
    steps_j = np.asarray(stj.n_accepted + stj.n_rejected)
    assert np.abs(steps_t - steps_j).max() <= 2
    assert _rel(sj.C[:, -1], st.C[:, -1].numpy()) < 1e-6


def test_f32_fused_plain_matches_jax_xla():
    """step_impl='fused' on CPU tensors runs the kernel's plain version;
    it agrees with JAX's XLA Rosenbrock23 step within the JAX package's
    bound for a different op order."""
    P = _ensemble(np.float32, seed=5, spread=0.1)
    co = _co(False, np.float32)
    kw = dict(dr=1.0, tf=1.0, Nts=2, rtol=1e-4, atol=1e-7,
              method="rosenbrock23", return_stats=True)
    ref, sr = j_solve(jg.base_system(), jnp.asarray(co),
                      JParams.unpack(jnp.asarray(P)), step_impl="xla", **kw)
    fus, sf = tg.solve_stiff_batch(tg.base_system(), torch.as_tensor(co),
                                   TParams.unpack(torch.as_tensor(P)),
                                   device="cpu", step_impl="fused", **kw)
    assert fus.C.dtype == torch.float32
    assert not sf.failed.any()
    Cr = np.asarray(ref.C[:, -1], np.float64)
    Cf = fus.C[:, -1].double().numpy()
    err = np.max(np.abs(Cf - Cr) / (np.abs(Cr) + 1e-6))
    assert err < 2e-3, err
    # the unfused torch step on the same inputs takes the same path
    unf, su = tg.solve_stiff_batch(tg.base_system(), torch.as_tensor(co),
                                   TParams.unpack(torch.as_tensor(P)),
                                   device="cpu", step_impl="torch", **kw)
    assert torch.equal(unf.C, fus.C)
    assert torch.equal(su.n_accepted, sf.n_accepted)


def _small_call(**kw):
    P = _ensemble(np.float32)
    return tg.solve_stiff_batch(
        tg.base_system(), torch.as_tensor(_co(False, np.float32)),
        TParams.unpack(torch.as_tensor(P)), device="cpu",
        **dict(dict(dr=1.0, tf=0.01, Nts=1), **kw))


@pytest.mark.parametrize("kw,exc,match", [
    (dict(step_impl="fused", method="rodas4"), ValueError, "float32"),
    (dict(step_impl="fused", method="rosenbrock23",
          linsolve_dtype=torch.float64), ValueError, "float32"),
    (dict(step_impl="pallas"), ValueError, "step_impl"),
    (dict(method="euler"), ValueError, "method"),
    (dict(jac_reuse=True), NotImplementedError, "A10"),
    (dict(rhs_mixed="df32"), NotImplementedError, "A14"),
])
def test_scope_guards(kw, exc, match):
    with pytest.raises(exc, match=match):
        _small_call(**kw)


def test_fused_needs_f32_state():
    P = _ensemble()
    with pytest.raises(ValueError, match="float32"):
        tg.solve_stiff_batch(tg.base_system(), torch.as_tensor(_co(False)),
                             TParams.unpack(torch.as_tensor(P)),
                             device="cpu", dr=1.0, tf=0.01, Nts=1,
                             method="rosenbrock23", step_impl="fused")


def test_failure_masking():
    """A poisoned lane (absurd rates) fails without corrupting others."""
    P = _ensemble(spread=0.0)
    P[1, 7:] *= 1e12
    sol, st = tg.solve_stiff_batch(
        tg.base_system(), torch.as_tensor(_co(False)),
        TParams.unpack(torch.as_tensor(P)), device="cpu", dr=1.0, tf=0.5,
        Nts=2, rtol=1e-5, atol=1e-8, max_steps=300, method="rodas4",
        return_stats=True)
    ok = ~st.failed.numpy()
    assert ok[0] and ok[2] and ok[3] and not ok[1]
    assert torch.isfinite(sol.C[[0, 2, 3]]).all()
