"""The port's lane-refill scheduler (solve_stiff_refill) against the port's
own chunked solve and against the JAX package's refill
(after tests/test_batch_stiff.py::TestRefillScheduler).

The two schedulers share one copy of the step arithmetic, and every lane
op is elementwise in the lane axis, so a member's step sequence must be
the same whichever scheduler runs it: step counts equal exactly, values
to float roundoff.  Against JAX in float64: equal step counts and values
within 1e-10 relative to the largest value.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gab1_shp2_tpu as jg
from gab1_shp2_tpu.models.params import Params as JParams
from gab1_shp2_tpu.ops.batch_stiff import solve_stiff_refill as j_refill

import gab1_shp2_tpu_torch as tg
from gab1_shp2_tpu_torch.models.params import Params as TParams

torch.set_num_threads(2)

KW = dict(dr=1.0, tf=1.0, Nts=2, rtol=1e-5, atol=1e-8, method="rodas4")


def _ensemble(N, spread, seed):
    rng = np.random.default_rng(seed)
    p0 = np.asarray(jg.default_params().pack())
    return p0[None] * np.exp(rng.normal(0, spread, (N, 24)))


def _co():
    return torch.tensor(np.asarray(jg.default_co()))


def _pt(P):
    return TParams.unpack(torch.as_tensor(P))


def _chunked_and_refill(P, lanes, harvest_every, **kw):
    solb, statb = tg.solve_stiff_batch(tg.base_system(), _co(), _pt(P),
                                       device="cpu", return_stats=True, **kw)
    out, ok, steps = tg.solve_stiff_refill(
        tg.base_system(), _co(), _pt(P), device="cpu", lanes=lanes,
        harvest_every=harvest_every, **kw)
    return solb, statb, out, ok, steps


def test_matches_chunked():
    solb, statb, out, ok, steps = _chunked_and_refill(
        _ensemble(8, 0.3, 5), lanes=4, harvest_every=3, **KW)
    np.testing.assert_array_equal(
        steps.numpy(), (statb.n_accepted + statb.n_rejected).numpy())
    np.testing.assert_allclose(out.C.numpy(), solb.C.numpy(), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(out.m.numpy(), solb.m.numpy(), rtol=1e-12,
                               atol=1e-12)
    assert ok.all()


def test_two_leg_pulse_chase_matches_chunked():
    """Per-lane leg switching: refilled lanes cross t_prechase at
    staggered iterations, yet each member's steps match the chunked
    two-leg integrator's."""
    solb, statb, out, ok, steps = _chunked_and_refill(
        _ensemble(8, 0.3, 11), lanes=3, harvest_every=3,
        **dict(KW, Nts=4, t_prechase=0.5))
    np.testing.assert_array_equal(
        steps.numpy(), (statb.n_accepted + statb.n_rejected).numpy())
    np.testing.assert_allclose(out.C.numpy(), solb.C.numpy(), rtol=1e-12,
                               atol=1e-12)
    assert ok.all()
    # the chase leg fired: pEGFR falls after t_prechase (slot 2)
    pE = solb.pE.mean(dim=0).numpy()
    assert pE[-1] < pE[2]


def test_reducer_extract_small_queue_default_method():
    """N < lanes (dead lanes from the start), a reducing extract applied
    per member under torch.func.vmap, and the default method (trbdf2)."""
    P = _ensemble(3, 0.2, 7)
    kw = dict(dr=1.0, tf=0.5, Nts=2, rtol=1e-5, atol=1e-8)
    solb = tg.solve_stiff_batch(tg.base_system(), _co(), _pt(P),
                                device="cpu", **kw)
    out, ok, _ = tg.solve_stiff_refill(
        tg.base_system(), _co(), _pt(P), device="cpu",
        extract=lambda sol: sol.PG1Stot[-1], lanes=8, harvest_every=4, **kw)
    np.testing.assert_allclose(out.numpy(), solb.PG1Stot[:, -1].numpy(),
                               rtol=1e-12, atol=1e-12)
    assert out.shape == (3, 11)
    assert ok.all()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("co_rows", ["per_member", "shared"])
def test_failure_masking_and_batched_co(co_rows, dtype):
    """A poisoned member is harvested as failed and a member cut short by
    ``max_steps`` as not ok, as in the chunked solve; their lanes are
    refilled and later members still solve; per-member or shared Co rows
    flow through.  Under both schedulers the cut member holds the same
    saves up to the last it reached and NaN in every slot after it.  In
    float32 the lane width moves roundoff: values within 1e-5."""
    N = 6
    P = _ensemble(N, 0.0, 0)
    P[1, 7:] *= 1e12
    P[3, 7:] *= 3e3         # 127 steps to tf, the others at most 77
    co = np.array(jg.default_co())
    if co_rows == "per_member":
        co = np.stack([co * (1.0 - 0.05 * i) for i in range(N)])
    Cob = torch.as_tensor(co, dtype=dtype)
    Pt = TParams.unpack(torch.as_tensor(P, dtype=dtype))
    kw = dict(KW, tf=0.5, max_steps=100)
    solb, statb = tg.solve_stiff_batch(tg.base_system(), Cob, Pt,
                                       device="cpu", return_stats=True, **kw)
    out, ok, steps = tg.solve_stiff_refill(tg.base_system(), Cob, Pt,
                                           device="cpu", lanes=2,
                                           harvest_every=5, **kw)
    np.testing.assert_array_equal(ok.numpy(), ~statb.failed.numpy())
    np.testing.assert_array_equal(ok.numpy(), ~np.isin(np.arange(N), [1, 3]))
    assert int(steps[3]) == int(statb.n_accepted[3] + statb.n_rejected[3])
    assert int(steps[3]) == 100
    if dtype == torch.float64:
        tol = dict(rtol=1e-12, atol=1e-12)
    else:
        tol = dict(rtol=1e-5, atol=1e-5 * float(solb.C[ok].abs().max()))
    good = ok.numpy()
    np.testing.assert_allclose(out.C.numpy()[good], solb.C.numpy()[good],
                               **tol)
    reached = torch.isfinite(solb.C[3]).flatten(1).all(dim=1)
    n = int(reached.sum())
    assert 1 <= n <= KW["Nts"] and reached[:n].all()
    np.testing.assert_allclose(out.C[3, :n].numpy(), solb.C[3, :n].numpy(),
                               **tol)
    assert torch.isnan(out.C[3, n:]).all() and torch.isnan(solb.C[3, n:]).all()
    assert torch.isnan(out.m[3, n:]).all() and torch.isnan(solb.m[3, n:]).all()
    np.testing.assert_array_equal(out.CoEGFR.numpy(),
                                  Cob[..., 4].expand(N).numpy())


def test_matches_jax_refill_f64():
    P = _ensemble(7, 0.3, 13)
    kw = dict(KW, t_prechase=0.5)
    oj, okj, sj = j_refill(jg.base_system(), jnp.asarray(jg.default_co()),
                           JParams.unpack(jnp.asarray(P)), lanes=3,
                           harvest_every=3, **kw)
    ot, okt, st = tg.solve_stiff_refill(tg.base_system(), _co(), _pt(P),
                                        device="cpu", lanes=3,
                                        harvest_every=3, **kw)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    for a, b in ((oj.C, ot.C), (oj.m, ot.m)):
        a = np.asarray(a)
        assert np.max(np.abs(a - b.numpy())) / np.max(np.abs(a)) < 1e-10
