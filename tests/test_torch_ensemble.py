"""The port's ensemble engine (gab1_shp2_tpu_torch.ensemble.engine)
against the JAX ``run_ensemble`` and ``masked_quantiles`` on the CPU.

Tolerances.  f64 throughout.  The stiff schedulers take the same steps
as the JAX package (exact step counts, ``tests/test_torch_batch_stiff.py``)
so extracted values agree within 1e-10 relative and ``ok`` is equal; the
explicit solver agrees within 1e-12.  Grouped against unchunked explicit
chunks: rtol 1e-6 (the JAX test's bound,
``tests/test_ensemble.py::TestExplicitGroupedChunks``; a member's result
does not depend on its chunk, so the port is in fact bit-equal).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gab1_shp2_tpu as jg
from gab1_shp2_tpu.ensemble.engine import masked_quantiles as j_quantiles
from gab1_shp2_tpu.ensemble.engine import run_ensemble as j_run
from gab1_shp2_tpu.models.observables import gsa_outputs as j_gsa

import gab1_shp2_tpu_torch as tg
from gab1_shp2_tpu_torch.models.observables import gsa_outputs as t_gsa
from gab1_shp2_tpu_torch.parallel.mesh import ensemble_mesh

torch.set_num_threads(2)

FAST = dict(dr=0.5, tf=0.5, Nts=2)
STIFF = dict(solver="stiff", rtol=1e-4, atol=1e-7, **FAST)


def _batch(n, sigma=0.3, seed=0):
    rng = np.random.default_rng(seed)
    p0 = np.asarray(jg.default_params().pack())
    return p0[None, :] * np.exp(rng.normal(0.0, sigma, size=(n, 24)))


def _j_gsa6(s):
    return j_gsa(s, 10.0)


def _t_gsa6(s):
    return t_gsa(s, 10.0)


def _j_pg1s(s):
    return s.PG1Stot[-1]


def _t_pg1s(s):
    return s.PG1Stot[-1]


def _t_run(batch, **kw):
    return tg.run_ensemble(tg.base_system(), tg.default_co(device="cpu"),
                           batch, device="cpu", **kw)


@pytest.mark.parametrize("sched_kw", [
    dict(scheduler="refill", chunk=4, refill_group=4),
    dict(scheduler="sorted", chunk=2),
    dict(),                                   # the default: refill
], ids=["refill", "sorted", "default"])
def test_stiff_matches_jax(sched_kw):
    batch = _batch(6)
    want, ok_j = j_run(jg.base_system(), jg.default_co(), jnp.asarray(batch),
                       extract=_j_gsa6, **STIFF, **sched_kw)
    got, ok_t = _t_run(batch, extract=_t_gsa6, **STIFF, **sched_kw)
    assert tuple(got.shape) == (6, 6)
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    assert bool(ok_t.all())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10)


def test_sorted_unchunked_and_params_input_match_chunked():
    """``chunk=None`` is one batched solve; a batched ``Params`` is taken
    like a packed array; cost-sorted chunks un-sort to the same rows."""
    batch = _batch(5, seed=2)
    pb = tg.Params.unpack(torch.as_tensor(batch))
    a, oka = _t_run(pb, extract=_t_pg1s, scheduler="sorted", **STIFF)
    b, okb = _t_run(batch, extract=_t_pg1s, scheduler="sorted", chunk=2,
                    **STIFF)
    assert tuple(a.shape) == (5, 21)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12)
    assert torch.equal(oka, okb)


def test_explicit_matches_jax():
    batch = _batch(4)
    kw = dict(solver="explicit", tol=1e-4, maxiters=20, **FAST)
    want, ok_j = j_run(jg.base_system(), jg.default_co(), jnp.asarray(batch),
                       extract=_j_gsa6, **kw)
    got, ok_t = _t_run(batch, extract=_t_gsa6, **kw)
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)


def test_explicit_grouped_matches_unchunked():
    """A wide spread of stiffness, so chunks get different step counts
    (``tests/test_ensemble.py::TestExplicitGroupedChunks``)."""
    batch = _batch(9, sigma=0.6, seed=3)
    kw = dict(solver="explicit", extract=_t_pg1s, tol=1e-4, maxiters=20,
              **FAST)
    a, oka = _t_run(batch, **kw)
    b, okb = _t_run(batch, chunk=4, **kw)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-9)
    assert torch.equal(oka, okb)
    want, _ = j_run(jg.base_system(), jg.default_co(), jnp.asarray(batch),
                    solver="explicit", extract=_j_pg1s, tol=1e-4,
                    maxiters=20, chunk=4, **FAST)
    # round-off over the up to ~2,700 steps of the stiffest member
    np.testing.assert_allclose(b.numpy(), np.asarray(want), rtol=1e-10)


@pytest.mark.parametrize("solver_kw", [
    dict(solver="explicit", tol=1e-4, maxiters=20),
    dict(solver="stiff", rtol=1e-4, atol=1e-7, scheduler="sorted"),
    dict(solver="stiff", rtol=1e-4, atol=1e-7, scheduler="refill", chunk=2),
], ids=["explicit", "sorted", "refill"])
def test_nan_member_is_masked(solver_kw):
    """A member whose solve goes non-finite is flagged invalid and the
    quantiles ignore it; its neighbours are untouched.  Stiff: a NaN
    parameter.  Explicit: kSi = -2000, so aSFK grows like exp(2000 t) and
    overflows (a NaN parameter would make the shared step count NaN, which
    raises in both packages)."""
    batch = _batch(3, sigma=0.05, seed=4)
    bad = batch.copy()
    bad[1, 7 + 9] = -2000.0 if solver_kw["solver"] == "explicit" else np.nan
    kw = dict(extract=_t_gsa6, max_steps=200, **FAST, **solver_kw) \
        if solver_kw["solver"] == "stiff" else \
        dict(extract=_t_gsa6, **FAST, **solver_kw)
    out, ok = _t_run(bad, **kw)
    assert ok.tolist() == [True, False, True]
    clean, _ = _t_run(batch, **kw)
    np.testing.assert_allclose(out[[0, 2]].numpy(), clean[[0, 2]].numpy(),
                               rtol=1e-12)
    q = tg.masked_quantiles(out, ok)
    want = np.quantile(out[[0, 2]].numpy(), [0.159, 0.5, 0.841], axis=0)
    assert torch.isfinite(q).all()
    np.testing.assert_allclose(q.numpy(), want, rtol=1e-12)


@pytest.mark.parametrize("shape", [(12,), (12, 5), (12, 3, 4)])
def test_masked_quantiles_match_jax(shape):
    rng = np.random.default_rng(7)
    values = rng.normal(0.0, 1.0, shape)
    valid = rng.random(12) > 0.3
    values[~valid] = np.nan if len(shape) > 1 else 1e30
    for qs in ((0.159, 0.5, 0.841), (0.025, 0.975)):
        want = j_quantiles(jnp.asarray(values), jnp.asarray(valid), qs)
        got = tg.masked_quantiles(torch.as_tensor(values),
                                  torch.as_tensor(valid), qs)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-12)


def test_argument_errors():
    batch = _batch(2)
    with pytest.raises(ValueError, match="scheduler"):
        _t_run(batch, solver="explicit", scheduler="refill", **FAST)
    with pytest.raises(ValueError, match="unknown scheduler"):
        _t_run(batch, solver="stiff", scheduler="fifo", **FAST)
    with pytest.raises(ValueError, match="unknown solver"):
        _t_run(batch, solver="implicit", **FAST)
    with pytest.raises(ValueError, match="unknown solver"):
        _t_run(batch, solver="implicit", scheduler="refill", **FAST)
    with pytest.raises(ValueError, match="not in mesh axes"):
        _t_run(batch, device_axis="members",
               mesh=ensemble_mesh(["cpu"]), **FAST)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tg.run_ensemble(tg.base_system(), tg.default_co(device="cpu"),
                            batch, **FAST)


def test_sorted_chunks_take_their_rows_of_a_per_member_co():
    """``scheduler="sorted"`` with ``chunk < N`` and a per-member ``Co``
    of shape (N, 5): each chunk solves with its own members' rows.  The
    JAX package raises on this input (it hands every chunk the whole
    ``Co``), so the reference is its unchunked call, which accepts it."""
    batch = _batch(4)
    co = np.asarray(jg.default_co())[None, :] * np.array(
        [1.0, 0.5, 2.0, 1.5])[:, None]
    kw = dict(solver="stiff", dr=1.0, tf=0.3, Nts=2, rtol=1e-4, atol=1e-7)
    want, ok_j = j_run(jg.base_system(), jnp.asarray(co), jnp.asarray(batch),
                       scheduler="sorted", **kw)
    got, ok_t = tg.run_ensemble(tg.base_system(), torch.as_tensor(co),
                                batch, device="cpu", scheduler="sorted",
                                chunk=2, **kw)
    assert bool(ok_t.all()) and bool(np.asarray(ok_j).all())
    np.testing.assert_allclose(got.C.numpy(), np.asarray(want.C),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(got.C[0, -1, 0, :3].numpy(),
                               np.asarray(want.C)[0, -1, 0, :3], rtol=1e-12)
