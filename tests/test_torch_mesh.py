"""The port's device mesh (gab1_shp2_tpu_torch.parallel.mesh) and the
engine's sharded paths, on slots of the CPU, against the JAX package and
against the port's unsharded runs.

A mesh here is several slots of one device (``ensemble_mesh(["cpu"] *
k)``): each slot solves its shard on its own worker thread.

Tolerances.  f64 throughout, the JAX test's configuration (``FAST``: dr
0.5, tf 0.5, Nts 2, RODAS4 at rtol 1e-4).  A member's steps do not
depend on its shard, lanes or scheduler, so the sharded refill agrees
with the JAX package's unsharded refill within rtol 1e-9 (the JAX test's
bound, ``tests/test_ensemble.py::TestSharding``; 1.7e-15 seen here), and
a sharded run with the port's unsharded run within 1e-12.  ``ok`` masks
are equal.
"""

import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gab1_shp2_tpu as jg
from gab1_shp2_tpu.ensemble.engine import run_ensemble as j_run
from gab1_shp2_tpu.parallel.mesh import pad_to_multiple as j_pad

import gab1_shp2_tpu_torch as tg
from gab1_shp2_tpu_torch.models.observables import gsa_outputs
from gab1_shp2_tpu_torch.ops import ros23_cuda
from gab1_shp2_tpu_torch.parallel.mesh import (
    ensemble_mesh,
    pad_to_multiple,
    run_sharded,
    run_sharded_batch,
    shard_ensemble,
)

torch.set_num_threads(2)

FAST = dict(dr=0.5, tf=0.5, Nts=2)
STIFF = dict(solver="stiff", rtol=1e-4, atol=1e-7, method="rodas4", **FAST)


def _batch(n, sigma=0.05, seed=0):
    rng = np.random.default_rng(seed)
    p0 = np.asarray(jg.default_params().pack())
    return p0[None, :] * np.exp(rng.normal(0.0, sigma, size=(n, 24)))


def _j_pg1s(s):
    return s.PG1Stot[-1]


def _t_pg1s(s):
    return s.PG1Stot[-1]


def _t_run(batch, **kw):
    return tg.run_ensemble(tg.base_system(), tg.default_co(device="cpu"),
                           torch.as_tensor(batch), extract=_t_pg1s, **kw)


def _cpu_mesh(k):
    return ensemble_mesh(["cpu"] * k)


def test_pad_to_multiple_matches_jax():
    batch = _batch(5)
    want, n_j = j_pad(jnp.asarray(batch), 8)
    got, n_t = pad_to_multiple(torch.as_tensor(batch), 8)
    assert n_t == n_j == 5
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # a tuple of leaves pads together; a multiple already is left alone
    (a, b), n = pad_to_multiple((torch.arange(6), torch.ones(6, 2)), 3)
    assert n == 6 and a.shape == (6,) and b.shape == (6, 2)


def test_mesh_and_shards():
    mesh = ensemble_mesh(["cpu", "cpu", "cpu"], axis="members")
    assert mesh.axis_names == ("members",)
    assert mesh.devices == (torch.device("cpu"),) * 3 and mesh.size == 3
    x = torch.arange(12.0).reshape(6, 2)
    shards = shard_ensemble((x, x[:, 0]), mesh)
    assert len(shards) == 3
    torch.testing.assert_close(torch.cat([s[0] for s in shards]), x)
    with pytest.raises(ValueError, match="equal shards"):
        shard_ensemble(x[:5], mesh)


def test_refill_sharded_matches_jax():
    """Each of 2 slots runs its own refill queue over its shard of 10
    members (10 lanes each), against the JAX package's unsharded refill
    (4 lanes)."""
    batch = _batch(20, sigma=0.3, seed=4)
    want, ok_j = j_run(jg.base_system(), jg.default_co(), jnp.asarray(batch),
                       extract=_j_pg1s, chunk=4, scheduler="refill", **STIFF)
    got, ok_t = _t_run(batch, chunk=10, scheduler="refill",
                       device_axis="ensemble", mesh=_cpu_mesh(2), **STIFF)
    assert got.device == torch.device("cpu") and tuple(got.shape) == (20, 21)
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    assert bool(ok_t.all())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9,
                               atol=1e-12)


def test_sorted_sharded_schedule_matches_unsharded():
    """Two slots, one member each a super-chunk: the pilot fit runs on
    the first super-chunk and sorts the second; un-sorted, every member
    matches the port's unsharded sorted run."""
    batch = _batch(4, sigma=0.3, seed=7)
    a, oka = _t_run(batch, device="cpu", scheduler="sorted", **STIFF)
    b, okb = _t_run(batch, chunk=1, scheduler="sorted",
                    device_axis="ensemble", mesh=_cpu_mesh(2), **STIFF)
    np.testing.assert_array_equal(okb.numpy(), oka.numpy())
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-12)


@pytest.mark.parametrize("scheduler,per_member_co", [
    ("refill", True), ("sorted", False)])
def test_sharded_pads_small_n(scheduler, per_member_co):
    """5 members over 2 slots: padded with a repeat of the last member,
    solved, and sliced back; a per-member Co is sharded with them."""
    batch = _batch(5)
    Co = tg.default_co(device="cpu")
    if per_member_co:
        Co = Co[None].repeat(5, 1) * torch.linspace(
            0.9, 1.1, 5, dtype=Co.dtype)[:, None]
    kw = dict(STIFF, extract=_t_pg1s, scheduler=scheduler)
    a, oka = tg.run_ensemble(tg.base_system(), Co, torch.as_tensor(batch),
                             device="cpu", **kw)
    b, okb = tg.run_ensemble(tg.base_system(), Co, torch.as_tensor(batch),
                             device_axis="ensemble", mesh=_cpu_mesh(2), **kw)
    assert tuple(b.shape) == (5, 21)
    np.testing.assert_array_equal(okb.numpy(), oka.numpy())
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-12)


def _params(batch):
    return tg.Params.unpack(torch.as_tensor(batch))


def test_run_sharded_batch_and_run_sharded_match_unsharded():
    """The batch-aware and the per-member routes over 2 slots against the
    same calls without a mesh (rtol 1e-12: a member's steps do not depend
    on its batch)."""
    system, co = tg.base_system(), tg.default_co(device="cpu")
    kw = dict(device="cpu", dr=1.0, tf=0.25, Nts=2, rtol=1e-4, atol=1e-7,
              method="rodas4")
    batch = torch.as_tensor(_batch(4))

    def local_batch(packed):
        sol, stats = tg.solve_stiff_batch(system, co, _params(packed),
                                          return_stats=True, **kw)
        return gsa_outputs(sol, 10.0), stats.failed

    out, failed = run_sharded_batch(local_batch, batch, _cpu_mesh(2))
    ref, ref_failed = local_batch(batch)
    assert tuple(out.shape) == (4, 6) and not bool(failed.any())
    torch.testing.assert_close(failed, ref_failed)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-12)

    def one(packed):
        sol = tg.solve_stiff(system, co, tg.Params.unpack(packed), **kw)
        return sol.C[-1, :, -1]

    got = run_sharded(one, batch[:2], _cpu_mesh(2))
    want = torch.stack([one(p) for p in batch[:2]])
    assert tuple(got.shape) == (2, 10)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12)


def test_argument_errors():
    batch = _batch(2)
    with pytest.raises(ValueError, match="not in mesh axes"):
        _t_run(batch, device_axis="replicas", mesh=_cpu_mesh(2), **STIFF)
    with pytest.raises(NotImplementedError, match="explicit"):
        _t_run(batch, solver="explicit", device_axis="ensemble",
               mesh=_cpu_mesh(2), **FAST)
    with pytest.raises(ValueError, match="first device"):
        _t_run(batch, device="meta", device_axis="ensemble",
               mesh=_cpu_mesh(2), **STIFF)
    if not torch.cuda.is_available():
        # no fallback to the CPU: the default mesh is the cards
        with pytest.raises(RuntimeError, match="CUDA"):
            ensemble_mesh()
        with pytest.raises(RuntimeError, match="CUDA"):
            _t_run(batch, device_axis="ensemble", **STIFF)


def test_worker_exception_reaches_the_caller():
    """A failing slot's exception is raised in the caller, after every
    other slot has finished its work; a second failure is noted on it."""
    finished = []

    def fn(shard):
        if shard[0] == 2:
            raise FloatingPointError("slot 1 failed")
        if shard[0] == 4:
            raise KeyError("slot 2 failed")
        finished.append(int(shard[0]))
        return shard * 2

    with pytest.raises(FloatingPointError, match="slot 1 failed") as info:
        run_sharded_batch(fn, torch.arange(8), _cpu_mesh(4))
    assert sorted(finished) == [0, 6]
    assert any("KeyError" in n for n in info.value.__notes__)
    out = run_sharded_batch(lambda s: s * 2, torch.arange(8), _cpu_mesh(4))
    torch.testing.assert_close(out, torch.arange(8) * 2)


def test_launch_count_survives_threads():
    """The kernel wrappers count launches from the mesh's worker threads;
    with a short switch interval and more threads than cores, no count
    is lost."""
    old = sys.getswitchinterval()
    before = ros23_cuda.LAUNCHES
    n_threads, per_thread, join_s = 32, 2000, 60
    try:
        sys.setswitchinterval(1e-6)
        threads = [threading.Thread(target=lambda: [
            ros23_cuda.count_launch() for _ in range(per_thread)])
            for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=join_s)
        hung = sum(t.is_alive() for t in threads)
        assert not hung, (f"{hung} of {n_threads} count_launch threads "
                          f"still running after the {join_s} s join limit")
    finally:
        sys.setswitchinterval(old)
    assert ros23_cuda.LAUNCHES - before == n_threads * per_thread
    ros23_cuda.LAUNCHES = before
