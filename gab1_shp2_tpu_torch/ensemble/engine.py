"""Parameter-ensemble engine.

Counterpart of ``gab1_shp2_tpu/ensemble/engine.py``.  The reference
batches independent PDE solves over parameter sets with threads, ``pmap``
and ``MCMCDistributed`` (``get_param_posteriors.jl:147``,
``sapdesolver.jl:323``); here one batched solver call per chunk or refill
group does it, and with ``device_axis`` one such call per slot of a
device mesh (``parallel/mesh.py``), each on its own worker thread.

Failure isolation is masking, not try/catch: members whose solve produced
NaN (or whose stiff integration failed) are dropped from summaries the
way the reference skips NaN samples (``get_param_posteriors.jl:155``).

Left out against the JAX package, on purpose: the chunk caps that guard
its accelerator runtime's single-execution watchdog (they fire on that
platform only) and the ``jit``/``lru_cache`` of compiled chunk solvers
(eager torch has nothing to cache).  Passing ``scheduler`` with a solver
other than ``"stiff"`` raises ``ValueError`` here; the JAX package
ignores it.

With ``utils.progress``'s recorder on, a call of :func:`run_ensemble` is
a ``request`` span (and counts its ``members`` and ``members_failed``),
and each ``solve_stiff_refill`` call of the refill dispatch a ``group``
span under it.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from gab1_shp2_tpu_torch.models.params import (
    Params,
    resolve_device,
    stability_dt,
)
from gab1_shp2_tpu_torch.models.system import ReactionDiffusionSystem
from gab1_shp2_tpu_torch.ops.batch_stiff import (
    solve_stiff_batch,
    solve_stiff_refill,
)
from gab1_shp2_tpu_torch.ops.explicit import solve_explicit
from gab1_shp2_tpu_torch.ops.solution import Solution
from gab1_shp2_tpu_torch.parallel.mesh import (
    ensemble_mesh,
    normalize_device,
    pad_to_multiple,
    run_sharded_batch,
)
from gab1_shp2_tpu_torch.utils import progress


def _identity(sol):
    return sol


def _take(pb: Params, idx) -> Params:
    return Params(D=pb.D[idx], k=pb.k[idx])


def _cat(outs):
    """Concatenate a list of (out pytree, ok) pairs along the member axis."""
    return pytree.tree_map(lambda *xs: torch.cat(xs, dim=0), *outs)


def _extract_members(extract: Callable, sol: Solution):
    """Apply ``extract`` to every member of a batched :class:`Solution`
    whose ``t`` and ``r`` may be shared."""
    B = sol.C.shape[0]
    sol = sol._replace(
        t=sol.t if sol.t.ndim == 2 else sol.t.expand(B, -1),
        r=sol.r if sol.r.ndim == 2 else sol.r.expand(B, -1))
    return torch.func.vmap(extract)(sol)


def _recorded(run):
    """``run`` as one ``request`` span when the recorder is on, which
    counts the members and those returned not valid."""

    @functools.wraps(run)
    def request(*args, **kwargs):
        rec = progress.RECORDER
        if rec is None:
            return run(*args, **kwargs)
        with rec.span(progress.REQUEST):
            out, valid = run(*args, **kwargs)
            failed = int((~valid).sum())
        rec.count(members=valid.numel(), members_failed=failed)
        return out, valid

    return request


@_recorded
def run_ensemble(
    system: ReactionDiffusionSystem,
    Co,
    ensemble,  # (N, 24) packed array or batched Params
    *,
    solver: str = "stiff",
    extract: Callable = _identity,
    device=None,
    R: float = 10.0,
    dr: float = 0.2,
    tf: float = 5.0,
    Nts: int = 100,
    rtol: float = 1e-4,
    atol: float = 1e-7,
    tol: float = 1e-4,
    maxiters: int = 20,
    t_prechase: Optional[float] = None,
    chunk: Optional[int] = None,
    device_axis: Optional[str] = None,
    mesh=None,
    method: str = "rodas4",
    linsolve_dtype=None,
    max_steps: int = 20_000,
    jac_reuse=None,
    scheduler: Optional[str] = None,
    refill_group: Optional[int] = None,
):
    """Solve the PDE for every ensemble member.

    Mirrors ``run_ensemble`` / ``run_ensemble_pc``
    (``get_param_posteriors.jl:135-236``): defaults dr=0.2, tol=1e-4,
    maxiters=20, Nts=100.  ``extract`` maps one member's
    :class:`Solution` to whatever should be kept (default: everything);
    it is applied over members with ``torch.func.vmap``.  Keeping only
    reduced summaries is how 10k-member ensembles stay in device memory.
    ``device=None`` runs on the CUDA card (and raises if there is none).

    Returns ``(out, valid)``: the stacked extracted pytree with leading
    ensemble axis, and a boolean mask of members that completed with
    finite output.

    ``chunk`` bounds peak memory by solving member chunks in turn.

    ``scheduler`` picks the stiff dispatch strategy: ``"sorted"``
    (pilot-fit cost-sorted chunking) or ``"refill"`` (lane-refill
    continuation batching, ``ops.batch_stiff.solve_stiff_refill``: one
    solver call per ``refill_group`` members over ``chunk`` lanes, with
    finished lanes swapped for queued ones in flight).  Default
    (``None``): refill.  Per-member results are controller-identical
    between schedulers (exact step counts; values to float roundoff).

    ``device_axis`` (the axis name of a 1-D ``parallel.mesh.DeviceMesh``,
    e.g. ``"ensemble"``) shards the stiff ensemble over the mesh's slots,
    one worker thread each: under ``"refill"`` every slot runs its own
    refill queue over its shard of each group of ``refill_group`` members
    per slot; under ``"sorted"`` every dispatch solves a super-chunk of
    ``slots * chunk`` members, ``chunk`` per slot, with the pilot fit
    over the whole first super-chunk.  ``mesh=None`` means
    ``ensemble_mesh()``, every CUDA card.  The inputs and outputs live on
    ``mesh.devices[0]`` (``device``, if given, must name it); a
    per-member ``Co`` is sharded with the members.  Per-member results
    do not depend on the sharding.  ``mesh`` is read only with
    ``device_axis``, as in the JAX package.
    """
    if solver not in ("stiff", "explicit"):
        raise ValueError(f"unknown solver {solver!r}")
    if scheduler is not None and solver != "stiff":
        raise ValueError(
            f"scheduler={scheduler!r} applies to solver='stiff' only, got "
            f"solver={solver!r}")
    if device_axis is None:
        mesh = None
        dev = resolve_device(device)
    else:
        if solver != "stiff":
            raise NotImplementedError(
                "device_axis sharding is implemented for solver='stiff' (the "
                "production ensemble path); the explicit solver is single-"
                "device: drop device_axis or use solver='stiff'")
        mesh = _resolve_mesh(mesh, device_axis)
        dev = mesh.devices[0]
        if (device is not None
                and normalize_device(resolve_device(device)) != dev):
            raise ValueError(f"device={device!r} is not the mesh's first "
                             f"device {dev}, where the outputs gather")
    Co = torch.as_tensor(Co, device=dev)
    if isinstance(ensemble, Params):
        pb = ensemble.to(device=dev)
    else:
        pb = Params.unpack(torch.as_tensor(ensemble, device=dev))
    N = pb.k.shape[0]

    if solver == "stiff":
        kw = dict(R=R, dr=dr, tf=tf, Nts=Nts, rtol=rtol, atol=atol,
                  method=method, linsolve_dtype=linsolve_dtype,
                  max_steps=max_steps, t_prechase=t_prechase)
        if scheduler is None:
            # jac_reuse's refresh votes are collective over a chunk, so
            # it needs fixed chunk membership
            scheduler = "sorted" if jac_reuse else "refill"
        if scheduler == "refill":
            if jac_reuse:
                raise ValueError(
                    "scheduler='refill' is incompatible with jac_reuse "
                    "(collective refresh votes need fixed chunk "
                    "membership); use scheduler='sorted'")
            return _run_stiff_refill(system, Co, pb, N, extract, chunk,
                                     refill_group, kw, mesh=mesh)
        if scheduler != "sorted":
            raise ValueError(f"unknown scheduler {scheduler!r}")

        def solve_chunk(co, p):
            sol, stats = solve_stiff_batch(system, co, p, device=p.k.device,
                                           return_stats=True,
                                           jac_reuse=jac_reuse, **kw)
            out = _extract_members(extract, sol)
            ok = ~stats.failed & torch.isfinite(sol.C[:, -1]).all(
                dim=-1).all(dim=-1)
            return out, ok, stats.n_accepted + stats.n_rejected

        if mesh is not None:
            return _run_stiff_sharded(solve_chunk, Co, pb, N, chunk, mesh,
                                      sort=not jac_reuse)

        def chunk_solver(idx):
            # a per-member Co (N, 5) gives each chunk its own rows; the
            # JAX package hands every chunk the whole array and raises
            co = Co if Co.ndim == 1 or idx is None else Co[idx]
            return solve_chunk(co, pb if idx is None else _take(pb, idx))

        if chunk is None or chunk >= N:
            return chunk_solver(None)[:2]
        return _run_stiff_cost_sorted(chunk_solver, pb, N, int(chunk),
                                      sort=not jac_reuse)

    # explicit: per-member stability dt with a shared step count
    # (reference semantics, basepdesolver.jl:30)
    dts = stability_dt(pb, dr)

    def solve_members(p: Params, dt_m, n_steps: int):
        nt_m = torch.ceil(tf / dt_m).to(torch.int64)
        sol = solve_explicit(system, Co, p, device=dev, R=R, dr=dr, tf=tf,
                             Nts=Nts, dt=dt_m, n_steps=n_steps,
                             nt_active=nt_m, maxiters=maxiters, tol=tol,
                             t_prechase=t_prechase)
        out = _extract_members(extract, sol)
        ok = torch.isfinite(sol.C[:, -1]).all(dim=-1).all(dim=-1)
        return out, ok

    if chunk is not None and chunk < N:
        return _run_explicit_grouped(solve_members, pb, dts, tf, int(chunk),
                                     N)
    n_steps = int(np.ceil(tf / float(dts.min())))
    return solve_members(pb, dts, n_steps)


def _resolve_mesh(mesh, device_axis):
    """The mesh a sharded run uses: ``mesh``, or every CUDA card."""
    if mesh is None:
        return ensemble_mesh(axis=device_axis)
    if device_axis not in mesh.axis_names:
        raise ValueError(f"device_axis {device_axis!r} not in mesh axes "
                         f"{mesh.axis_names}")
    return mesh


def _on_mesh(fn, Co, p: Params, mesh):
    """``fn(Co_s, p_s)`` on every slot of ``mesh`` over its shard of the
    members (and of a per-member ``Co``), gathered on the first device.
    The member count must be a multiple of the slot count."""
    if Co.ndim == 1:
        return run_sharded_batch(
            lambda a: fn(Co.to(a[0].device), Params(D=a[0], k=a[1])),
            (p.D, p.k), mesh)
    return run_sharded_batch(lambda a: fn(a[0], Params(D=a[1], k=a[2])),
                             (Co, p.D, p.k), mesh)


def _run_stiff_refill(system, Co, pb, N, extract, chunk, refill_group, kw,
                      mesh=None):
    """Dispatch the stiff ensemble through the lane-refill scheduler: one
    ``solve_stiff_refill`` call per ``refill_group`` members (default
    4096) over ``chunk`` lanes (default 256), and no more lanes than
    members: eager operations pay for every lane, an idle one too (the
    JAX package keeps ``chunk`` lanes, the idle ones masked).

    With a ``mesh`` of D slots each group holds ``refill_group * D``
    members; the tail group is padded to a multiple of D (repeating its
    last member, sliced off after), and every slot runs its own refill
    queue over its shard, with no more lanes than the shard's members.
    """
    lanes = int(chunk) if chunk is not None else 256
    group = max(int(refill_group) if refill_group is not None else 4096,
                min(lanes, N))
    co_shared = Co.ndim == 1
    # a mesh's worker threads record their groups under the caller's span
    rec = progress.RECORDER
    up = None if rec is None else rec.current()

    def solve_group(co, p):
        with (progress.NULL if rec is None
              else rec.span("group", parent=up)):
            out, ok, _ = solve_stiff_refill(system, co, p, extract=extract,
                                            device=p.k.device,
                                            lanes=min(lanes, p.k.shape[0]),
                                            **kw)
        return out, ok

    D = 1 if mesh is None else mesh.size
    group *= D
    outs = []
    for s in range(0, N, group):
        p_g = _take(pb, slice(s, s + group))
        Co_g = Co if co_shared else Co[s:s + group]
        if mesh is None:
            outs.append(solve_group(Co_g, p_g))
            continue
        # shards must be equal-size: pad the tail group to a multiple of
        # D, slice the repeats off below
        (D_g, k_g), n_g = pad_to_multiple((p_g.D, p_g.k), D)
        if not co_shared:
            Co_g, _ = pad_to_multiple(Co_g, D)
        out, ok = _on_mesh(solve_group, Co_g, Params(D=D_g, k=k_g), mesh)
        outs.append(pytree.tree_map(lambda a: a[:n_g], (out, ok)))
    return _cat(outs)


def _run_stiff_sharded(solve_chunk, Co, pb, N, chunk, mesh, sort=True):
    """Dispatch the stiff ensemble over a device mesh under the sorted
    scheduler: every dispatch solves a super-chunk of ``D * chunk``
    members (``chunk`` per slot, default ``ceil(N / D)``), scheduled by
    the same pilot-fit cost sorting as the single-device path (the pilot
    is the whole first super-chunk).  The members are padded to a
    multiple of the super-chunk (repeating the last one, as the pilot
    indexing needs), and the padding is sliced off at the end."""
    D = mesh.size
    c = int(chunk) if chunk is not None else -(-N // D)
    super_chunk = D * c
    pad = (-N) % super_chunk
    (D_p, k_p), _ = pad_to_multiple((pb.D, pb.k), super_chunk)
    pb = Params(D=D_p, k=k_p)
    if Co.ndim == 2:
        Co, _ = pad_to_multiple(Co, super_chunk)

    def chunk_solver(idx):
        idx_t = torch.as_tensor(idx, device=pb.k.device)
        co = Co if Co.ndim == 1 else Co[idx_t]
        return _on_mesh(solve_chunk, co, _take(pb, idx_t), mesh)

    out, ok = _run_stiff_cost_sorted(chunk_solver, pb, N + pad, super_chunk,
                                     sort=sort)
    if pad:
        out, ok = pytree.tree_map(lambda a: a[:N], (out, ok))
    return out, ok


def _run_stiff_cost_sorted(chunk_solver, pb, N, chunk, sort=True):
    """Chunked stiff dispatch with pilot-fit cost-sorted scheduling;
    ``chunk_solver`` takes the member indices of one chunk.

    A batched adaptive integration runs until its slowest lane finishes,
    so a chunk costs its max-step member.  No fixed stiffness proxy
    predicts a posterior member's cost, so the schedule is learned on the
    fly: solve the first chunk as a pilot, ridge-fit log(steps) ~
    log(params) on its lanes, and solve the remaining members in
    predicted-cost order.  Per-lane results do not depend on chunk
    membership (lanes step independently; finished lanes idle), so
    reordering never changes results — except under ``jac_reuse``, whose
    band refreshes are collective per chunk: ``sort=False`` keeps the
    original in-order chunking there.
    """
    pilot_idx = np.arange(chunk)
    out_p, ok_p, steps_p = chunk_solver(pilot_idx)

    rest = np.arange(chunk, N)
    if sort and rest.size:
        packed = pb.pack().detach().cpu().numpy().astype(np.float64)
        X = np.log(np.maximum(packed, 1e-300))
        A = np.column_stack([X[pilot_idx], np.ones(chunk)])
        y = np.log(np.maximum(steps_p.cpu().numpy().astype(np.float64), 1.0))
        try:
            coef = np.linalg.solve(A.T @ A + 1e-3 * np.eye(A.shape[1]),
                                   A.T @ y)
            pred = np.column_stack([X[rest], np.ones(rest.size)]) @ coef
            if np.isfinite(pred).all():
                rest = rest[np.argsort(pred, kind="stable")]
        except np.linalg.LinAlgError:
            pass  # keep the original order

    order = np.concatenate([pilot_idx, rest])
    pad = (-N) % chunk
    sched = np.concatenate([order, np.repeat(order[-1:], pad)])
    outs = [(out_p, ok_p)]
    for s in range(chunk, len(sched), chunk):
        o, k, _ = chunk_solver(sched[s:s + chunk])
        outs.append((o, k))
    # rows 0..N-1 of the concatenation hold members order[0..N-1] (pad
    # duplicates sit past N); invert the permutation
    inv = np.empty(N, np.int64)
    inv[order] = np.arange(N)
    inv_t = torch.as_tensor(inv, device=pb.k.device)
    return pytree.tree_map(lambda a: a[:N][inv_t], _cat(outs))


def _run_explicit_grouped(solve_members, pb, dts, tf, chunk, N):
    """Chunked explicit ensemble with per-chunk step counts.

    Members are sorted by stability dt (descending: cheap first) so each
    chunk's shared ``n_steps`` is set by *its own* stiffest member, not
    the global one.  Step counts are rounded up to a geometric (ratio-2)
    grid, as in the JAX package; the extra steps a round-up adds run
    masked (``nt_active``)."""
    dts_host = dts.cpu().numpy()
    order = np.argsort(-dts_host, kind="stable")
    inv = np.empty_like(order)
    inv[order] = np.arange(N)
    outs = []
    for s in range(0, N, chunk):
        idx = torch.as_tensor(order[s:s + chunk], device=dts.device)
        dt_min = dts_host[order[min(s + chunk, N) - 1]]
        n_raw = int(np.ceil(tf / float(dt_min)))
        n_chunk = 1 << max(0, int(np.ceil(np.log2(max(1, n_raw)))))
        outs.append(solve_members(_take(pb, idx), dts[idx], n_chunk))
    inv_t = torch.as_tensor(inv, device=dts.device)
    return pytree.tree_map(lambda a: a[inv_t], _cat(outs))


def masked_quantiles(values: torch.Tensor, valid: torch.Tensor,
                     qs=(0.159, 0.5, 0.841)) -> torch.Tensor:
    """Quantiles over the ensemble axis (axis 0) ignoring invalid members.

    Used for the median / 68% credible-interval summary surfaces of the
    analysis scripts (``run_base_model.jl:99-175``).
    """
    v = torch.where(valid.reshape((-1,) + (1,) * (values.ndim - 1)),
                    values, torch.nan)
    q = torch.as_tensor(qs, dtype=values.dtype, device=values.device)
    return torch.nanquantile(v, q, dim=0)
