"""Parameter-ensemble engine for one device.

Counterpart of ``gab1_shp2_tpu/ensemble/engine.py``.  The reference
batches independent PDE solves over parameter sets with threads, ``pmap``
and ``MCMCDistributed`` (``get_param_posteriors.jl:147``,
``sapdesolver.jl:323``); here one batched solver call per chunk or refill
group does it.

Failure isolation is masking, not try/catch: members whose solve produced
NaN (or whose stiff integration failed) are dropped from summaries the
way the reference skips NaN samples (``get_param_posteriors.jl:155``).

Left out against the JAX package, on purpose: the chunk caps that guard
its accelerator runtime's single-execution watchdog (they fire on that
platform only), the ``jit``/``lru_cache`` of compiled chunk solvers
(eager torch has nothing to cache), and the sharded ``device_axis``/
``mesh`` path, which raises ``NotImplementedError`` (ROADMAP A13).
Passing ``scheduler`` with a solver other than ``"stiff"`` raises
``ValueError`` here; the JAX package ignores it.
"""

from __future__ import annotations

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
    """
    if device_axis is not None or mesh is not None:
        raise NotImplementedError(
            "device_axis/mesh sharding is not ported yet (ROADMAP A13)")
    if solver not in ("stiff", "explicit"):
        raise ValueError(f"unknown solver {solver!r}")
    if scheduler is not None and solver != "stiff":
        raise ValueError(
            f"scheduler={scheduler!r} applies to solver='stiff' only, got "
            f"solver={solver!r}")
    dev = resolve_device(device)
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
                                     refill_group, dev, kw)
        if scheduler != "sorted":
            raise ValueError(f"unknown scheduler {scheduler!r}")

        def chunk_solver(idx):
            # a per-member Co (N, 5) gives each chunk its own rows; the
            # JAX package hands every chunk the whole array and raises
            co = Co if Co.ndim == 1 or idx is None else Co[idx]
            p = pb if idx is None else _take(pb, idx)
            sol, stats = solve_stiff_batch(system, co, p, device=dev,
                                           return_stats=True,
                                           jac_reuse=jac_reuse, **kw)
            out = _extract_members(extract, sol)
            ok = ~stats.failed & torch.isfinite(sol.C[:, -1]).all(
                dim=-1).all(dim=-1)
            return out, ok, stats.n_accepted + stats.n_rejected

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


def _run_stiff_refill(system, Co, pb, N, extract, chunk, refill_group, dev,
                      kw):
    """Dispatch the stiff ensemble through the lane-refill scheduler: one
    ``solve_stiff_refill`` call per ``refill_group`` members (default
    4096) over ``chunk`` lanes (default 256), and no more lanes than
    members: eager operations pay for every lane, an idle one too (the
    JAX package keeps ``chunk`` lanes, the idle ones masked)."""
    lanes = min(int(chunk) if chunk is not None else 256, N)
    group = max(int(refill_group) if refill_group is not None else 4096,
                lanes)
    co_shared = Co.ndim == 1
    outs = []
    for s in range(0, N, group):
        p_g = _take(pb, slice(s, s + group))
        Co_g = Co if co_shared else Co[s:s + group]
        out, ok, _ = solve_stiff_refill(system, Co_g, p_g, extract=extract,
                                        device=dev, lanes=lanes, **kw)
        outs.append((out, ok))
    return _cat(outs)


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
