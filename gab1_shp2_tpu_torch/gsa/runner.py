"""GSA runner: batched model evaluation + index estimation.

Counterpart of ``gab1_shp2_tpu/gsa/runner.py``.  Reproduces the
reference's eFAST workloads (``GSA_diffs+kinetic-params_MoL.jl``,
``GSA_concs.jl``): 6 summary outputs per sample, bounds = baseline x/÷1000
in log space for the 24 diffusivity+kinetic parameters, or x2e-4..x2 for
the 5 initial concentrations.  The batch of solves is one stiff ensemble
call per group or chunk; failed lanes contribute zeros
(``sapdesolver.jl:363-366``).

An evaluator takes and returns numpy arrays; the solves run on the
evaluator's ``device`` (``None``: the CUDA card).
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from gab1_shp2_tpu_torch.gsa.efast import (
    EFASTDesign,
    efast_design,
    efast_indices,
    log_bounds_around,
)
from gab1_shp2_tpu_torch.gsa.sobol import (
    SobolDesign,
    sobol_design,
    sobol_indices,
)
from gab1_shp2_tpu_torch.models.observables import gsa_outputs
from gab1_shp2_tpu_torch.models.params import Params, resolve_device
from gab1_shp2_tpu_torch.models.system import ReactionDiffusionSystem
from gab1_shp2_tpu_torch.ops.batch_stiff import (
    solve_stiff_batch,
    solve_stiff_refill,
)

GSA_VAR_NAMES = ("r_1/2, SFK", "r_1/10, SFK", "r_1/2, pG1S2",
                 "r_1/10, pG1S2", "[pG1S2]_cent:surf", "[pG1S2]_average")


def _make_evaluator(system, members, dev, dtype, *, R, dr, tf, rtol, atol,
                    chunk, method, max_steps, linsolve_dtype, scheduler):
    """The evaluator both public factories share.  ``members`` maps a
    (n, d) sample tensor to the ``(Co, batched Params)`` of its solves."""
    kw = dict(device=dev, R=R, dr=dr, tf=tf, Nts=2, rtol=rtol, atol=atol,
              method=method, max_steps=max_steps,
              linsolve_dtype=linsolve_dtype)

    if scheduler == "refill":
        def refill(X):
            Co, pb = members(X)
            out, ok, _ = solve_stiff_refill(
                system, Co, pb, extract=lambda sol: gsa_outputs(sol, R),
                **kw)
            return torch.where(ok[:, None], out, torch.zeros_like(out))

        return _refill_batch(refill, dev, dtype)
    if scheduler != "sorted":
        raise ValueError(f"unknown scheduler {scheduler!r}")

    def batch(X):
        Co, pb = members(X)
        sol, stats = solve_stiff_batch(system, Co, pb, return_stats=True,
                                       **kw)
        out = gsa_outputs(sol, R)
        ok = ~stats.failed & torch.isfinite(out).all(dim=-1)
        return torch.where(ok[:, None], out, torch.zeros_like(out))

    return _chunked_batch(batch, chunk, dev, dtype)


def make_param_evaluator(system: ReactionDiffusionSystem, Co, *,
                         device=None, R: float = 10.0, dr: float = 0.2,
                         tf: float = 5.0, rtol: float = 1e-4,
                         atol: float = 1e-7, chunk: int = 256,
                         method: str = "rodas4", dtype=None,
                         max_steps: int = 2000, linsolve_dtype=None,
                         scheduler: str = "refill",
                         ) -> Callable[[np.ndarray], np.ndarray]:
    """Batch evaluator over packed 24-parameter vectors -> (N, 6).

    ``max_steps`` caps the adaptive step count: eFAST bounds span six
    decades, and a few pathological corners of that box would otherwise
    dominate the wall-clock; capped-out lanes report zeros exactly like
    the reference's ``on_error=zeros(6)`` (``sapdesolver.jl:363-366``).

    ``scheduler="refill"`` (default) dispatches through the lane-refill
    scheduler, where a pathological corner stalls only its own lane;
    ``"sorted"`` is the proxy-sorted chunk dispatch (results agree to
    roundoff).  ``dtype`` overrides the compute dtype (default: that of
    ``Co``)."""
    dev = resolve_device(device)
    Co = torch.as_tensor(Co, device=dev)
    if dtype is not None:
        Co = Co.to(dtype)

    def members(X):
        return Co, Params.unpack(X)

    return _make_evaluator(system, members, dev, Co.dtype, R=R, dr=dr, tf=tf,
                           rtol=rtol, atol=atol, chunk=chunk, method=method,
                           max_steps=max_steps,
                           linsolve_dtype=linsolve_dtype,
                           scheduler=scheduler)


def make_conc_evaluator(system: ReactionDiffusionSystem, params: Params, *,
                        device=None, R: float = 10.0, dr: float = 0.2,
                        tf: float = 5.0, rtol: float = 1e-4,
                        atol: float = 1e-7, chunk: int = 256,
                        method: str = "rodas4", dtype=None,
                        max_steps: int = 2000, linsolve_dtype=None,
                        scheduler: str = "refill",
                        ) -> Callable[[np.ndarray], np.ndarray]:
    """Batch evaluator over initial-concentration 5-vectors -> (N, 6)
    (the concentration GSA, ``GSA_concs.jl``); options as in
    :func:`make_param_evaluator` (``dtype`` default: that of
    ``params``)."""
    dev = resolve_device(device)
    params = params.to(dtype=dtype, device=dev)

    def members(X):
        B = X.shape[0]
        return X, Params(D=params.D.expand(B, -1), k=params.k.expand(B, -1))

    return _make_evaluator(system, members, dev, params.D.dtype, R=R, dr=dr,
                           tf=tf, rtol=rtol, atol=atol, chunk=chunk,
                           method=method, max_steps=max_steps,
                           linsolve_dtype=linsolve_dtype,
                           scheduler=scheduler)


def _refill_batch(refill_fn, dev, dtype, group: int = 2048):
    """Dispatch an evaluator through the lane-refill scheduler, ``group``
    samples per solver call.

    No cost sorting needed: the refill queue packs lanes continuously,
    so a pathological corner only ever stalls its own lane.
    """

    def evaluate(X: np.ndarray) -> np.ndarray:
        Xd = torch.as_tensor(np.asarray(X), dtype=dtype, device=dev)
        outs = [refill_fn(Xd[s:s + group]).cpu().numpy()
                for s in range(0, Xd.shape[0], group)]
        return np.concatenate(outs, axis=0)

    return evaluate


def _chunked_batch(batch_fn, chunk: int, dev, dtype):
    """Chunked dispatch of an already-batched evaluator.

    ``batch_fn`` maps a (n, d) sample tensor to (n, 6) outputs in one
    batched solve."""

    def evaluate(X: np.ndarray) -> np.ndarray:
        Xh = np.asarray(X)
        # cost-sorted chunking: a batched adaptive solve runs lock-step,
        # so a chunk costs its *stiffest* member.  Sorting samples by a
        # stiffness proxy (total rate mass, which drives the step count)
        # makes chunks homogeneous and cuts the lock-step waste.
        if Xh.shape[1] == 24:
            cost = Xh[:, 7:].sum(axis=1)  # sum of kinetic rates
        else:
            cost = Xh.sum(axis=1)
        order = np.argsort(cost)
        Xs = torch.as_tensor(Xh[order], dtype=dtype, device=dev)
        outs = [batch_fn(Xs[s:s + chunk]).cpu().numpy()
                for s in range(0, Xs.shape[0], chunk)]
        sorted_out = np.concatenate(outs, axis=0)
        out = np.empty_like(sorted_out)
        out[order] = sorted_out
        return out

    return evaluate


def run_efast(evaluate: Callable[[np.ndarray], np.ndarray],
              bounds: np.ndarray, *, samples: int = 1000,
              num_harmonics: int = 4, log_space: bool = True,
              resamples: int = 1,
              seed: int = 123) -> Tuple[np.ndarray, np.ndarray, EFASTDesign]:
    """Full eFAST sweep: design -> batched evaluation -> (S1, ST).

    ``resamples > 1`` draws that many random-phase search curves per
    parameter and pools their spectra (see
    :func:`gab1_shp2_tpu_torch.gsa.efast.efast_indices`), cutting
    estimator variance at proportionally more model evaluations."""
    design = efast_design(bounds, samples, num_harmonics=num_harmonics,
                          log_space=log_space, resamples=resamples,
                          rng=np.random.default_rng(seed))
    Y = evaluate(design.X)
    _log_dropped(Y)
    S1, ST = efast_indices(Y, design, num_harmonics=num_harmonics)
    return S1, ST, design


def _log_dropped(Y: np.ndarray) -> None:
    """No silent caps: failed samples enter the spectra as zeros (the
    reference's on_error=zeros idiom) and bias the indices if numerous —
    always report how many were dropped."""
    zero = float((np.abs(np.asarray(Y)).sum(axis=-1) == 0).mean())
    if zero > 0:
        print(f"[gsa] {zero:.1%} of model evaluations failed/capped and "
              f"enter the estimator as zeros")


def run_sobol(evaluate: Callable[[np.ndarray], np.ndarray],
              bounds: np.ndarray, *, n: int = 512, log_space: bool = True,
              seed: int = 123) -> Tuple[np.ndarray, np.ndarray, SobolDesign]:
    """Full Sobol sweep with Saltelli sampling and Jansen estimators."""
    design = sobol_design(bounds, n, log_space=log_space, seed=seed)
    Y = evaluate(design.X)
    _log_dropped(Y)
    S1, ST = sobol_indices(Y, design)
    return S1, ST, design


def dk_bounds(params: Params, factor: float = 1000.0) -> np.ndarray:
    """Diffusivity+kinetics bounds, baseline x/÷1000
    (``GSA_diffs+kinetic-params_MoL.jl:68-74``)."""
    return log_bounds_around(params.pack().detach().cpu().numpy(), factor)


def conc_bounds(Co, lo: float = 2e-4, hi: float = 2.0) -> np.ndarray:
    """Concentration bounds x2e-4 .. x2 (``GSA_concs.jl:62-71``)."""
    co = (Co.detach().cpu().numpy() if torch.is_tensor(Co)
          else np.asarray(Co)).astype(float)
    return np.stack([co * lo, co * hi], axis=1)
