"""MAP fitting + NUTS posterior sampling driver (port of
``Julia/param_fitting+inference_finitediff.jl``).

Counterpart of ``gab1_shp2_tpu/workloads/fit_and_infer.py``.

Stage 1: multistart LBFGS MAP fit of (kG1p, kG1dp, kSa, kSi) against
the 26.426% SHP2-bound-GAB1 datum -> ``fitted_parameters.csv``.
Stage 2: NUTS chains (the reference uses 5 chains x 1000 samples via
MCMCDistributed) -> posterior samples + quantile CSVs in the
reference's layout, for both the base cell (``--co base``) and the HeLa
abundances (``--co hela``).

Likelihood modes:

  * ``--likelihood surrogate`` (default): one chunked ensemble sweep
    fills a Chebyshev surrogate of the observable
    (``inference/surrogate.py``), or a surrogate ``.npz`` found in
    ``--outdir`` is reused; NUTS runs on the surrogate; every posterior
    draw is then re-evaluated with the exact PDE likelihood in batched
    solves and importance-reweighted.  Reported quantiles are exact up
    to the printed effective sample size.
  * ``--likelihood exact``: the reference's shape — one stiff PDE solve
    (+ forward-mode gradient) per leapfrog.  Hours per chain; kept for
    validation at small sample counts.

The solves and the chains run on the CUDA card (``--cpu``: everything
on the CPU).  ``--nuts-device cpu`` moves the chains, and the exact
likelihood's solves with them, to the CPU.

    python -m gab1_shp2_tpu_torch.workloads.fit_and_infer [--cpu] ...
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from gab1_shp2_tpu_torch.inference.diagnostics import check_chains
from gab1_shp2_tpu_torch.inference.loss import (
    FIT_NAMES,
    datum_loglik,
    make_batch_observable,
    make_log_posterior,
    make_observable_fn,
    prior_box,
)
from gab1_shp2_tpu_torch.inference.map_fit import map_fit
from gab1_shp2_tpu_torch.inference.nuts import (
    NUTSState,
    chain_generators,
    init as nuts_init,
    make_host_tree_sampler,
    sample,
    warmup_block,
    warmup_finalize,
)
from gab1_shp2_tpu_torch.inference.surrogate import (
    build_surrogate,
    importance_reweight,
    load_surrogate,
    save_surrogate,
    weighted_quantiles,
)
from gab1_shp2_tpu_torch.utils.cache import Checkpointer
from gab1_shp2_tpu_torch.workloads import common
from gab1_shp2_tpu_torch.workloads.common import to_numpy

QS = (0.025, 0.25, 0.5, 0.75, 0.975)


def _co_array(which: str, dev):
    import gab1_shp2_tpu_torch as g

    return (g.default_co(device=dev) if which == "base"
            else g.hela_co(device=dev))


def main(argv=None):
    ap = common.default_argparser(__doc__)
    ap.add_argument("--stage", choices=("map", "nuts", "both", "predictive"),
                    default="both")
    ap.add_argument("--co", choices=("base", "hela"), default="base")
    ap.add_argument("--likelihood", choices=("surrogate", "exact"),
                    default="surrogate")
    ap.add_argument("--grid-n", type=int, default=17,
                    help="surrogate Chebyshev nodes per dimension")
    ap.add_argument("--chains", type=int, default=5)
    ap.add_argument("--samples", type=int, default=1000)
    ap.add_argument("--warmup", type=int, default=500)
    ap.add_argument("--starts", type=int, default=101)
    ap.add_argument("--max-depth", type=int, default=8)
    ap.add_argument("--init-step", type=float, default=0.1)
    ap.add_argument("--predictive", type=int, default=0,
                    help="run prior/posterior predictive checks with "
                         "this many draws each "
                         "(param_fitting+inference_finitediff.jl:491-527)")
    ap.add_argument("--nuts-device", choices=("cpu", "cuda"), default=None,
                    help="where the NUTS chain loop runs (default: where"
                         " the solves run, the card unless --cpu).  On"
                         " the card each draw is its own block; with the"
                         " EXACT likelihood each leapfrog is a"
                         " batch-(chains) stiff solve with 4 tangents")
    ap.add_argument("--lp-f32", action="store_true",
                    help="exact likelihood in float32 state + float32"
                         " linear algebra.  The gradient field stays"
                         " deterministic, so leapfrog remains"
                         " reversible/volume-preserving and NUTS remains"
                         " exact — only efficiency, not correctness,"
                         " depends on gradient accuracy")
    args = ap.parse_args(argv)
    dev = common.device(args)
    # --cpu puts everything on the CPU, the chains included
    if dev.type == "cpu" or args.nuts_device is None:
        args.nuts_device = dev.type
    out = args.outdir
    os.makedirs(out, exist_ok=True)
    tag = "" if args.co == "base" else "_hela"
    Co = _co_array(args.co, dev)

    if args.stage == "predictive":
        # standalone predictive checks from a committed posterior
        # (param_fitting+inference_finitediff.jl:491-527): load
        # posterior_samples{tag}.csv written by an earlier nuts run
        samples_csv = f"{out}/posterior_samples{tag}.csv"
        arr = np.loadtxt(samples_csv, delimiter=",", skiprows=1)
        samples, w = arr[:, :4], arr[:, 4]
        # importance-resample by the exact-likelihood weights so the
        # predictive subsampling below sees an unweighted posterior
        w = w / w.sum()
        ridx = np.random.default_rng(args.seed + 77).choice(
            len(samples), size=len(samples), replace=True, p=w)
        samples = samples[ridx]
        print(f"predictive checks from {samples_csv} "
              f"({len(samples)} weighted posterior draws, resampled)")
        _predictive_checks(Co, samples, args, out, tag, dev)
        return

    x_map = None
    if args.stage in ("map", "both"):
        res = map_fit(device=dev, n_starts=args.starts, rtol=args.rtol,
                      dr_coarse=args.dr, dr_fine=args.dr / 2,
                      seed=args.seed + 123)
        print(f"MAP fit (loss {res.loss:.3e}):")
        for n in FIT_NAMES:
            print(f"  {n} = {res.values[n]:.6g}")
        common.save_csv(f"{out}/fitted_parameters.csv",
                        ["name", "value"],
                        [[n, res.values[n]] for n in FIT_NAMES])
        x_map = torch.as_tensor(res.log_k4, dtype=torch.float64)

    if args.stage not in ("nuts", "both"):
        return

    if x_map is None:
        # separate --stage nuts invocation: reuse a MAP fit written by
        # an earlier --stage map run (reference inits all chains at the
        # MAP point, param_fitting+inference_finitediff.jl:404)
        fit_csv = f"{out}/fitted_parameters.csv"
        if os.path.exists(fit_csv):
            import csv

            with open(fit_csv) as f:
                vals = {r["name"]: float(r["value"])
                        for r in csv.DictReader(f)}
            x_map = torch.log(torch.tensor([vals[n] for n in FIT_NAMES],
                                           dtype=torch.float64))
            print(f"chains init at MAP from {fit_csv}")
        else:
            x_map = torch.log(torch.tensor([0.42, 9.5, 0.42, 9.5],
                                           dtype=torch.float64))

    if args.likelihood == "surrogate":
        qs_all, div_all, ok, sur = _run_nuts_surrogate(args, Co, x_map, out,
                                                       tag, dev)
        if not ok:
            _fail_unhealthy(out, tag, qs_all)
        samples = _reweight_and_save(args, Co, qs_all, sur, out, tag, dev)
    else:
        qs_all, div_all, ok = _run_nuts_exact(args, Co, x_map, out, tag)
        if not ok:
            _fail_unhealthy(out, tag, qs_all)
        samples = np.exp(np.asarray(qs_all).reshape(-1, 4))
        _save_posterior(out, tag, samples, None)

    if args.predictive:
        _predictive_checks(Co, samples, args, out, tag, dev)


def _fail_unhealthy(out, tag, qs_all):
    """Chain-health gate failed: quarantine the draws under a _FAILED
    suffix and exit nonzero, so downstream consumers (the reweighting
    stage, a HeLa run triggered off posterior_quantiles.csv) cannot
    silently use unhealthy chains."""
    samples = np.exp(np.asarray(qs_all).reshape(-1, 4))
    common.save_csv(f"{out}/posterior_samples{tag}_FAILED.csv",
                    list(FIT_NAMES), [list(s) for s in samples])
    print(f"unhealthy chains quarantined to "
          f"posterior_samples{tag}_FAILED.csv; see "
          f"nuts_diagnostics{tag}.csv", file=sys.stderr)
    sys.exit(1)


def _nuts_device(args) -> torch.device:
    from gab1_shp2_tpu_torch.models.params import resolve_device

    return resolve_device(args.nuts_device)


def _gen_states(gens) -> dict:
    return {f"rng{c}": gen.get_state().numpy()
            for c, gen in enumerate(gens)}


def _restore_gens(saved, C: int):
    return tuple(torch.Generator().set_state(
        torch.as_tensor(saved[f"rng{c}"])) for c in range(C))


def _run_chains(lp, x_map, args, checkpoint_cfg, out, tag=""):
    """Warmup + block-sampled chains with checkpoint/resume.

    The chains are a leading axis of one state on ``--nuts-device``; each
    chain draws from its own CPU generator (seeds ``--seed``,
    ``--seed``+1, ...), whose state the checkpoint keeps.  On the card
    every draw is its own block (the exact likelihood's draws take
    seconds each), as the JAX package does on its accelerator.
    """
    ndev = _nuts_device(args)
    on_card = ndev.type == "cuda"
    block = 1 if on_card else max(1, min(100, args.samples))
    # warmup is checkpointed in blocks too: on the exact likelihood a
    # 200-step adaptation phase is itself multi-hour
    wblock = 1 if on_card else max(1, min(20, args.warmup))
    ck = Checkpointer("nuts_torch", checkpoint_cfg,
                      cache_dir=f"{out}/cache", every=60.0)
    saved = ck.restore()

    if on_card:
        host_draw = make_host_tree_sampler(
            lp, max_depth=args.max_depth, num_warmup=args.warmup,
            target_accept=0.65)

    if saved is None:
        q0 = x_map.to(device=ndev).expand(args.chains, -1).clone()
        state = nuts_init(lp, q0, chain_generators(args.seed, args.chains),
                          step_size=args.init_step)
        qs_blocks, div_blocks, done, wdone = [], [], 0, 0
    else:
        state = NUTSState.from_numpy(
            {f: saved[f] for f in NUTSState._fields if f != "rng"},
            _restore_gens(saved, args.chains), device=ndev)
        wdone = int(saved["wdone"])
        qs_blocks = [saved["qs"]] if "qs" in saved else []
        div_blocks = [saved["div"]] if "div" in saved else []
        done = int(saved["done"]) if "done" in saved else 0
        print(f"resumed NUTS at warmup {wdone}/{args.warmup}, "
              f"{done}/{args.samples} samples")

    def save_ckpt():
        ck.maybe_save({**state.to_numpy(), **_gen_states(state.rng),
                       "wdone": wdone, "done": done,
                       **({"qs": np.concatenate(qs_blocks, axis=1),
                           "div": np.concatenate(div_blocks, axis=1)}
                          if qs_blocks else {})})

    t_last = time.time()
    while wdone < args.warmup:
        if on_card:
            state, _ = host_draw(state, warm_t=wdone)
            wdone += 1
        else:
            nb = min(wblock, args.warmup - wdone)
            state = warmup_block(lp, state, wdone, num_block=nb,
                                 num_warmup=args.warmup,
                                 max_depth=args.max_depth,
                                 target_accept=0.65)
            wdone += nb
        if wdone >= args.warmup:
            # idempotent: safe if the process dies and re-applies it
            state = warmup_finalize(state)
        save_ckpt()
        if not on_card or wdone % 10 == 0 or wdone >= args.warmup:
            print(f"  warmup {wdone}/{args.warmup} "
                  f"({time.time() - t_last:.1f} s)", flush=True)
            t_last = time.time()

    while done < args.samples:
        if on_card:
            state, info = host_draw(state)
            qs_blocks.append(to_numpy(state.q)[:, None, :])
            div_blocks.append(to_numpy(info.diverged)[:, None])
            done += 1
        else:
            state, qs, info = sample(lp, state, num_samples=block,
                                     max_depth=args.max_depth)
            qs_blocks.append(to_numpy(qs))
            div_blocks.append(to_numpy(info["diverged"]))
            done += block
        save_ckpt()
        if not on_card or done % 10 == 0 or done >= args.samples:
            print(f"  {done}/{args.samples} samples "
                  f"({time.time() - t_last:.1f} s)", flush=True)
            t_last = time.time()
    ck.clear()

    qs_all = np.concatenate(qs_blocks, axis=1)[:, : args.samples]
    div_all = np.concatenate(div_blocks, axis=1)[:, : args.samples]
    print(f"NUTS: {args.chains}x{args.samples} samples, "
          f"{int(div_all.sum())} divergences")

    # sampler health gate (split R-hat / ESS / frozen-chain detection,
    # inference/diagnostics.py): record the verdict next to the
    # artifacts and refuse unhealthy output with a loud banner
    report = check_chains(qs_all, div_all, names=FIT_NAMES)
    common.save_csv(
        f"{out}/nuts_diagnostics{tag}.csv",
        ["param", "rhat", "ess"],
        [[n, report["rhat"][n], report["ess"][n]] for n in FIT_NAMES]
        + [["_divergence_rate", report["divergence_rate"], ""],
           ["_ok", int(report["ok"]), ""]])
    if not report["ok"]:
        print("!" * 64)
        print("NUTS HEALTH CHECK FAILED — do not use these samples:")
        for f in report["failures"]:
            print(f"  - {f}")
        print("!" * 64)
    else:
        worst = max(report["rhat"].values())
        print(f"NUTS health: ok (worst rhat {worst:.3f}, "
              f"min ess {min(report['ess'].values()):.0f})")
    return qs_all, div_all, bool(report["ok"])


def _run_nuts_surrogate(args, Co, x_map, out, tag, dev):
    sur_path = f"{out}/surrogate{tag}_n{args.grid_n}.npz"
    ndev = _nuts_device(args)
    if os.path.exists(sur_path):
        sur = load_surrogate(sur_path, device=ndev)
        print(f"loaded surrogate {sur_path}")
    else:
        lo, hi = prior_box()
        batch_obs = make_batch_observable(
            Co=Co, device=dev, dr=args.dr, rtol=args.rtol, method="rodas4",
            linsolve_dtype=torch.float32, max_steps=4000, chunk=args.chunk)
        print(f"building surrogate: {args.grid_n}^4 = "
              f"{args.grid_n**4} grid solves ...", flush=True)
        sur, grid_vals = build_surrogate(
            batch_obs, lo, hi, n=args.grid_n, chunk=args.chunk, device=ndev,
            progress=lambda i, n: print(f"  grid {i}/{n}", flush=True)
            if i % (args.chunk * 32) == 0 or i == n else None)
        save_surrogate(sur_path, sur, grid_vals)
        print(f"saved surrogate {sur_path}")

    lp = make_log_posterior(sur.y, wrap_vjp=False)
    cfg = {"surrogate": args.grid_n, "co": tag, "chains": args.chains,
           "warmup": args.warmup, "samples": args.samples,
           "seed": args.seed}
    qs_all, div_all, ok = _run_chains(lp, x_map, args, cfg, out, tag)
    return qs_all, div_all, ok, sur


def _run_nuts_exact(args, Co, x_map, out, tag):
    # rodas4 solves the same objective in ~2-3x fewer steps than the
    # trbdf2 default
    cfg = {"dr": args.dr, "rtol": args.rtol, "co": tag, "method": "rodas4",
           "chains": args.chains, "warmup": args.warmup,
           "samples": args.samples, "seed": args.seed}
    ndev = _nuts_device(args)
    Co = Co.to(device=ndev)
    if args.lp_f32:
        # f32 state + f32 linear algebra (see the --lp-f32 help text
        # for the exactness argument); a distinct checkpoint config
        Co = Co.to(torch.float32)
        x_map = x_map.to(torch.float32)
        cfg["lp_dtype"] = "f32"
        obs = make_observable_fn(Co=Co, device=ndev, dr=args.dr,
                                 rtol=args.rtol, method="rodas4",
                                 linsolve_dtype=torch.float32)
    else:
        obs = make_observable_fn(Co=Co, device=ndev, dr=args.dr,
                                 rtol=args.rtol, method="rodas4")
    lp = make_log_posterior(obs)
    return _run_chains(lp, x_map, args, cfg, out, tag)


def _reweight_and_save(args, Co, qs_all, sur, out, tag, dev):
    """Exact PDE likelihood at every draw -> importance weights + ESS."""
    Q = np.asarray(qs_all).reshape(-1, 4)
    print(f"exact reweighting pass: {len(Q)} PDE solves ...", flush=True)
    batch_obs = make_batch_observable(
        Co=Co, device=dev, dr=args.dr, rtol=1e-6, atol=1e-9,
        method="rodas4", linsolve_dtype=torch.float32, max_steps=40_000,
        chunk=args.chunk)
    y_exact = batch_obs(Q)
    # the surrogate evaluates a batch of draws in one call
    y_sur = to_numpy(sur.y(torch.as_tensor(Q, dtype=sur.coef.dtype,
                                           device=sur.coef.device)))
    ll_exact = to_numpy(datum_loglik(torch.as_tensor(y_exact)))
    ll_sur = to_numpy(datum_loglik(torch.as_tensor(y_sur)))
    w, ess = importance_reweight(ll_exact, ll_sur)

    ok = np.isfinite(y_exact)
    dlog = np.abs(np.log(np.maximum(y_exact[ok], 1e-12))
                  - np.log(np.maximum(y_sur[ok], 1e-12)))
    print(f"surrogate fidelity at draws: max|dlog y| = {dlog.max():.3g}, "
          f"p95 = {np.percentile(dlog, 95):.3g}; "
          f"exact-solve failures: {int((~ok).sum())}")
    print(f"importance ESS = {ess:.0f} / {len(Q)}")

    samples = np.exp(Q)
    _save_posterior(out, tag, samples, w, ess=ess)
    # importance-resample before returning: downstream consumers (the
    # inline --predictive subsampling) treat the return value as an
    # unweighted posterior, so hand them one — matching what the
    # standalone --stage predictive does from the committed CSV
    ridx = np.random.default_rng(args.seed + 77).choice(
        len(samples), size=len(samples), replace=True, p=w / w.sum())
    return samples[ridx]


def _save_posterior(out, tag, samples, w, ess=None):
    rows = [[*samples[i], (w[i] if w is not None else 1.0)]
            for i in range(len(samples))]
    common.save_csv(f"{out}/posterior_samples{tag}.csv",
                    list(FIT_NAMES) + ["weight"], rows)
    qrows = []
    for j, n in enumerate(FIT_NAMES):
        if w is None:
            q = np.quantile(samples[:, j], QS)
            mean = samples[:, j].mean()
        else:
            q = weighted_quantiles(samples[:, j], w, QS)
            mean = float(np.sum(w * samples[:, j]))
        qrows.append([n] + list(q) + [mean])
        print(f"  {n}: median {q[2]:.4g} [{q[0]:.4g}, {q[4]:.4g}]")
    hdr = ["param"] + [f"q{q}" for q in QS] + ["mean"]
    common.save_csv(f"{out}/posterior_quantiles{tag}.csv", hdr, qrows)
    if ess is not None:
        common.save_csv(f"{out}/posterior_ess{tag}.csv",
                        ["n_draws", "ess"], [[len(samples), ess]])


def predictive_draws(posterior_samples, m: int, seed: int):
    """The prior and posterior draws of the predictive checks: ``m``
    draws of the fitted parameters' lognormal priors and ``m`` rows of
    ``posterior_samples``, from ``default_rng(seed + 7)`` in the JAX
    package's order."""
    from gab1_shp2_tpu_torch.priors.literature import build_priors

    rng = np.random.default_rng(seed + 7)
    ln = build_priors().lognorm
    prior_draws = np.stack(
        [rng.lognormal(*ln[n]) for n in FIT_NAMES], axis=-1
    ) if m == 1 else np.stack(
        [rng.lognormal(ln[n][0], ln[n][1], size=m) for n in FIT_NAMES],
        axis=-1)
    post_idx = rng.choice(len(posterior_samples), size=m,
                          replace=m > len(posterior_samples))
    return prior_draws, posterior_samples[post_idx]


def _predictive_checks(Co, posterior_samples, args, out, tag, dev):
    """Prior and posterior predictive distributions of the observable
    (% SHP2-bound GAB1), mirroring the reference's predict() checks.
    The draws are solved as the lanes of batched stiff solves, with the
    single-member observable's configuration (trbdf2, tf=5, atol 1e-7)."""
    from gab1_shp2_tpu_torch.models.params import EXPTL_PCT_SHP2_BOUND_GAB1

    # --predictive 0 (the default) means "reference draw count" when the
    # predictive stage itself was requested (predict() uses 500;
    # param_fitting+inference_finitediff.jl:491-527)
    m = args.predictive or 500
    prior_draws, post_draws = predictive_draws(posterior_samples, m,
                                               args.seed)
    batch_obs = make_batch_observable(Co=Co, device=dev, dr=args.dr,
                                      rtol=args.rtol,
                                      chunk=min(args.chunk, 128))

    rows = []
    for label, draws in (("prior", prior_draws), ("posterior", post_draws)):
        y = batch_obs(np.log(np.atleast_2d(draws)))
        y = y[np.isfinite(y)]
        q = np.quantile(y, QS)
        rows.append([label] + list(q))
        print(f"{label} predictive %SHP2-bound GAB1: median {q[2]:.2f} "
              f"[{q[0]:.2f}, {q[4]:.2f}] (datum "
              f"{EXPTL_PCT_SHP2_BOUND_GAB1[0]})")
    common.save_csv(f"{out}/predictive_checks{tag}.csv",
                    ["which"] + [f"q{q}" for q in QS], rows)


if __name__ == "__main__":
    main()
