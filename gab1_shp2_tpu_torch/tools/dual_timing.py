"""Wall time of the port's two uses of its dual numbers
(``ops/fwdgrad.FwdDual``): the Jacobian bands of the eager ensemble step,
and the log posterior's gradient through the single-member stiff solve,
the latter beside ``torch.func``'s forward mode.

Prints one JSON line:

  * ``bands_ms``: ``fast_block_jacobian_lanes`` at B=256 lanes, f32
    state, dr=0.2 (the eager RODAS4 step's band build), median of 20
    CUDA-event-timed calls;
  * ``value_s``, ``dual_grad_s``, ``func_grad_s``: at the fit
    configuration (dr=0.2, tf=5, rtol 1e-4, atol 1e-7, f64, trbdf2;
    ``--dr``/``--tf``/``--method`` change it), at the prior modes, one
    value solve, one value and gradient by
    ``ops/fwdgrad.value_and_fwd_grad`` (what
    ``inference/loss.reverse_differentiable`` runs) and one by
    ``torch.func.vmap`` of ``torch.func.jvp`` over the basis (skipped
    with ``--no-func``); the two gradients must agree.

    python -m gab1_shp2_tpu_torch.tools.dual_timing          # the card
    python -m gab1_shp2_tpu_torch.tools.dual_timing --device cpu --dr 1
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

import gab1_shp2_tpu_torch as tg
from gab1_shp2_tpu_torch.bench import card_line
from gab1_shp2_tpu_torch.inference import loss
from gab1_shp2_tpu_torch.models.params import resolve_device
from gab1_shp2_tpu_torch.ops.fwdgrad import value_and_fwd_grad
from gab1_shp2_tpu_torch.ops.jacobian import fast_block_jacobian_lanes

MODES = (0.42, 9.5, 0.42, 9.5)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _wall(fn, dev):
    _sync(dev)
    t = time.perf_counter()
    out = fn()
    _sync(dev)
    return out, time.perf_counter() - t


def bands_ms(dev, lanes=256, dr=0.2, reps=20):
    """Median ms of one band build at a perturbed initial state."""
    system = tg.base_system()
    Nr = int(round(10.0 / dr))
    p = tg.default_params(dtype=torch.float32, device=dev)
    pb = tg.Params(D=p.D.expand(lanes, -1), k=p.k.expand(lanes, -1))
    gen = torch.Generator(device="cpu").manual_seed(0)
    y = (1.0 + torch.rand((Nr, 10, lanes), generator=gen)).to(dev)
    r = torch.arange(Nr + 1, dtype=torch.float64) * dr
    times = []
    for i in range(reps + 2):
        _, t = _wall(lambda: fast_block_jacobian_lanes(system, y, pb, r, dr),
                     dev)
        if i >= 2:
            times.append(t * 1e3)
    return statistics.median(times)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--dr", type=float, default=0.2)
    ap.add_argument("--tf", type=float, default=5.0)
    ap.add_argument("--method", default="trbdf2")
    ap.add_argument("--no-func", action="store_true")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out = dict(device=str(dev), card=None, bands_ms=bands_ms(dev))
    if dev.type == "cuda":
        out["card"] = card_line()

    obs = loss.make_observable_fn(device=dev, dr=args.dr, tf=args.tf,
                                  rtol=1e-4, atol=1e-7, method=args.method)
    lp = loss.make_log_posterior(obs, wrap_vjp=False)
    q = torch.log(torch.tensor(MODES, dtype=torch.float64, device=dev))
    lp(q)  # first call: scripted helpers, allocator
    _, out["value_s"] = _wall(lambda: lp(q), dev)
    (v_d, g_d), out["dual_grad_s"] = _wall(
        lambda: value_and_fwd_grad(lp, q), dev)
    out.update(dr=args.dr, tf=args.tf, method=args.method,
               func_grad_s=None)
    if not args.no_func:
        eye = torch.eye(4, dtype=q.dtype, device=dev)
        (v_f, g_f), out["func_grad_s"] = _wall(
            lambda: torch.func.vmap(
                lambda t: torch.func.jvp(lp, (q,), (t,)),
                out_dims=(None, 0))(eye), dev)
        err = float((g_d - g_f).abs().max() / g_f.abs().max())
        if not err < 1e-10 or float(v_d) != float(v_f):
            raise SystemExit(f"gradients disagree: rel {err:.3g}")
        out["func_over_dual"] = out["func_grad_s"] / out["dual_grad_s"]
    print(json.dumps(out))


if __name__ == "__main__":
    main()
