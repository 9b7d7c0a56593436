"""Tests of the port that need a CUDA card (marker ``gpu``).

They skip, inside a fixture, where ``torch.cuda.is_available()`` is
False.  This file imports neither jax nor the JAX package, so it runs on
a machine that has only the port's dependencies:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_gpu.py -q

(``--noconftest``: tests/conftest.py configures jax.)

Tolerances for the kernel against ros23_step_plain (f32): y1 relative
norm error <= 1e-4; f1 against the plain right-hand side evaluated at the
kernel's own y1 <= 1e-4 (the direct f1 comparison inherits y1's rounding
amplified by the stiff Jacobian); est within 1e-2 * max(1, |est_plain|)
in the solver's scaled norm (rtol 1e-4, atol 1e-7) — est is a difference
of three stage vectors, so its rounding scales with its own size.
"""

import numpy as np
import pytest
import torch

import gab1_shp2_tpu_torch as tg
from gab1_shp2_tpu_torch.ops import ros23_cuda
from gab1_shp2_tpu_torch.ops.batch_stiff import _SolverCtx, make_mol_rhs_lanes
from gab1_shp2_tpu_torch.ops.rhs import effective_diffusivities

pytestmark = pytest.mark.gpu

R, DR = 10.0, 0.5
NR = int(round(R / DR))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _step_args(system, dev, B, seed=0):
    rng = np.random.default_rng(seed)
    p0 = tg.default_params(device="cpu").pack().numpy()
    P = p0[None] * np.exp(rng.normal(0, 0.2, (B, 24)))
    p = tg.Params.unpack(torch.as_tensor(P, dtype=torch.float32, device=dev))
    y = torch.as_tensor(rng.uniform(0.1, 5.0, (NR, 10, B)),
                        dtype=torch.float32, device=dev)
    y[-1, 8:] = 0.0
    rhs, _ = make_mol_rhs_lanes(system, R, DR)
    f_n = rhs(y, p).contiguous()
    h = torch.as_tensor(np.logspace(-3, -1, B), dtype=torch.float32,
                        device=dev)
    d_eff = effective_diffusivities(system, p).contiguous()
    return (system, y, f_n, h, p.k.contiguous(), d_eff, NR, DR), rhs, p


@pytest.mark.parametrize("variant", ["base_system", "rect_system",
                                     "memb_sfk_system"])
def test_kernel_matches_plain(cuda, variant):
    system = getattr(tg, variant)()
    args, rhs, p = _step_args(system, cuda, B=37)  # a ragged last warp
    before = ros23_cuda.LAUNCHES
    yk, fk, ek = ros23_cuda.ros23_step_fused(*args)
    assert ros23_cuda.LAUNCHES == before + 1
    yp, fp, ep = ros23_cuda.ros23_step_plain(*args)
    torch.cuda.synchronize()
    for t in (yk, fk, ek):
        assert torch.isfinite(t).all()
    assert float((yk - yp).norm() / yp.norm()) <= 1e-4
    f_at_yk = rhs(yk, p)
    assert float((fk - f_at_yk).norm() / f_at_yk.norm()) <= 1e-4
    ctx = _SolverCtx(system, R, DR, 2, 1e-4, 1e-7, 1.0, torch.float32, cuda,
                     None, "rosenbrock23", "torch")
    # est: the per-lane error norms agree to 1e-2 of max(1, norm), so the
    # accept/reject decision moves only within 1% of its threshold (on
    # these rough random states the norms reach far above 1)
    errn_p = ctx.scaled_norm(ep, args[1], yp)
    diff = ctx.scaled_norm(ek - ep, args[1], yp)
    assert bool((diff <= 1e-2 * torch.clamp(errn_p, min=1.0)).all()), (
        diff, errn_p)


def test_wrapper_rejects_bad_inputs(cuda):
    args, _, _ = _step_args(tg.base_system(), cuda, B=8)
    bad = [
        (1, args[1].double(), "float32"),
        (1, args[1].transpose(0, 1).contiguous().transpose(0, 1),
         "contiguous"),
        (3, args[3].cpu(), "cpu"),
        (4, args[4][:, :16].contiguous(), "shape"),
    ]
    for i, value, match in bad:
        a = list(args)
        a[i] = value
        with pytest.raises(ValueError, match=match):
            ros23_cuda.ros23_step_fused(*a)
    a = list(args)
    a[6] = NR + 1
    with pytest.raises(ValueError, match="expected"):
        ros23_cuda.ros23_step_fused(*a)


def test_fused_solve_matches_unfused_on_card(cuda):
    rng = np.random.default_rng(5)
    p0 = tg.default_params(device="cpu").pack().numpy()
    P = p0[None] * np.exp(rng.normal(0, 0.1, (8, 24)))
    pb = tg.Params.unpack(torch.as_tensor(P, dtype=torch.float32))
    Co = tg.default_co(dtype=torch.float32, device="cpu")
    kw = dict(dr=1.0, tf=1.0, Nts=2, rtol=1e-4, atol=1e-7,
              method="rosenbrock23", return_stats=True)
    ros23_cuda.LAUNCHES = 0
    fus, sf = tg.solve_stiff_batch(tg.base_system(), Co, pb,
                                   step_impl="fused", **kw)
    assert fus.C.device.type == "cuda"
    assert ros23_cuda.LAUNCHES == int((sf.n_accepted + sf.n_rejected).max())
    ref, sr = tg.solve_stiff_batch(tg.base_system(), Co, pb,
                                   step_impl="torch", **kw)
    assert not sf.failed.any()
    Cr = ref.C[:, -1].double()
    err = float(((fus.C[:, -1].double() - Cr).abs()
                 / (Cr.abs() + 1e-6)).max())
    assert err < 2e-3


def test_default_device_is_the_card(cuda):
    assert tg.default_params().D.device.type == "cuda"
    assert tg.default_co().device.type == "cuda"
