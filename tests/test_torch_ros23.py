"""The fused Rosenbrock23 step's plain version against the JAX Pallas
kernel (interpret mode on the CPU), and the wrapper's CPU dispatch.

Tolerance for ros23_step_plain vs ros23_pallas.ros23_step_fused
(f32, dr=1, B=4): relative norm error <= 1e-5 for y1 and f1 and <= 1e-4
for est.  The two differ in the Laplacian form (the Pallas kernel uses
up-2uc+um, the port the production (up-uc)-(uc-um)) and in f32 op order
throughout the factor and solves; measured ~1e-7 (y1, f1) and ~1e-6 (est,
a difference of three stage vectors).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gab1_shp2_tpu as jg
from gab1_shp2_tpu.models.params import Params as JParams
from gab1_shp2_tpu.ops.rhs import effective_diffusivities as j_eff
from gab1_shp2_tpu.ops.ros23_pallas import ros23_step_fused as j_fused

import gab1_shp2_tpu_torch as tg
from gab1_shp2_tpu_torch.models.params import Params as TParams
from gab1_shp2_tpu_torch.ops import ros23_cuda
from gab1_shp2_tpu_torch.ops.rhs import effective_diffusivities as t_eff

torch.set_num_threads(2)

B, R, DR = 4, 10.0, 1.0
NR = int(round(R / DR))


def _inputs(seed):
    rng = np.random.default_rng(seed)
    p0 = np.asarray(jg.default_params().pack())
    P = (p0[None] * np.exp(rng.normal(0, 0.2, (B, 24)))).astype(np.float32)
    y = rng.uniform(0.1, 5.0, (NR, 10, B)).astype(np.float32)
    f_n = rng.normal(0.0, 1.0, (NR, 10, B)).astype(np.float32)
    h = np.full(B, 0.01, np.float32)
    return P, y, f_n, h


def _torch_args(system, P, y, f_n, h):
    pt = TParams.unpack(torch.as_tensor(P))
    return (system, torch.as_tensor(y), torch.as_tensor(f_n),
            torch.as_tensor(h), pt.k.contiguous(), t_eff(system, pt), NR, DR)


@pytest.mark.parametrize("variant", ["base_system", "rect_system",
                                     "memb_sfk_system"])
def test_plain_step_matches_pallas_interpret(variant):
    P, y, f_n, h = _inputs(7)
    js = getattr(jg, variant)()
    pj = JParams.unpack(jnp.asarray(P))
    want = j_fused(js, jnp.asarray(y), jnp.asarray(f_n), jnp.asarray(h),
                   pj.k, j_eff(js, pj), NR, DR, interpret=True)
    got = ros23_cuda.ros23_step_plain(*_torch_args(getattr(tg, variant)(),
                                                   P, y, f_n, h))
    for a, b, name, tol in zip(want, got, ("y1", "f1", "est"),
                               (1e-5, 1e-5, 1e-4)):
        a = np.asarray(a, np.float64)
        b = b.numpy().astype(np.float64)
        assert np.isfinite(b).all(), name
        err = np.linalg.norm(a - b) / np.linalg.norm(a)
        assert err <= tol, (name, err)


def test_wrapper_takes_plain_version_on_cpu():
    P, y, f_n, h = _inputs(8)
    args = _torch_args(tg.base_system(), P, y, f_n, h)
    before = ros23_cuda.LAUNCHES
    got = ros23_cuda.ros23_step_fused(*args)
    want = ros23_cuda.ros23_step_plain(*args)
    assert ros23_cuda.LAUNCHES == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_wrapper_rejects_other_devices():
    P, y, f_n, h = _inputs(9)
    args = list(_torch_args(tg.base_system(), P, y, f_n, h))
    for i in (1, 2, 3, 4, 5):
        args[i] = args[i].to("meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        ros23_cuda.ros23_step_fused(*args)


def test_rates_header_follows_the_tables():
    """The kernel's rate functions are generated from the system's
    tables: every reaction and binding appears, and a changed table
    changes the header (so the build cache keys on it)."""
    base = tg.base_system()
    text = ros23_cuda.rates_header(base)
    n_rx = len(base.bulk_reactions) + len(base.memb_reactions)
    assert text.count("const V rf =") == n_rx
    assert text.count("const V net =") == n_rx + len(base.surface_bindings)
    assert ros23_cuda.rates_header(tg.rect_system()) == text
    fewer = dataclasses.replace(base, bulk_reactions=base.bulk_reactions[1:])
    assert ros23_cuda.rates_header(fewer) != text


def test_step_flops_count():
    """CR on NB=50 on its own rows (50, 25, 13, 7, 4, 2, 1): 50 Gauss-Jordan
    inverses in the factor, 138 dense block products and 144 scalings by a
    diagonal level-0 block; per solve 192 dense block matvecs and 48
    scalings of a 10-vector.  The smallest system has one odd row."""
    assert ros23_cuda.step_flops(50) == (
        50 * 2000 + 138 * 2000 + 144 * 100 + 3 * (192 * 200 + 48 * 10))
    # NB=2: Dinv_1, the root; UDinv = Ulast Dinv_1 and UDinv Lmemb (both
    # dense); per solve the forward, root and two backward matvecs
    assert ros23_cuda.step_flops(2) == 2 * 2000 + 2 * 2000 + 3 * 4 * 200
    # twice the rows need about twice the work, padding or not
    assert 2.0 < ros23_cuda.step_flops(100) / ros23_cuda.step_flops(50) < 2.1
