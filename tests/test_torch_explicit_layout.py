"""The redesigned fused explicit kernel's arithmetic and launch plan, on
the CPU.

The kernel (``csrc/explicit_solve.cu``) runs only on the card.  Its
arithmetic differs from ``solve_explicit_plain`` in order only: 1/dr^2,
1/(r_j dr), q_s = dr/d_eff_s and kSa*q_aSFK are taken once; the closure
takes ``(cn + g q) / (1 + l q)`` as a product with the correctly rounded
reciprocal and one residual correction; aSFK's boundary value is
``cn + (kSa q_aSFK CR[iSFK]) Etot``.  ``_emulate`` below is that arithmetic
in plain torch (float32, each fused multiply-add rounded once through
float64), and is held to the plain twin and to the JAX Pallas kernel in
interpret mode.

Tolerances.  Against the plain twin: relative norm error of C and of m
<= 1e-6 (taken in float64: memb_sfk holds values ~1e36).  Both are the
same scheme in float32; a reordered operation moves a value by an ulp
(6e-8 relative), and the explicit scheme damps such differences instead of
accumulating them over the ~100-400 steps here; the card's limit for the
kernel against the twin is 1e-4.  Against the Pallas kernel: the JAX
test's own bounds, rtol 3e-5 and atol 1e-4 on C, atol 1e-6 on m, which the
plain twin meets too (``tests/test_torch_explicit_kernel.py``).
"""

import dataclasses
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gab1_shp2_tpu as jg
from gab1_shp2_tpu.models.params import Params as JParams
from gab1_shp2_tpu.ops.explicit_pallas import solve_explicit_pallas

import gab1_shp2_tpu_torch as tg
from gab1_shp2_tpu_torch.models.species import CYTO, MEMB
from gab1_shp2_tpu_torch.models.system import Geometry
from gab1_shp2_tpu_torch.ops import explicit_cuda
from gab1_shp2_tpu_torch.ops.explicit import uniform_initial_profile
from gab1_shp2_tpu_torch.ops.rates_codegen import lane_closure_header
from gab1_shp2_tpu_torch.ops.rhs import (
    bulk_rates,
    effective_diffusivities,
    etot,
    kdict,
    memb_rates,
)

torch.set_num_threads(2)

CO = tg.default_co(device="cpu")
F32 = torch.float32


def _fma(a, b, c):
    """a*b + c rounded once to float32 (the product of two floats is exact
    in float64)."""
    return (a.double() * b.double() + c.double()).to(F32)


def _closure(system, cn, mm, k, q, kq):
    """The kernel's boundary values: one quotient a species by the
    correctly rounded reciprocal and one residual correction."""
    zero = torch.zeros_like(cn[..., 0])
    g = [zero] * len(CYTO)
    l = [zero] * len(CYTO)
    for sb in system.surface_bindings:
        ci = CYTO[sb.cyto]
        g[ci] = g[ci] + k[sb.kr] * mm[..., MEMB[sb.product]]
        l[ci] = l[ci] + k[sb.kf] * mm[..., MEMB[sb.memb]]
    Et = etot(mm)
    iS, aS = CYTO["iSFK"], CYTO["aSFK"]
    l[iS] = _fma(k["kSa"], Et, l[iS])
    g, l = torch.stack(g, -1), torch.stack(l, -1)
    num = _fma(g, q, cn)
    den = _fma(l, q, torch.ones_like(l))
    r = 1.0 / den
    q0 = num * r
    cr = _fma(_fma(-den, q0, num), r, q0)
    asfk = _fma(kq * cr[..., iS], Et, cn[..., aS])
    return torch.cat([cr[..., :aS], asfk[..., None], cr[..., aS + 1:]], -1)


def _emulate(system, pb, dr, tf, maxiters):
    """The kernel's arithmetic, member-steps masked as in the plain twin."""
    Nr, Co, pb, dts, nt = explicit_cuda._prepare(CO, pb, 10.0, dr, tf,
                                                 maxiters, torch.device("cpu"))
    B = pb.k.shape[0]
    drf = torch.tensor(dr, dtype=F32)
    inv_dr2 = 1.0 / torch.tensor(dr * dr, dtype=F32)
    j = torch.arange(1, Nr, dtype=F32)
    inv_rdr = 1.0 / ((j * drf) * drf)
    d_eff = effective_diffusivities(system, pb)
    q = drf / d_eff
    k_memb = kdict(pb.k)
    kq = k_memb["kSa"] * (drf / d_eff[:, CYTO["aSFK"]])
    k_bulk = kdict(pb.k[:, None, :])
    C, m = uniform_initial_profile(Co, Nr, B)
    dt1, dt3 = dts[:, None], dts[:, None, None]
    spherical = system.geometry is Geometry.SPHERICAL
    for i in range(int(nt.max())):
        um, uc, up = C[..., :-2], C[..., 1:-1], C[..., 2:]
        lap = ((up - uc) - (uc - um)) * inv_dr2
        if spherical:
            lap = _fma(up - um, inv_rdr, lap)
        rates = bulk_rates(system, uc.movedim(1, 0), k_bulk).movedim(0, 1)
        Cn_int = _fma(dt3, _fma(d_eff[:, :, None], lap, rates), uc)
        cn = Cn_int[:, :, -1]
        mm = m if i > 0 else torch.zeros_like(m)
        for _ in range(maxiters):
            CR = _closure(system, cn, mm, k_memb, q, kq)
            mm = _fma(dt1, memb_rates(system, m, CR, k_memb), m)
        C_new = torch.cat([Cn_int[:, :, :1], Cn_int, CR[:, :, None]], dim=2)
        active = i < nt
        C = torch.where(active[:, None, None], C_new, C)
        m = torch.where(active[:, None], mm, m)
    return C, m


def _rel_norm(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def _members(B, seed=3):
    rng = np.random.default_rng(seed)
    p0 = tg.default_params(device="cpu").pack().numpy()
    P = p0[None] * np.exp(rng.normal(0, 0.2, (B, 24)))
    return tg.Params.unpack(torch.as_tensor(P, dtype=F32))


@pytest.mark.parametrize("variant,dr", [("base_system", 0.5),
                                        ("rect_system", 1.0),
                                        ("memb_sfk_system", 1.0)])
def test_emulated_kernel_matches_plain(variant, dr):
    system = getattr(tg, variant)()
    pb = _members(4)
    kw = dict(dr=dr, tf=0.25, maxiters=4)
    C, m = _emulate(system, pb, **kw)
    Cp, mp = explicit_cuda.solve_explicit_plain(system, CO, pb, device="cpu",
                                                **kw)
    assert torch.isfinite(C).all() and torch.isfinite(m).all()
    assert _rel_norm(C, Cp) <= 1e-6
    assert _rel_norm(m, mp) <= 1e-6
    if system.memb_sfk:
        # q_aSFK = dr/1e-32 and the aSFK boundary value built from it stay
        # far below float32's 3.4e38
        assert float(C[:, CYTO["aSFK"], -1].abs().max()) < 1e37


def test_emulated_kernel_matches_pallas_interpret():
    p0 = tg.default_params(device="cpu")
    pb = tg.Params(D=torch.stack([p0.D, p0.D]).float(),
                   k=torch.stack([p0.k, p0.k * 1.05]).float())
    C, m = _emulate(tg.base_system(), pb, 0.5, 0.1, 4)
    pj = JParams(D=jnp.asarray(pb.D.numpy()), k=jnp.asarray(pb.k.numpy()))
    Cj, mj = solve_explicit_pallas(jg.base_system(), jg.default_co(), pj,
                                   dr=0.5, tf=0.1, maxiters=4, block=2,
                                   interpret=True)
    np.testing.assert_allclose(C.numpy(), np.asarray(Cj), rtol=3e-5,
                               atol=1e-4)
    np.testing.assert_allclose(m.numpy(), np.asarray(mj), rtol=3e-5,
                               atol=1e-6)


@pytest.mark.parametrize("nodes,npl,warps", [
    (11, 2, 1), (51, 2, 1), (66, 2, 1), (67, 4, 1), (101, 4, 1), (130, 4, 1),
    (131, 4, 2), (201, 4, 2), (501, 4, 4), (1026, 4, 8)])
def test_launch_plan(nodes, npl, warps):
    """Nodes a lane and the instantiation from the grid alone: a warp per
    member up to 128 interior nodes, then a block of warps, 4 nodes a
    lane, enough lanes for every interior node."""
    plan = explicit_cuda.launch_plan(nodes - 1)
    assert (plan.nodes_per_lane, plan.warps_per_member) == (npl, warps)
    assert 32 * npl * warps >= nodes - 2 > 32 * npl * (warps - 1) or (
        warps == 1)
    assert plan.threads == 32 * warps <= 256


def test_launch_plan_refuses_finer_grids():
    assert explicit_cuda.MAX_NODES == 1026
    with pytest.raises(ValueError, match="no layout"):
        explicit_cuda.launch_plan(1026)
    with pytest.raises(ValueError, match="no layout"):
        explicit_cuda.launch_plan(1)


def test_member_order_returns_every_member():
    """The slots take the members by step count, descending, ties in
    member order; gathering by the order and scattering back by it (what
    the kernel does: it reads member order[slot] and writes there) leaves
    every member's result in its own place, and the inverse permutation
    undoes the gather."""
    nt = torch.tensor([5, 9, 9, 1, 7, 9, 3, 5, 2, 8, 6], dtype=torch.int32)
    order = explicit_cuda.member_order(nt)
    assert order.dtype == torch.int32
    idx = order.long()
    assert sorted(idx.tolist()) == list(range(nt.numel()))
    assert (nt[idx][:-1] >= nt[idx][1:]).all()
    assert idx[:3].tolist() == [1, 2, 5]
    x = torch.arange(nt.numel() * 3, dtype=F32).reshape(-1, 3)
    per_slot = x[idx] * 2.0                 # each slot computes its member
    out = torch.empty_like(x).index_copy_(0, idx, per_slot)
    assert torch.equal(out, x * 2.0)
    assert torch.equal(x[idx][torch.argsort(idx)], x)


def test_chain_ops_hand_count():
    """A member-step's longest path at one iteration: node Nr-1's update
    from the last CR (second difference 2, scale 1, metric 1, d*lap + rates
    1, C + dt*... 1) 6, cn + g q 1, the product by the reciprocal 1 (the
    loss, 1 + l q and the reciprocal run beside the node), the correction
    2, kf*CR and the net 2, E's membrane rate takes 4 binding nets 4, the
    update 1: 17.  Each further iteration: loss 1, 1 + l q 1, reciprocal
    and product 2, then the same 9: 13, so four iterations are 56; rect
    has no metric term.  Etot enters only the boundary values of the last
    iterate, beside the chain.  The count is ``chip_smoke.py``'s, which
    prints the floor it gives."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.chain_ops(tg.base_system(), 1) == 17
    assert smoke.chain_ops(tg.base_system(), 4) == 56
    assert smoke.chain_ops(tg.rect_system(), 4) == 55
    # 51,718 steps at 1.98 GHz: 56 * 4 cycles each
    assert smoke.chain_floor_ms(tg.base_system(), 51718, 4,
                                1980000) == pytest.approx(
        51718 * 56 * 4 / 1.98e6)


def test_lane_header_refuses_two_bindings_on_one_species():
    system = tg.base_system()
    sb = system.surface_bindings[0]
    twice = type(system)(surface_bindings=system.surface_bindings + (sb,))
    with pytest.raises(ValueError, match="two surface bindings"):
        lane_closure_header(twice)
    # the iterations leave Etot out: no binding may read iSFK or aSFK
    isfk = dataclasses.replace(sb, cyto="iSFK")
    with pytest.raises(ValueError, match="iSFK has a surface binding"):
        lane_closure_header(type(system)(surface_bindings=(isfk,)))
    text = lane_closure_header(system)
    assert "closure_quotient" in text and "NET_TERMS = 4" in text


def _code(text):
    """C++ text without its comments."""
    return "\n".join(line.split("//")[0] for line in text.splitlines())


def _braced(text, start):
    """The text from ``start`` to the brace that closes the first one."""
    i = text.index(start)
    depth, j = 0, text.index("{", i)
    while True:
        depth += {"{": 1, "}": -1}.get(text[j], 0)
        if depth == 0:
            return text[i:j + 1]
        j += 1


def test_step_loop_has_no_division():
    """No ``/`` in the kernel's step loop or in the generated functions it
    calls: the quotients are products with a correctly rounded reciprocal
    (``rcp_rn``, whose own body has no division either) and one
    correction."""
    src = _code((explicit_cuda._build.CSRC_DIR
                 / "explicit_solve.cu").read_text())
    loop = _braced(src, "for (int step = 0; step < nt; ++step)")
    assert "closure_quotient(" in loop and "bulk_rates<float>(" in loop
    assert "/" not in loop
    system = tg.base_system()
    lanes = _code(lane_closure_header(system))
    for fn in ("float etot_lanes(", "void memb_reaction_rates(",
               "float lane_quotient(", "float closure_quotient(",
               "float closure_boundary(", "float memb_dm_lane("):
        body = _braced(lanes, fn)
        assert "/" not in body, fn
    assert "rcp_rn(den)" in _braced(lanes, "float lane_quotient(")
    assert '#include "fast_div.cuh"' in src
    helpers = _code((explicit_cuda._build.CSRC_DIR
                     / "fast_div.cuh").read_text())
    for fn in ("float rcp_rn(", "float div_by("):
        assert "/" not in _braced(helpers, fn), fn
    rates = _code(explicit_cuda.rates_header(system))
    assert "/" not in _braced(rates, "void bulk_rates(")
