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

Tolerance for the fused explicit solve against solve_explicit_plain (f32,
a few hundred steps): relative norm error of C and of m <= 1e-4, taken in
float64 (memb_sfk holds values ~1e32); the two differ by FMA contraction
and by the kernel's hoisted reciprocals (1/dr^2, 1/(r dr), dr/d_eff) and
its quotient by reciprocal and correction.
"""

import numpy as np
import pytest
import torch

import gab1_shp2_tpu_torch as tg
from gab1_shp2_tpu_torch.ops import explicit_cuda, ros23_cuda
from gab1_shp2_tpu_torch.ops.batch_stiff import _SolverCtx, make_mol_rhs_lanes
from gab1_shp2_tpu_torch.ops.rhs import effective_diffusivities

pytestmark = pytest.mark.gpu

R, DR = 10.0, 0.5
NR = int(round(R / DR))
# grids of the step kernel: NB = 20, 50 and 100 block rows keep a lane's
# arena in shared memory (3, 2 and 1 blocks an SM), NB = 200 puts it in
# global memory; NB = 9 is an odd row count
STEP_GRIDS = {"NB20": 0.5, "NB100": 0.1, "NB200-global-arena": 0.05,
              "NB9": 10.0 / 9.0}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _step_args(system, dev, B, seed=0, dr=DR):
    nr = int(round(R / dr))
    rng = np.random.default_rng(seed)
    p0 = tg.default_params(device="cpu").pack().numpy()
    P = p0[None] * np.exp(rng.normal(0, 0.2, (B, 24)))
    p = tg.Params.unpack(torch.as_tensor(P, dtype=torch.float32, device=dev))
    y = torch.as_tensor(rng.uniform(0.1, 5.0, (nr, 10, B)),
                        dtype=torch.float32, device=dev)
    y[-1, 8:] = 0.0
    rhs, _ = make_mol_rhs_lanes(system, R, dr)
    f_n = rhs(y, p).contiguous()
    h = torch.as_tensor(np.logspace(-3, -1, B), dtype=torch.float32,
                        device=dev)
    d_eff = effective_diffusivities(system, p).contiguous()
    return (system, y, f_n, h, p.k.contiguous(), d_eff, nr, dr), rhs, p


@pytest.mark.parametrize("grid,B", [("NB20", 1), ("NB20", 37), ("NB20", 300),
                                    ("NB100", 37), ("NB200-global-arena", 16),
                                    ("NB9", 5)])
@pytest.mark.parametrize("variant", ["base_system", "rect_system",
                                     "memb_sfk_system"])
def test_kernel_matches_plain(cuda, variant, grid, B):
    system = getattr(tg, variant)()
    dr = STEP_GRIDS[grid]
    args, rhs, p = _step_args(system, cuda, B=B, dr=dr)
    assert ros23_cuda.arena_in_shared(args[6]) is ("global" not in grid)
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
    ctx = _SolverCtx(system, R, dr, 2, 1e-4, 1e-7, 1.0, torch.float32, cuda,
                     None, "rosenbrock23", "torch")
    # est: the per-lane error norms agree to 1e-2 of max(1, norm), so the
    # accept/reject decision moves only within 1% of its threshold (on
    # these rough random states the norms reach far above 1)
    errn_p = ctx.scaled_norm(ep, args[1], yp)
    diff = ctx.scaled_norm(ek - ep, args[1], yp)
    assert bool((diff <= 1e-2 * torch.clamp(errn_p, min=1.0)).all()), (
        diff, errn_p)


@pytest.mark.parametrize("grid", ["NB20", "NB200-global-arena"])
def test_kernel_is_deterministic(cuda, grid):
    """Two launches on the same inputs give the same bits (the kernel has
    no atomics), and so does, where the arena lies in shared memory, the
    same arena in global memory: the arithmetic does not depend on where
    the arena lies."""
    args, _, _ = _step_args(tg.base_system(), cuda, B=37,
                            dr=STEP_GRIDS[grid])
    first = ros23_cuda.ros23_step_fused(*args)
    second = ros23_cuda.ros23_step_fused(*args)
    system, y, f_n, h, k, d_eff, _, dr = args
    before = ros23_cuda.LAUNCHES
    in_global = ros23_cuda.ros23_step_probe(system, y, f_n, h, k, d_eff, dr,
                                            global_arena=True)
    torch.cuda.synchronize()
    assert ros23_cuda.LAUNCHES == before
    for other in (second, in_global):
        for a, b in zip(first, other):
            assert torch.equal(a, b)


def test_arena_layout_agrees_with_the_library(cuda):
    """``arena_bytes``/``arena_in_shared`` mirror the library's layout, and
    the occupancy calculator gives the blocks per SM of the header note."""
    system = tg.base_system()
    lib = ros23_cuda._library(system)
    for nb in (2, 3, 9, 20, 50, 100, 112, 113, 200, 1000):
        assert lib.ros23_arena_bytes(nb) == ros23_cuda.arena_bytes(nb)
        assert bool(lib.ros23_arena_in_shared(nb)) is (
            ros23_cuda.arena_in_shared(nb))
    assert ros23_cuda.blocks_per_sm(system, 50) == 2
    assert ros23_cuda.blocks_per_sm(system, 100) == 1
    assert ros23_cuda.blocks_per_sm(system, 200) >= 1


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
    # a launch that the library refuses raises (one block row: the probe
    # passes NB < 2 on, the wrapper above refuses it itself)
    system, y, f_n, h, k, d_eff, _, dr = args
    with pytest.raises(RuntimeError, match="launch failed"):
        ros23_cuda.ros23_step_probe(system, y[:1].contiguous(),
                                    f_n[:1].contiguous(), h, k, d_eff, dr)


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


def _ensemble(B, seed=3):
    rng = np.random.default_rng(seed)
    p0 = tg.default_params(device="cpu").pack().numpy()
    return p0[None] * np.exp(rng.normal(0, 0.2, (B, 24)))


def _rel_norm(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


# grids of the explicit kernel and its layouts: a warp per member at 2
# nodes a lane (21 and 51 nodes) and at 4 (101), a block of 2 and of 4
# warps per member (201 and 501 nodes), as (dr, tf)
EXPLICIT_GRIDS = {"21-nodes": (0.5, 0.2), "51-nodes": (0.2, 0.03),
                  "101-nodes": (0.1, 0.005), "201-nodes": (0.05, 0.002),
                  "501-nodes": (0.02, 2e-4)}


@pytest.mark.parametrize("grid", list(EXPLICIT_GRIDS))
@pytest.mark.parametrize("variant", ["base_system", "rect_system",
                                     "memb_sfk_system"])
def test_explicit_kernel_matches_plain(cuda, variant, grid):
    """Every instantiation of the kernel against the plain version; 37
    members (an odd count) with different step counts."""
    dr, tf = EXPLICIT_GRIDS[grid]
    system = getattr(tg, variant)()
    pb = tg.Params.unpack(torch.as_tensor(_ensemble(37), dtype=torch.float32,
                                          device=cuda))
    Co = tg.default_co(dtype=torch.float32, device=cuda)
    kw = dict(dr=dr, tf=tf, maxiters=4)
    before = explicit_cuda.LAUNCHES
    Ck, mk = explicit_cuda.solve_explicit_fused(system, Co, pb, **kw)
    assert explicit_cuda.LAUNCHES == before + 1
    Cp, mp = explicit_cuda.solve_explicit_plain(system, Co, pb, **kw)
    torch.cuda.synchronize()
    assert explicit_cuda.LAUNCHES == before + 1
    assert Ck.device.type == "cuda" and Ck.dtype == torch.float32
    assert tuple(Ck.shape) == tuple(Cp.shape) and tuple(mk.shape) == (37, 8)
    assert torch.isfinite(Ck).all() and torch.isfinite(mk).all()
    assert _rel_norm(Ck, Cp) <= 1e-4
    assert _rel_norm(mk, mp) <= 1e-4


def test_explicit_kernel_finest_grid(cuda):
    """1026 nodes, the most the kernel takes: a block of 8 warps."""
    pb = tg.Params.unpack(torch.as_tensor(_ensemble(3), dtype=torch.float32,
                                          device=cuda))
    Co = tg.default_co(dtype=torch.float32, device=cuda)
    kw = dict(R=10.25, dr=0.01, tf=2e-5, maxiters=4)
    assert explicit_cuda.launch_plan(1025).warps_per_member == 8
    Ck, mk = explicit_cuda.solve_explicit_fused(tg.base_system(), Co, pb,
                                                **kw)
    Cp, mp = explicit_cuda.solve_explicit_plain(tg.base_system(), Co, pb,
                                                **kw)
    assert tuple(Ck.shape) == (3, 10, 1026)
    assert _rel_norm(Ck, Cp) <= 1e-4 and _rel_norm(mk, mp) <= 1e-4


@pytest.mark.parametrize("grid", ["51-nodes", "201-nodes"])
def test_explicit_kernel_is_deterministic_and_order_free(cuda, grid):
    """Two launches give the same bits, and so does the ensemble permuted:
    each member's result does not depend on its slot, its block or the
    members beside it; 11 members (an odd count) give the bits of the same
    members in an ensemble of 16."""
    dr, tf = EXPLICIT_GRIDS[grid]
    P = _ensemble(16, seed=4)
    Co = tg.default_co(dtype=torch.float32, device=cuda)
    kw = dict(dr=dr, tf=tf, maxiters=4)

    def solve(rows):
        pb = tg.Params.unpack(torch.as_tensor(P[rows], dtype=torch.float32,
                                              device=cuda))
        return explicit_cuda.solve_explicit_fused(tg.base_system(), Co, pb,
                                                  **kw)

    rows = np.arange(16)
    C1, m1 = solve(rows)
    C2, m2 = solve(rows)
    assert torch.equal(C1, C2) and torch.equal(m1, m2)
    perm = np.random.default_rng(0).permutation(16)
    Cp, mp = solve(perm)
    assert torch.equal(Cp, C1[perm]) and torch.equal(mp, m1[perm])
    C11, m11 = solve(rows[:11])
    assert torch.equal(C11, C1[:11]) and torch.equal(m11, m1[:11])


def test_explicit_refused_launch_raises(cuda):
    """A layout that does not hold the grid's interior nodes is refused by
    the library, and the wrapper's launch raises."""
    system = tg.base_system()
    pb = tg.Params.unpack(torch.as_tensor(_ensemble(4), dtype=torch.float32,
                                          device=cuda))
    z = torch.zeros(64, device=cuda)
    nt = torch.ones(4, dtype=torch.int32, device=cuda)
    C = torch.empty((4, 10, 201), device=cuda)
    m = torch.empty((4, 8), device=cuda)
    too_small = explicit_cuda.LaunchPlan(200, 2, 1)
    with pytest.raises(RuntimeError, match="launch failed"):
        explicit_cuda._launch(system, too_small, z, z, pb.k, z, z, nt,
                              explicit_cuda.member_order(nt), C, m, 0.05, 4)


def test_explicit_kernel_info(cuda):
    """Each instantiation compiles without spills and fits the card."""
    for Nr in (50, 100, 200):
        info = explicit_cuda.kernel_info(tg.base_system(),
                                         explicit_cuda.launch_plan(Nr))
        assert 0 < info["registers"] <= 255
        assert info["local_bytes"] == 0
        assert info["blocks_per_sm"] >= 1 and info["sm_clock_khz"] > 0


def test_explicit_block_launches_and_f64_inputs(cuda):
    """``block`` splits the ensemble into ceil(B/block) launches with the
    same result; f64 inputs on the CPU are cast and moved."""
    P = _ensemble(10)
    pb64 = tg.Params.unpack(torch.as_tensor(P))
    Co64 = tg.default_co(device="cpu")
    kw = dict(dr=0.5, tf=0.1, maxiters=4)
    explicit_cuda.LAUNCHES = 0
    C1, m1 = explicit_cuda.solve_explicit_fused(tg.base_system(), Co64, pb64,
                                                **kw)
    assert explicit_cuda.LAUNCHES == 1
    C4, m4 = explicit_cuda.solve_explicit_fused(tg.base_system(), Co64, pb64,
                                                block=4, **kw)
    torch.cuda.synchronize()
    assert explicit_cuda.LAUNCHES == 1 + 3
    assert C1.device.type == "cuda" and C1.dtype == torch.float32
    assert torch.equal(C1, C4) and torch.equal(m1, m4)


def test_explicit_wrapper_rejects_bad_inputs(cuda):
    pb = tg.Params.unpack(torch.as_tensor(_ensemble(4)))
    Co = tg.default_co(device="cpu")
    before = explicit_cuda.LAUNCHES
    with pytest.raises(ValueError, match="1026-node"):
        explicit_cuda.solve_explicit_fused(tg.base_system(), Co, pb,
                                           R=10.26, dr=0.01, tf=1e-6)
    with pytest.raises(ValueError, match="maxiters"):
        explicit_cuda.solve_explicit_fused(tg.base_system(), Co, pb,
                                           maxiters=0)
    with pytest.raises(ValueError, match="block"):
        explicit_cuda.solve_explicit_fused(tg.base_system(), Co, pb, block=0)
    with pytest.raises(ValueError, match="batched"):
        explicit_cuda.solve_explicit_fused(
            tg.base_system(), Co, tg.default_params(device="cpu"))
    with pytest.raises(ValueError, match="shape"):
        explicit_cuda.solve_explicit_fused(tg.base_system(), Co[:4], pb)
    with pytest.raises(ValueError, match="CUDA device or the CPU"):
        explicit_cuda.solve_explicit_fused(tg.base_system(), Co, pb,
                                           device="meta")
    assert explicit_cuda.LAUNCHES == before


def _final_pg1s(sol):
    return sol.PG1Stot[-1]


def test_default_device_is_the_card(cuda):
    assert tg.default_params().D.device.type == "cuda"
    assert tg.default_co().device.type == "cuda"
    P = _ensemble(4, seed=1)
    kw = dict(extract=_final_pg1s, dr=1.0, tf=0.2, Nts=2)
    for solver in ("stiff", "explicit"):
        out, ok = tg.run_ensemble(tg.base_system(),
                                  tg.default_co(device="cpu"), P,
                                  solver=solver, **kw)
        assert out.device.type == "cuda" and ok.device.type == "cuda"
        assert bool(ok.all()) and tuple(out.shape) == (4, 11)
    sol = tg.solve_explicit(tg.base_system(), tg.default_co(device="cpu"),
                            tg.default_params(device="cpu"), dr=1.0, tf=0.05,
                            Nts=1)
    assert sol.C.device.type == "cuda"


# --- the single-member stiff solver and the inference path ----------------

SINGLE_KW = dict(dr=1.0, tf=0.5, Nts=2, rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("method", ["trbdf2", "rosenbrock23", "rodas3",
                                    "rodas4"])
def test_solve_stiff_on_the_card(cuda, method):
    """float64 solve_stiff on the card against the port on the CPU: step
    counts within +-2, values within 1e-8 relative to the largest."""
    from gab1_shp2_tpu_torch.ops.trbdf2 import solve_stiff

    (sg, stg), (sc, stc) = (
        solve_stiff(tg.base_system(), tg.default_co(device=dev),
                    tg.default_params(device=dev), device=dev, method=method,
                    return_stats=True, **SINGLE_KW)
        for dev in (cuda, torch.device("cpu")))
    assert sg.C.device.type == cuda.type and not bool(stg.failed)
    assert abs(int(stg.n_accepted) - int(stc.n_accepted)) <= 2
    assert abs(int(stg.n_rejected) - int(stc.n_rejected)) <= 2
    for a, b in ((sg.C, sc.C), (sg.m, sc.m)):
        err = float((a.cpu() - b).abs().max() / b.abs().max())
        assert err < 1e-8, err


def test_log_posterior_gradient_on_the_card(cuda):
    """The autograd Function's value and gradient on the card against the
    CPU (rodas4, dr=1, tf=0.5, rtol 1e-3): within 1e-8 relative."""
    from gab1_shp2_tpu_torch.inference import loss as tl

    kw = dict(dr=1.0, tf=0.5, rtol=1e-3, atol=1e-6, method="rodas4")
    x = np.log([0.42, 9.5, 0.42, 9.5])
    out = []
    for dev in (cuda, torch.device("cpu")):
        lp = tl.make_log_posterior(tl.make_observable_fn(device=dev, **kw))
        q = torch.as_tensor(x, device=dev).requires_grad_(True)
        v = lp(q)
        (g,) = torch.autograd.grad(v, q)
        out.append((float(v.detach()), g.cpu().numpy()))
    (vg, gg), (vc, gc) = out
    assert np.isfinite(vg) and abs(vg - vc) / abs(vc) < 1e-8
    assert np.max(np.abs(gg - gc)) / np.max(np.abs(gc)) < 1e-8
    assert gg[2] > 0 and gg[1] < 0


def test_lbfgs_on_the_card(cuda):
    """Projected LBFGS on a 4-D quadratic on the card: the CPU's iterates
    and the minimizer."""
    from gab1_shp2_tpu_torch.inference.map_fit import lbfgs_minimize

    A = np.diag([1.0, 10.0, 100.0, 3.0]) + 0.5
    b = np.array([1.0, -2.0, 0.5, 3.0])
    res = []
    for dev in (cuda, torch.device("cpu")):
        At, bt = torch.as_tensor(A, device=dev), torch.as_tensor(b, device=dev)

        def f(x):
            return 0.5 * x @ At @ x - bt @ x

        x, v = lbfgs_minimize(f, torch.zeros(4, dtype=torch.float64,
                                             device=dev), max_iters=30)
        assert x.device.type == dev.type
        res.append(x.cpu().numpy())
    np.testing.assert_allclose(res[0], res[1], rtol=0, atol=1e-10)
    np.testing.assert_allclose(res[0], np.linalg.solve(A, b), rtol=0,
                               atol=1e-8)


def test_nuts_on_a_surrogate_on_the_card(cuda):
    """Four chains on a Chebyshev surrogate posterior on the card:
    finite draws on the device, a healthy run by check_chains."""
    from gab1_shp2_tpu_torch.inference import loss as tl
    from gab1_shp2_tpu_torch.inference import nuts as tn
    from gab1_shp2_tpu_torch.inference import surrogate as ts
    from gab1_shp2_tpu_torch.inference.diagnostics import check_chains

    lo, hi = tl.prior_box()

    def batch_fn(Q):
        return 30.0 * np.exp(0.3 * np.tanh(Q[:, 0] - Q[:, 1])
                             + 0.2 * np.tanh(Q[:, 2] - Q[:, 3]))

    sur, _ = ts.build_surrogate(batch_fn, lo, hi, n=6, device=cuda)
    lp = tl.make_log_posterior(sur.y, wrap_vjp=False)
    x0 = torch.as_tensor(np.log([1.27, 3.12, 0.79, 4.67]), device=cuda)
    qs, info = tn.run_nuts(lp, x0.expand(4, 4).clone(),
                           tn.chain_generators(0, 4), num_warmup=100,
                           num_samples=100, max_depth=6)
    assert qs.device.type == cuda.type and qs.shape == (4, 100, 4)
    assert bool(torch.isfinite(qs).all())
    rep = check_chains(qs.cpu().numpy(), info["diverged"].cpu().numpy(),
                       names=tl.FIT_NAMES)
    assert rep["ok"], rep["failures"]


# --- the workload drivers ---------------------------------------------------

def _no_figures(monkeypatch):
    """Replace the drivers' figure helpers (matplotlib may be absent on
    the card's host); the CSVs are what these tests compare."""
    from gab1_shp2_tpu_torch.workloads import common

    for name in ("save_surface_plot", "save_line_plot",
                 "save_bar_comparison", "save_rotated_chase_surface"):
        monkeypatch.setattr(common, name, lambda *a, **k: None)


def test_run_base_model_on_the_card(cuda, tmp_path, monkeypatch):
    """run_base_model.main at a tiny configuration on the card and on the
    CPU (--linsolve none, float64): the pct_shp2_bound_gab1.csv rows agree
    within 1e-8 relative."""
    import csv

    from gab1_shp2_tpu_torch.workloads import run_base_model

    _no_figures(monkeypatch)
    argv = ["--n", "4", "--dr", "0.5", "--nts", "4", "--rtol", "1e-3",
            "--linsolve", "none"]
    rows = []
    for flags, sub in (([], "card"), (["--cpu"], "cpu")):
        out = str(tmp_path / sub)
        run_base_model.main(argv + flags + ["--outdir", out])
        with open(f"{out}/pct_shp2_bound_gab1.csv") as fh:
            rows.append([float(v) for v in list(csv.reader(fh))[1]])
    card, cpu = np.asarray(rows[0]), np.asarray(rows[1])
    assert 0 < card[1] < 100
    np.testing.assert_allclose(card, cpu, rtol=1e-8)


def test_get_ensemble_same_on_both(cuda):
    """The drivers' ensemble is drawn on the host; it reaches the card's
    solves as the same float64 values."""
    from gab1_shp2_tpu_torch.workloads import common

    ens = common.get_ensemble(16, seed=3)
    np.testing.assert_array_equal(ens, common.get_ensemble(16, seed=3))
    on_card = tg.Params.unpack(torch.as_tensor(ens, device=cuda))
    on_cpu = tg.Params.unpack(torch.as_tensor(ens))
    assert on_card.k.device.type == "cuda"
    assert torch.equal(on_card.pack().cpu(), on_cpu.pack())
    np.testing.assert_array_equal(on_card.pack().cpu().numpy(), ens)


# --- the mesh, the mixed RHS, imaging, the trace ---------------------------


def _members(n, seed=0, sigma=0.2):
    rng = np.random.default_rng(seed)
    p0 = tg.default_params(device="cpu").pack().numpy()
    return p0[None] * np.exp(rng.normal(0.0, sigma, (n, 24)))


def test_refill_sharded_over_two_slots_of_one_card(cuda):
    """Two worker threads, each a refill queue on cuda:0, against the
    unsharded refill: f64, so every member's steps and values agree
    within 1e-12; the outputs gather on cuda:0."""
    from gab1_shp2_tpu_torch.parallel.mesh import ensemble_mesh

    batch = torch.as_tensor(_members(10, seed=4))
    kw = dict(solver="stiff", extract=lambda s: s.PG1Stot[-1], dr=0.5,
              tf=0.5, Nts=2, rtol=1e-4, atol=1e-7, method="rodas4", chunk=4)
    co = tg.default_co(device=cuda)
    a, oka = tg.run_ensemble(tg.base_system(), co, batch, **kw)
    b, okb = tg.run_ensemble(tg.base_system(), co, batch,
                             device_axis="ensemble",
                             mesh=ensemble_mesh(["cuda:0", "cuda:0"]), **kw)
    assert b.device == torch.device("cuda", 0)
    assert torch.equal(oka, okb) and bool(okb.all())
    torch.testing.assert_close(b, a, rtol=1e-12, atol=0)


def test_fused_step_from_worker_threads(cuda):
    """run_sharded_batch of the fused Rosenbrock23 path over two slots of
    the card: the kernel launches from both worker threads, each inside
    the card's device context, and the result agrees with the unsharded
    batch's within 5e-5 relative (the JAX test's bound: the error norms
    are reductions whose order may follow the batch's width)."""
    from gab1_shp2_tpu_torch.parallel.mesh import (
        ensemble_mesh,
        run_sharded_batch,
    )

    system = tg.base_system()
    co = tg.default_co(dtype=torch.float32, device=cuda)
    kw = dict(dr=0.5, tf=0.5, Nts=2, rtol=1e-4, atol=1e-7,
              method="rosenbrock23", step_impl="fused", return_stats=True)
    batch = torch.as_tensor(_members(16), dtype=torch.float32, device=cuda)

    def local(packed):
        sol, st = tg.solve_stiff_batch(system, co.to(packed.device),
                                       tg.Params.unpack(packed),
                                       device=packed.device, **kw)
        return sol.C[:, -1], st.n_accepted + st.n_rejected

    before = ros23_cuda.LAUNCHES
    C, steps = run_sharded_batch(local, batch, ensemble_mesh(["cuda:0",
                                                              "cuda:0"]))
    launched = ros23_cuda.LAUNCHES - before
    C_ref, steps_ref = local(batch)
    # each slot launches once per step of its slowest lane
    assert launched == int(steps[:8].max()) + int(steps[8:].max())
    assert bool((steps > 0).all()) and bool((steps_ref > 0).all())
    torch.testing.assert_close(C, C_ref, rtol=5e-5, atol=1e-8)


def test_rhs_df32_card_matches_cpu(cuda):
    """Every float32 operation of the compensated RHS rounds on its own on
    both devices: the card's result equals the CPU's within 1e-13."""
    from gab1_shp2_tpu_torch.ops.rhs_df32 import make_mol_rhs_lanes_df32

    rng = np.random.default_rng(3)
    f, _ = make_mol_rhs_lanes_df32(tg.base_system(), R, DR)
    y = torch.as_tensor(rng.uniform(0.1, 5.0, (NR, 10, 8)))
    y[-1, 8:] = 0.0
    p = tg.Params.unpack(torch.as_tensor(_members(8)))
    cpu = f(y, p)
    card = f(y.to(cuda), p.to(device=cuda)).cpu()
    assert float(((card - cpu).abs() / (cpu.abs() + 1e-30)).max()) <= 1e-13


def test_puncta_card_matches_cpu(cuda):
    """Counts, masks and cell labels on the card equal the CPU's."""
    from gab1_shp2_tpu_torch.imaging import puncta

    rng = np.random.default_rng(0)
    H = W = 160
    yy, xx = np.mgrid[0:H, 0:W]
    pla = 0.1 + 0.005 * rng.standard_normal((2, H, W))
    cell = np.full((H, W), 0.05) + 0.01 * rng.standard_normal((H, W))
    for cy, cx, r in ((40, 40, 26), (40, 120, 22), (120, 80, 30)):
        cell[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = 0.8
        for dy, dx in ((-8, 0), (0, 8), (8, -8)):
            pla += np.exp(-((yy - cy - dy) ** 2 + (xx - cx - dx) ** 2)
                          / (2 * 1.5 ** 2))
    pla, cell = pla.astype(np.float32), cell.astype(np.float32)
    for method in ("otsu", "li"):
        got = puncta.count_puncta(pla, feature_size=6.0, min_distance=4,
                                  threshold_method=method)
        want = puncta.count_puncta(pla, feature_size=6.0, min_distance=4,
                                   threshold_method=method, device="cpu")
        assert got.mask.device.type == "cuda"
        assert torch.equal(got.count.cpu(), want.count)
        assert torch.equal(got.mask.cpu(), want.mask)
    labels = puncta.identify_cells(cell)
    assert torch.equal(labels.cpu(), puncta.identify_cells(cell,
                                                           device="cpu"))
    a = puncta.count_puncta_per_cell(pla[0], cell, feature_size=6.0,
                                     min_distance=4)
    b = puncta.count_puncta_per_cell(pla[0], cell, feature_size=6.0,
                                     min_distance=4, device="cpu")
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_trace_holds_kernel_events(cuda, tmp_path):
    import json

    from gab1_shp2_tpu_torch.utils.progress import trace

    x = torch.ones(1 << 20, device=cuda)
    with trace(str(tmp_path)) as run:
        (x * 2.0).sum()
        torch.cuda.synchronize()
    with open(run.path) as fh:
        events = json.load(fh)["traceEvents"]
    assert any(e.get("cat") == "kernel" for e in events)


def test_bench_rows_on_the_card(cuda):
    """gab1_shp2_tpu_torch.bench's rows at N=8 on the card through main()
    at its default device, bench.py's tight reference included (dr=1,
    tf=0.1: ~1,100 TRBDF2 steps), and run_mesh over every card."""
    from gab1_shp2_tpu_torch import bench

    small = dict(dr=1.0, tf=0.1, lanes=4)
    line = bench.main(N=8, runs=1, **small)
    d = line["details"]
    assert d["backend"] == "cuda"
    assert d["device"] == torch.cuda.get_device_name(0)
    assert d["power_limit"].endswith("W")
    for row in (d, d["chunked_scheduler"], d["north_star"],
                d["gsa_config"]):
        assert row["failed"] == 0
    for row in (d, d["north_star"], d["gsa_config"]):
        assert row["max_rel_err_vs_f64_rtol1e-8"] <= 1e-3
    assert d["roofline"]["hbm_peak_GBps"] == 3350.0
    assert d["roofline"]["pct_hbm_peak"] <= 100
    mesh = bench.run_mesh(**small)["details"]
    assert mesh["per_device_consistency_vs_single_queue"] is True
    assert mesh["failed"] == 0
    assert mesh["devices"] == torch.cuda.device_count()
