"""The stiff step's CUDA graph (``ops/batch_stiff._SolverCtx.step``).

On a card the RODAS and unfused Rosenbrock23 steps replay their body
from one captured graph; everything else runs the eager step.  The
graph replays the eager step's kernels in the eager step's order, so
every test holds it to the eager step bit for bit; the eager side is
forced by replacing the engagement predicate ``step_graphed`` inside the
test.

CPU tests (tier-1): the predicate's answers, and the graph's plumbing
(static inputs, outputs overwritten at every replay, the idle graphs
taken by later solves) run without capture, where each replay runs the
body again into the same output buffers.  Card tests (marker ``gpu``,
skipped inside a fixture where there is no card), from a machine with
only the port's dependencies:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_step_graph.py -q
"""

import copy
import sys
import threading
from collections import OrderedDict

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

import gab1_shp2_tpu_torch as tg
from gab1_shp2_tpu_torch.ops import batch_stiff
from gab1_shp2_tpu_torch.ops.batch_stiff import _SolverCtx, step_graphed
from gab1_shp2_tpu_torch.utils import progress

CPU, CUDA = torch.device("cpu"), torch.device("cuda", 0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return CUDA


@pytest.fixture
def no_idle_graphs(monkeypatch):
    """An empty cache of idle graphs for the test, so that it counts
    its own captures."""
    monkeypatch.setattr(batch_stiff, "_IDLE_GRAPHS", OrderedDict())


def _members(n, seed=0, sigma=0.3):
    """Posterior-like rows: the default parameters, each scaled by a
    log-normal factor."""
    rng = np.random.default_rng(seed)
    p0 = tg.default_params(device="cpu").pack().numpy()
    return torch.as_tensor(p0[None] * np.exp(rng.normal(0.0, sigma, (n, 24))))


def _eager(monkeypatch):
    monkeypatch.setattr(batch_stiff, "step_graphed", lambda *a: False)


def _graphed(monkeypatch):
    monkeypatch.setattr(batch_stiff, "step_graphed", lambda *a: True)


def _assert_same_bits(a, b):
    for x, y in zip(pytree.tree_leaves(a), pytree.tree_leaves(b)):
        torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True)


def _count_steps(monkeypatch):
    """A wrapper around the step that counts its calls."""
    calls = []
    orig = _SolverCtx.__dict__["step"]

    def step(ctx, *args, **kwargs):
        calls.append(1)
        return orig(ctx, *args, **kwargs)

    monkeypatch.setattr(_SolverCtx, "step", step)
    return calls


def _refill(dev, n, lanes, tf, Nts, state, ls, seed=0, **kw):
    X = _members(n, seed).to(dtype=state, device=dev)
    co = tg.default_co(dtype=state, device=dev)
    return batch_stiff.solve_stiff_refill(
        tg.base_system(), co, tg.Params.unpack(X), device=dev,
        extract=lambda s: (s.C, s.m), dr=kw.pop("dr", 1.0), tf=tf, Nts=Nts,
        rtol=1e-4, atol=1e-7, method=kw.pop("method", "rodas4"),
        linsolve_dtype=ls, lanes=lanes, **kw)


def _pulse_chase(dev, n, tf, method="rodas4", **kw):
    X = _members(n, seed=2).to(device=dev)
    return tg.solve_stiff_batch(
        tg.base_system(), tg.default_co(device=dev), tg.Params.unpack(X),
        device=dev, dr=kw.pop("dr", 1.0), tf=tf, t_prechase=tf / 2, Nts=4,
        rtol=1e-5, atol=1e-8, method=method, return_stats=True, **kw)


# --- CPU ---------------------------------------------------------------------


@pytest.mark.parametrize("device,method,step_impl,graphed", [
    (CPU, "rodas4", "torch", False),
    (CPU, "rosenbrock23", "torch", False),
    (CUDA, "trbdf2", "torch", False),
    (CUDA, "rosenbrock23", "fused", False),
    (CUDA, "rodas4", "torch", True),
    (CUDA, "rodas3", "torch", True),
    (CUDA, "rosenbrock23", "torch", True),
])
def test_engagement_predicate(device, method, step_impl, graphed):
    assert step_graphed(device, method, step_impl) is graphed


def test_cpu_solve_replays_no_graph():
    with progress.record() as rec:
        _refill(CPU, 6, 4, 1 / 128, 2, torch.float32, None)
    c = rec.read().counters
    assert c["iterations"] > 0
    assert "graph_replays" not in c and "graph_captures" not in c


@pytest.mark.parametrize("method", ["rodas4", "trbdf2"])
def test_one_step_from_the_initial_state(method):
    """One step from :meth:`_SolverCtx.initial_state` moves every active
    lane by one counted step and returns the state with its flags."""
    ctx = _SolverCtx(tg.base_system(), 10.0, 5.0, 2, 1e-4, 1e-7, 1.0,
                     torch.float64, CPU, None, method, "torch")
    p = tg.Params.unpack(_members(2))
    st = ctx.initial_state(tg.default_co(device=CPU)[:, None].expand(5, 2),
                           p, 1e-5)
    lp = ctx.lane_params(p)
    active = torch.ones(2, dtype=torch.bool)
    new, ok = ctx.step(ctx.make_f(lp), lp, 1.0, active, st)
    assert isinstance(new, batch_stiff.LaneState)
    assert bool((new.nacc + new.nrej == 1).all()) and bool(ok.all())


@pytest.fixture(scope="module")
def cpu_eager():
    """The eager refill and pulse chase, float64 state and float32 linear
    algebra, three saves."""
    with pytest.MonkeyPatch.context() as mp:
        _eager(mp)
        return dict(refill=_refill(CPU, 6, 4, 1 / 128, 3, torch.float64,
                                   torch.float32),
                    chase=_pulse_chase(CPU, 3, 1 / 128))


def test_plumbing_gives_the_eager_bits(cpu_eager, monkeypatch,
                                       no_idle_graphs):
    """Two refill solves of one key through the static buffers: the
    eager bits, one capture, a replay for every step."""
    _graphed(monkeypatch)
    calls = _count_steps(monkeypatch)
    with progress.record() as rec:
        first = _refill(CPU, 6, 4, 1 / 128, 3, torch.float64, torch.float32)
        second = _refill(CPU, 6, 4, 1 / 128, 3, torch.float64, torch.float32)
    _assert_same_bits(first, cpu_eager["refill"])
    _assert_same_bits(second, cpu_eager["refill"])
    c = rec.read().counters
    assert c["graph_captures"] == 1
    assert c["graph_replays"] == len(calls) == c["iterations"]


def test_plumbing_pulse_chase_gives_the_eager_bits(cpu_eager, monkeypatch,
                                                   no_idle_graphs):
    """The chunked scheduler's two legs share one graph (the leg end is a
    static input), and its returned step counts outlive the graph's next
    replay."""
    _graphed(monkeypatch)
    first = _pulse_chase(CPU, 3, 1 / 128)
    _pulse_chase(CPU, 3, 1 / 128)
    _assert_same_bits(first, cpu_eager["chase"])
    assert len(batch_stiff._IDLE_GRAPHS) == 1


def test_idle_graphs_are_bounded(monkeypatch, no_idle_graphs):
    """Solves of more keys than the cache keeps leave the newest keys'
    graphs idle."""
    _graphed(monkeypatch)
    monkeypatch.setattr(batch_stiff, "MAX_IDLE_GRAPHS", 2)
    for lanes in (1, 2, 3):
        _refill(CPU, 3, lanes, 1 / 1024, 2, torch.float32, None)
    assert [k[1] for k in batch_stiff._IDLE_GRAPHS] == [2, 3]


def test_threads_never_share_a_graph(monkeypatch, no_idle_graphs):
    """Twelve threads take and give back graphs of one key, with a short
    switch interval: no graph is held by two at once, no more are
    captured than are held at once, and every one ends idle (the mesh's
    slots each hold their own)."""
    _graphed(monkeypatch)
    monkeypatch.setattr(batch_stiff, "MAX_IDLE_GRAPHS", 64)
    ctx = _SolverCtx(tg.base_system(), 10.0, 5.0, 2, 1e-4, 1e-7, 1.0,
                     torch.float32, CPU, None, "rodas4", "torch")
    z = torch.zeros(2)
    st = batch_stiff.LaneState(t=z, h=z, y=torch.zeros(3, 10, 2), nts=z,
                               out_C=z, out_m=z, nacc=z.int(), nrej=z.int(),
                               failed=z.bool())
    lp = ctx.lane_params(tg.Params.unpack(_members(2).float()))
    held, seen, lock, errors = set(), set(), threading.Lock(), []

    def work():
        try:
            for _ in range(200):
                mine = copy.copy(ctx)
                g = mine._graph = mine._take_graph(1.0, z.bool(), st, lp)
                with lock:
                    assert id(g) not in held
                    held.add(id(g))
                    seen.add(g)
                with lock:
                    held.discard(id(g))
                mine.release_graph()
        except BaseException as e:  # noqa: BLE001 (re-raised below)
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    (idle,) = batch_stiff._IDLE_GRAPHS.values()
    assert set(map(id, idle)) == set(map(id, seen))
    assert 1 <= len(idle) <= 12


# --- the card ----------------------------------------------------------------

CARD_CASES = {
    "f32_nts2": (torch.float32, None, 2),
    "f32_nts100": (torch.float32, None, 100),
    "f64mix_nts2": (torch.float64, torch.float32, 2),
    "f64mix_nts100": (torch.float64, torch.float32, 100),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_refill_graph_gives_the_eager_bits(cuda, case, monkeypatch,
                                           no_idle_graphs):
    """96 posterior-like members over 64 lanes at the production grid:
    the graphed refill returns the eager refill's bits."""
    state, ls, Nts = CARD_CASES[case]
    run = dict(n=96, lanes=64, tf=0.5, Nts=Nts, state=state, ls=ls, dr=0.2)
    with monkeypatch.context() as mp:
        _eager(mp)
        eager = _refill(cuda, **run)
    with progress.record() as rec:
        graphed = _refill(cuda, **run)
    _assert_same_bits(graphed, eager)
    c = rec.read().counters
    assert c["graph_captures"] == 1
    assert c["graph_replays"] == c["iterations"]


@pytest.mark.gpu
def test_pulse_chase_graph_gives_the_eager_bits(cuda, monkeypatch,
                                                no_idle_graphs):
    with monkeypatch.context() as mp:
        _eager(mp)
        eager = _pulse_chase(cuda, 16, 0.25, dr=0.5)
    _assert_same_bits(_pulse_chase(cuda, 16, 0.25, dr=0.5), eager)


@pytest.mark.gpu
def test_one_capture_serves_two_solves(cuda, monkeypatch, no_idle_graphs):
    calls = _count_steps(monkeypatch)
    run = dict(n=12, lanes=8, tf=0.1, Nts=2, state=torch.float32, ls=None)
    with progress.record() as rec:
        first = _refill(cuda, **run)
        second = _refill(cuda, **run)
    _assert_same_bits(first, second)
    c = rec.read().counters
    assert c["graph_captures"] == 1
    assert c["graph_replays"] == len(calls) == c["iterations"]


@pytest.mark.gpu
@pytest.mark.parametrize("method,kw", [
    ("rosenbrock23", {}),
    ("rodas3", {}),
    ("rodas4", dict(rhs_mixed="df32")),
    ("rodas4", dict(rhs_mixed=True)),
])
def test_other_bodies_give_the_eager_bits(cuda, method, kw, monkeypatch,
                                          no_idle_graphs):
    """The other tableaus and the float32-pair right-hand sides capture
    too: their bodies read nothing on the host."""
    run = dict(n=6, lanes=4, tf=0.05, Nts=2, state=torch.float64, ls=None,
               method=method, **kw)
    with monkeypatch.context() as mp:
        _eager(mp)
        eager = _refill(cuda, **run)
    with progress.record() as rec:
        graphed = _refill(cuda, **run)
    _assert_same_bits(graphed, eager)
    assert rec.read().counters["graph_replays"] > 0


@pytest.mark.gpu
def test_two_mesh_slots_on_one_card(cuda, monkeypatch, no_idle_graphs):
    """Two worker threads on cuda:0, each a refill queue holding a graph
    of its own: the eager bits."""
    from gab1_shp2_tpu_torch.parallel.mesh import ensemble_mesh

    batch = _members(16, seed=4)
    kw = dict(solver="stiff", extract=lambda s: s.PG1Stot[-1], dr=0.5,
              tf=0.25, Nts=2, rtol=1e-4, atol=1e-7, method="rodas4",
              chunk=4, device_axis="ensemble",
              mesh=ensemble_mesh(["cuda:0", "cuda:0"]))
    co = tg.default_co(device=cuda)
    with monkeypatch.context() as mp:
        _eager(mp)
        eager = tg.run_ensemble(tg.base_system(), co, batch, **kw)
    with progress.record() as rec:
        graphed = tg.run_ensemble(tg.base_system(), co, batch, **kw)
    _assert_same_bits(graphed, eager)
    assert bool(graphed[1].all())
    c = rec.read().counters
    assert 1 <= c["graph_captures"] <= 2
    assert c["graph_replays"] == c["iterations"]
