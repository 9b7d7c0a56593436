"""No-U-Turn Sampler with dual-averaging warmup, in PyTorch.

Counterpart of ``gab1_shp2_tpu/inference/nuts.py``, which replaces the
reference's ``Turing.sample(model, NUTS(0.65), MCMCDistributed(), 1000,
5)`` (``param_fitting+inference_finitediff.jl:403-408``):

  * iterative multinomial NUTS (Stan-style) with a maximum tree depth
    and a checkpoint stack of the subtrees' left endpoints for the
    within-subtree U-turn checks,
  * dual-averaging step-size adaptation to a target acceptance
    statistic (0.65, as the reference) and a diagonal mass matrix
    (Welford) adopted at the warmup midpoint.

Chains are a leading axis of every state tensor: ``q`` is (C, d), and
the log density maps (C, d) to (C,) (chains are independent; its
gradient comes from autograd, through ``inference/loss.
reverse_differentiable`` for the stiff-solve likelihood).  The JAX
package ``vmap``s one chain's program instead; the stiff solver's
Python control flow reads its values, which ``torch.func.vmap`` refuses.
Each chain owns a ``torch.Generator`` (on the CPU, so a chain draws the
same numbers on any device) and draws from it only while its own tree
grows: a chain's draws, and so its samples, do not depend on the other
chains of the batch.  The draws are not JAX's (another generator), so
runs agree with the JAX package statistically, and the deterministic
pieces (leapfrog, energies, U-turn test, adaptation) elementwise.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from gab1_shp2_tpu_torch.models.params import resolve_device


class NUTSState(NamedTuple):
    q: torch.Tensor          # (C, d) position
    logp: torch.Tensor       # (C,) log density at q
    grad: torch.Tensor       # (C, d) gradient at q
    rng: tuple               # C torch.Generators (CPU)
    step_size: torch.Tensor  # (C,)
    inv_mass: torch.Tensor   # (C, d) diagonal inverse mass matrix
    # dual averaging state
    log_eps_bar: torch.Tensor
    h_bar: torch.Tensor
    mu: torch.Tensor
    # mass adaptation (Welford)
    w_count: torch.Tensor    # (C,) int32
    w_mean: torch.Tensor     # (C, d)
    w_m2: torch.Tensor       # (C, d)

    def to_numpy(self) -> dict:
        """Every field but the generators, as numpy arrays."""
        return {k: v.detach().cpu().numpy()
                for k, v in self._asdict().items() if k != "rng"}

    @classmethod
    def from_numpy(cls, arrays: dict, rng, device=None) -> "NUTSState":
        """A state from numpy arrays (e.g. a JAX ``NUTSState``'s fields
        through ``np.asarray``), with or without a leading chain axis, in
        their dtypes, and the chains' generators (one, or a sequence of
        C).  ``device=None`` puts it on the CUDA card."""
        device = resolve_device(device)
        single = np.ndim(arrays["q"]) == 1

        def t(name):
            a = np.array(arrays[name])
            return torch.as_tensor(a[None] if single else a, device=device)

        gens = (rng,) if isinstance(rng, torch.Generator) else tuple(rng)
        return cls(rng=gens, **{f: t(f) for f in cls._fields if f != "rng"})


class NUTSInfo(NamedTuple):
    accept_stat: torch.Tensor
    diverged: torch.Tensor
    depth: torch.Tensor
    energy: torch.Tensor


def _value_and_grad(logdensity: Callable, q: torch.Tensor):
    """Per-chain log density (C,) and gradient (C, d)."""
    q = q.detach().requires_grad_(True)
    with torch.enable_grad():
        logp = logdensity(q)
        (grad,) = torch.autograd.grad(logp.sum(), q)
    return logp.detach(), grad.detach()


def _generators(rng, C: int) -> tuple:
    if isinstance(rng, torch.Generator):
        rng = (rng,)
    gens = tuple(rng)
    if len(gens) != C:
        raise ValueError(f"{C} chains need {C} generators, got {len(gens)}")
    return gens


def init(logdensity: Callable, q0: torch.Tensor, rng,
         step_size: float = 0.1) -> NUTSState:
    """Chain states at ``q0`` ((C, d), or (d,) for one chain) with one
    generator per chain."""
    q0 = q0.detach()
    if q0.ndim == 1:
        q0 = q0[None]
    C, d = q0.shape
    gens = _generators(rng, C)
    logp, grad = _value_and_grad(logdensity, q0)
    like = dict(dtype=q0.dtype, device=q0.device)
    eps = torch.full((C,), step_size, **like)
    return NUTSState(
        q=q0, logp=logp, grad=grad, rng=gens, step_size=eps,
        inv_mass=torch.ones((C, d), **like),
        log_eps_bar=torch.log(eps), h_bar=torch.zeros((C,), **like),
        mu=torch.log(10.0 * eps),
        w_count=torch.zeros((C,), dtype=torch.int32, device=q0.device),
        w_mean=torch.zeros((C, d), **like), w_m2=torch.zeros((C, d), **like),
    )


def _leapfrog(logdensity, q, p, grad, eps, inv_mass):
    """One leapfrog step of every chain; ``eps`` is (C,)."""
    e = eps[..., None]
    p_half = p + 0.5 * e * grad
    q_new = q + e * inv_mass * p_half
    logp_new, grad_new = _value_and_grad(logdensity, q_new)
    p_new = p_half + 0.5 * e * grad_new
    return q_new, p_new, logp_new, grad_new


def _kinetic(p, inv_mass):
    return 0.5 * torch.sum(p * inv_mass * p, dim=-1)


_MAX_DELTA = 1000.0  # divergence threshold (Stan's default)


class _C(NamedTuple):
    """NUTS trajectory state, one tree per chain: endpoints, the
    multinomial proposal, bookkeeping and the per-draw constants, so a
    doubling is a function of ``_C`` alone."""
    q_minus: torch.Tensor
    p_minus: torch.Tensor
    g_minus: torch.Tensor
    q_plus: torch.Tensor
    p_plus: torch.Tensor
    g_plus: torch.Tensor
    q_prop: torch.Tensor
    logp_prop: torch.Tensor
    g_prop: torch.Tensor
    log_sum_w: torch.Tensor   # log total multinomial weight
    sum_p: torch.Tensor       # sum of momenta (generalized U-turn)
    depth: torch.Tensor
    turning: torch.Tensor
    diverged: torch.Tensor
    sum_accept: torch.Tensor
    n_accept: torch.Tensor
    rng: tuple
    h0: torch.Tensor          # initial Hamiltonian energy
    eps: torch.Tensor         # step size
    inv_mass: torch.Tensor    # diagonal inverse mass


def _is_turning(inv_mass, q_m, p_m, q_p, p_p):
    dq = q_p - q_m
    return ((torch.sum(dq * (inv_mass * p_m), dim=-1) < 0)
            | (torch.sum(dq * (inv_mass * p_p), dim=-1) < 0))


def _uniform(gens, mask, like) -> torch.Tensor:
    """One uniform [0, 1) draw from the generator of every chain in
    ``mask`` (the others draw nothing and get 1)."""
    out = [torch.rand((), generator=g, dtype=torch.float64).item()
           if bool(m) else 1.0 for g, m in zip(gens, mask.tolist())]
    return torch.as_tensor(out, dtype=like.dtype, device=like.device)


def _tree_init(state: NUTSState) -> Tuple[_C, tuple]:
    """Sample the momenta and open fresh (depth-0) trajectories.  Returns
    ``(c, rng)``; ``rng`` seeds the post-draw state in
    :func:`_tree_finish`."""
    C, d = state.q.shape
    p0 = torch.stack([torch.randn((d,), generator=g, dtype=torch.float64)
                      for g in state.rng]).to(state.q)
    p0 = p0 / torch.sqrt(state.inv_mass)
    H0 = -state.logp + _kinetic(p0, state.inv_mass)
    zeros = torch.zeros((C,), dtype=state.q.dtype, device=state.q.device)
    false = torch.zeros((C,), dtype=torch.bool, device=state.q.device)
    c = _C(
        q_minus=state.q, p_minus=p0, g_minus=state.grad,
        q_plus=state.q, p_plus=p0, g_plus=state.grad,
        q_prop=state.q, logp_prop=state.logp, g_prop=state.grad,
        log_sum_w=zeros, sum_p=p0,
        depth=torch.zeros((C,), dtype=torch.int32, device=state.q.device),
        turning=false, diverged=false, sum_accept=zeros, n_accept=zeros,
        rng=state.rng, h0=H0, eps=state.step_size, inv_mass=state.inv_mass,
    )
    return c, state.rng


def _tree_cond(c: _C, max_depth: int) -> torch.Tensor:
    """(C,) mask of the chains whose tree still grows."""
    return (c.depth < max_depth) & ~c.turning & ~c.diverged


def _sel(mask, a, b):
    """Per-chain select over a leading chain axis."""
    return torch.where(mask.reshape(mask.shape + (1,) * (a.ndim - 1)), a, b)


def _tree_extend(logdensity: Callable, c: _C, *, max_depth: int) -> _C:
    """One trajectory doubling (up to ``2**depth`` leapfrog leaves) of
    every chain whose tree still grows; finished chains are returned
    unchanged and draw nothing."""
    active = _tree_cond(c, max_depth)
    eps, inv_mass, H0 = c.eps, c.inv_mass, c.h0
    C, d = c.q_prop.shape
    dev, qdt = c.q_prop.device, c.q_prop.dtype
    gens = c.rng

    go_right = _uniform(gens, active, c.h0) < 0.5
    n_steps = torch.where(active, 2 ** c.depth.to(torch.int64), 0)

    # starting endpoint of the new subtree
    q = _sel(go_right, c.q_plus, c.q_minus)
    p = _sel(go_right, c.p_plus, c.p_minus)
    g = _sel(go_right, c.g_plus, c.g_minus)
    direction = torch.where(go_right, 1.0, -1.0).to(qdt)[:, None]

    # the subtree, built leaf by leaf with progressive multinomial
    # sampling and incremental U-turn checks against a stack of the
    # aligned subtrees' start states
    i = torch.zeros((C,), dtype=torch.int64, device=dev)
    q_prop, logp_prop, g_prop = c.q_prop, torch.full_like(c.h0, -math.inf), \
        c.g_prop
    log_sum_w_sub = torch.full_like(c.h0, -math.inf)
    sum_p_sub = torch.zeros_like(p)
    stack_q = torch.zeros((C, max_depth, d), dtype=qdt, device=dev)
    stack_p = torch.zeros_like(stack_q)
    turning = torch.zeros((C,), dtype=torch.bool, device=dev)
    diverged = torch.zeros_like(turning)
    sum_accept = torch.zeros_like(c.h0)
    n_accept = torch.zeros_like(c.h0)
    levels = torch.arange(max_depth, device=dev)
    pow2 = 2 ** levels

    while True:
        leaf = (i < n_steps) & ~turning & ~diverged
        if not bool(leaf.any()):
            break
        idx = leaf.nonzero()[:, 0]
        qn, pn, logpn, gn = _leapfrog(logdensity, q[idx],
                                      direction[idx] * p[idx], g[idx],
                                      eps[idx], inv_mass[idx])
        pn = direction[idx] * pn

        def put(full, part):
            return full.index_copy(0, idx, part)

        q_l, p_l, logp_l, g_l = put(q, qn), put(p, pn), \
            put(torch.zeros_like(c.h0), logpn), put(g, gn)
        H = -logp_l + _kinetic(p_l, inv_mass)
        delta = H - H0
        # a non-finite energy error (NaN log density or gradient from a
        # failed solve, inf from overflow) is a divergence and acts like
        # one: zero multinomial weight, zero acceptance; a NaN left in
        # would poison the dual averaging for good
        delta = torch.where(torch.isfinite(delta), delta, math.inf)
        div_l = delta > _MAX_DELTA
        log_w = -delta
        accept_p = torch.clamp(torch.exp(-delta), max=1.0)

        # progressive multinomial sampling within the subtree
        new_sum = torch.logaddexp(log_sum_w_sub, log_w)
        u = _uniform(gens, leaf, c.h0)
        take = (torch.log(u) < (log_w - new_sum)) & leaf

        # leaf i starts the aligned subtrees at every level l with
        # i % 2^l == 0 and ends those at levels l >= 1 with
        # (i+1) % 2^l == 0: U-turn checks against their stored starts
        push = ((i[:, None] % pow2) == 0) & leaf[:, None]
        stack_q = torch.where(push[..., None], q_l[:, None, :], stack_q)
        stack_p = torch.where(push[..., None], p_l[:, None, :], stack_p)
        i1 = i + 1
        complete = (levels >= 1) & ((i1[:, None] % pow2) == 0)
        fwd = direction > 0
        qa = torch.where(fwd[..., None], stack_q, q_l[:, None, :])
        pa = torch.where(fwd[..., None], stack_p, p_l[:, None, :])
        qb = torch.where(fwd[..., None], q_l[:, None, :], stack_q)
        pb = torch.where(fwd[..., None], p_l[:, None, :], stack_p)
        turn_l = _is_turning(inv_mass[:, None, :], qa, pa, qb, pb)
        turn_new = turning | (complete & turn_l).any(dim=-1)

        q_prop = _sel(take, q_l, q_prop)
        logp_prop = torch.where(take, logp_l, logp_prop)
        g_prop = _sel(take, g_l, g_prop)
        log_sum_w_sub = torch.where(leaf, new_sum, log_sum_w_sub)
        sum_p_sub = _sel(leaf, sum_p_sub + p_l, sum_p_sub)
        q, p, g = _sel(leaf, q_l, q), _sel(leaf, p_l, p), _sel(leaf, g_l, g)
        turning = torch.where(leaf, turn_new, turning)
        diverged = torch.where(leaf, diverged | div_l, diverged)
        sum_accept = torch.where(leaf, sum_accept + accept_p, sum_accept)
        n_accept = torch.where(leaf, n_accept + 1.0, n_accept)
        i = torch.where(leaf, i1, i)

    # biased progressive sampling between the old trajectory and the
    # subtree
    u = _uniform(gens, active, c.h0)
    log_ratio = log_sum_w_sub - c.log_sum_w
    ok = ~turning & ~diverged
    take_sub = (torch.log(u) < log_ratio) & ok
    q_prop = _sel(take_sub, q_prop, c.q_prop)
    logp_prop = torch.where(take_sub, logp_prop, c.logp_prop)
    g_prop = _sel(take_sub, g_prop, c.g_prop)

    log_sum_w = torch.where(ok, torch.logaddexp(c.log_sum_w, log_sum_w_sub),
                            c.log_sum_w)
    sum_p = c.sum_p + _sel(ok, sum_p_sub, torch.zeros_like(sum_p_sub))

    q_minus = _sel(go_right, c.q_minus, q)
    p_minus = _sel(go_right, c.p_minus, p)
    g_minus = _sel(go_right, c.g_minus, g)
    q_plus = _sel(go_right, q, c.q_plus)
    p_plus = _sel(go_right, p, c.p_plus)
    g_plus = _sel(go_right, g, c.g_plus)

    turning_tot = turning | (ok & _is_turning(inv_mass, q_minus, p_minus,
                                              q_plus, p_plus))
    new = _C(
        q_minus=q_minus, p_minus=p_minus, g_minus=g_minus,
        q_plus=q_plus, p_plus=p_plus, g_plus=g_plus,
        q_prop=q_prop, logp_prop=logp_prop, g_prop=g_prop,
        log_sum_w=log_sum_w, sum_p=sum_p,
        depth=c.depth + 1, turning=turning_tot, diverged=diverged,
        sum_accept=c.sum_accept + sum_accept,
        n_accept=c.n_accept + n_accept, rng=c.rng,
        h0=c.h0, eps=c.eps, inv_mass=c.inv_mass,
    )
    return _C(*(old if name == "rng" else _sel(active, a, old)
                for name, a, old in zip(_C._fields, new, c)))


def _tree_finish(state: NUTSState, c: _C,
                 rng: tuple) -> Tuple[NUTSState, NUTSInfo]:
    accept_stat = torch.where(c.n_accept > 0,
                              c.sum_accept / torch.clamp(c.n_accept, min=1.0),
                              0.0)
    new_state = state._replace(q=c.q_prop, logp=c.logp_prop, grad=c.g_prop,
                               rng=rng)
    info = NUTSInfo(accept_stat=accept_stat, diverged=c.diverged,
                    depth=c.depth, energy=-c.logp_prop)
    return new_state, info


def _nuts_step(logdensity: Callable, state: NUTSState, *,
               max_depth: int = 10) -> Tuple[NUTSState, NUTSInfo]:
    """One multinomial-NUTS transition of every chain (no adaptation)."""
    c, rng = _tree_init(state)
    while bool(_tree_cond(c, max_depth).any()):
        c = _tree_extend(logdensity, c, max_depth=max_depth)
    return _tree_finish(state, c, rng)


def _adapt(state: NUTSState, info: NUTSInfo, t: int, *,
           target_accept: float, gamma=0.05, t0=10.0, kappa=0.75,
           adapt_mass: bool = True) -> NUTSState:
    """Dual averaging (Hoffman & Gelman 2014) + Welford mass update."""
    tt = torch.as_tensor(t, dtype=state.q.dtype, device=state.q.device) + 1.0
    # a non-finite acceptance statistic counts as "rejected everything"
    acc = torch.where(torch.isfinite(info.accept_stat), info.accept_stat,
                      0.0)
    h_bar = (1.0 - 1.0 / (tt + t0)) * state.h_bar + (
        target_accept - acc) / (tt + t0)
    log_eps = state.mu - torch.sqrt(tt) / gamma * h_bar
    w = tt ** (-kappa)
    log_eps_bar = w * log_eps + (1.0 - w) * state.log_eps_bar

    n = state.w_count + 1
    delta = state.q - state.w_mean
    mean = state.w_mean + delta / n[:, None]
    m2 = state.w_m2 + delta * (state.q - mean)

    return state._replace(step_size=torch.exp(log_eps), h_bar=h_bar,
                          log_eps_bar=log_eps_bar,
                          w_count=n if adapt_mass else state.w_count,
                          w_mean=mean if adapt_mass else state.w_mean,
                          w_m2=m2 if adapt_mass else state.w_m2)


def _warm_update(state: NUTSState, info: NUTSInfo, t: int, *,
                 num_warmup: int, target_accept: float) -> NUTSState:
    """Post-draw warmup update: dual averaging + Welford, with the
    mass-matrix midpoint adoption at ``t == num_warmup // 2``."""
    state = _adapt(state, info, t, target_accept=target_accept)
    if t != num_warmup // 2:
        return state
    cnt = state.w_count[:, None]
    var = torch.where(cnt > 1,
                      state.w_m2 / torch.clamp(cnt - 1, min=1),
                      torch.ones_like(state.w_m2))
    # restart Welford after adopting the midpoint estimate
    return state._replace(inv_mass=var,
                          w_count=torch.zeros_like(state.w_count),
                          w_mean=torch.zeros_like(state.w_mean),
                          w_m2=torch.zeros_like(state.w_m2))


def make_host_tree_sampler(logdensity: Callable, *, max_depth: int = 10,
                           num_warmup: int = 0,
                           target_accept: float = 0.65):
    """One draw of every chain, one trajectory doubling at a time.

    The JAX package runs its chains' draws as one compiled program and
    built this host-driven form for a runtime that bounds the wall time
    of one device execution.  Here every draw is host-driven anyway, so
    it is :func:`_nuts_step` (plus the warmup update); the function is
    kept for its API.

    Returns ``draw(states, warm_t=None) -> (states, info)``.  Pass
    ``warm_t`` (the warmup iteration index) during adaptation; ``None``
    for posterior draws.
    """

    def draw(states: NUTSState, warm_t=None):
        c, rng = _tree_init(states)
        while bool(_tree_cond(c, max_depth).any()):
            c = _tree_extend(logdensity, c, max_depth=max_depth)
        states, info = _tree_finish(states, c, rng)
        if warm_t is not None:
            states = _warm_update(states, info, int(warm_t),
                                  num_warmup=num_warmup,
                                  target_accept=target_accept)
        return states, info

    return draw


def warmup_block(logdensity: Callable, state: NUTSState, t_start: int, *,
                 num_block: int, num_warmup: int, max_depth: int = 10,
                 target_accept: float = 0.65) -> NUTSState:
    """``num_block`` adaptation steps starting at warmup index
    ``t_start``: warmup in resumable pieces (checkpoint the small
    ``NUTSState`` between blocks).  Finalization (adopting the
    dual-averaged step size) is the caller's once ``t_start +
    num_block`` reaches ``num_warmup``: :func:`warmup_finalize`."""
    for t in range(int(t_start), int(t_start) + int(num_block)):
        state, info = _nuts_step(logdensity, state, max_depth=max_depth)
        state = _warm_update(state, info, t, num_warmup=num_warmup,
                             target_accept=target_accept)
    return state


def warmup_finalize(state: NUTSState) -> NUTSState:
    """Adopt the dual-averaged step size after the last warmup block
    (idempotent: ``log_eps_bar`` is untouched)."""
    return state._replace(step_size=torch.exp(state.log_eps_bar))


def warmup(logdensity: Callable, q0: torch.Tensor, rng, *,
           num_warmup: int = 500, max_depth: int = 10,
           target_accept: float = 0.65,
           init_step_size: float = 0.1) -> NUTSState:
    """Adaptation phase: dual-averaged step size + diagonal mass matrix
    (Welford estimate adopted at the warmup midpoint).  Returns the
    ready-to-sample chain states."""
    state = init(logdensity, q0, rng, step_size=init_step_size)
    state = warmup_block(logdensity, state, 0, num_block=num_warmup,
                         num_warmup=num_warmup, max_depth=max_depth,
                         target_accept=target_accept)
    return warmup_finalize(state)


def sample(logdensity: Callable, state: NUTSState, *,
           num_samples: int = 100, max_depth: int = 10):
    """Draw a block of samples from warmed-up states.

    Returns ``(state, qs (C, num_samples, d), info)``; call repeatedly
    (checkpointing the ``NUTSState``) for resumable long runs.
    """
    qs, acc, div, depth, logp = [], [], [], [], []
    for _ in range(int(num_samples)):
        state, info = _nuts_step(logdensity, state, max_depth=max_depth)
        qs.append(state.q)
        acc.append(info.accept_stat)
        div.append(info.diverged)
        depth.append(info.depth)
        logp.append(state.logp)
    return state, torch.stack(qs, dim=1), {
        "accept_stat": torch.stack(acc, dim=1),
        "diverged": torch.stack(div, dim=1),
        "depth": torch.stack(depth, dim=1),
        "logp": torch.stack(logp, dim=1)}


def run_nuts(logdensity: Callable, q0: torch.Tensor, rng, *,
             num_warmup: int = 500, num_samples: int = 1000,
             max_depth: int = 10, target_accept: float = 0.65,
             init_step_size: float = 0.1):
    """Run NUTS chains from ``q0`` ((C, d) with C generators, or (d,)
    with one).

    Returns ``(samples, info)``: samples (C, num_samples, d), or
    (num_samples, d) for a (d,) ``q0``, with per-draw acceptance
    statistics, divergences, depths and log densities, and the adapted
    step sizes and inverse masses.
    """
    single = q0.ndim == 1
    state = warmup(logdensity, q0, rng, num_warmup=num_warmup,
                   max_depth=max_depth, target_accept=target_accept,
                   init_step_size=init_step_size)
    state, qs, info = sample(logdensity, state, num_samples=num_samples,
                             max_depth=max_depth)
    info = dict(info)
    info["step_size"] = state.step_size
    info["inv_mass"] = state.inv_mass
    if single:
        qs = qs[0]
        info = {k: v[0] for k, v in info.items()}
    return qs, info


def chain_generators(seed: int, n_chains: int) -> Sequence[torch.Generator]:
    """``n_chains`` CPU generators seeded ``seed, seed+1, ...``."""
    return tuple(torch.Generator().manual_seed(int(seed) + c)
                 for c in range(n_chains))
