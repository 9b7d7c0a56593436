"""Forward-mode derivatives with a batch of tangents, by dual numbers.

``value_and_fwd_grad(f, x)`` returns ``f(x)`` and its gradient from one
evaluation of ``f`` on a :class:`FwdDual`: a value ``v`` and a tangent
``d`` of shape ``(K,) + v.shape``, one row per input coordinate.  It
computes what ``torch.func.vmap(torch.func.jvp)`` over the basis does
(the JAX package's ``jax.vmap(jax.jvp)``), in the same order of
operations on the value path.  ``torch.func``'s forward mode gives the
same numbers but runs a Python meta function for every operation that
mixes a tangent-carrying operand with a constant one (most of the stiff
solver's operations), which makes its gradient of the single-member
stiff solve slower (``python -m gab1_shp2_tpu_torch.tools.dual_timing``
times both).

The Jacobian bands (``ops/jacobian.lane_bands``) are built with the
same class, one tangent per seed.  Inside a gradient evaluation those
seeds ride on values that carry the gradient's tangents, so duals nest:
each dual has a ``level``, a dual of a higher level may hold duals of a
lower one as its value and tangents, and an operation treats an operand
of a lower level as a constant of its own.

The class covers the operations of the single-member stiff solve, the
rate functions, the observables and the log densities (element-wise
arithmetic, indexing, ``cat``/``stack``, ``where``, ``einsum``,
``matmul``, reductions and shape methods).  An operation it does not
cover raises ``TypeError``; nothing falls back silently.  Tangent rules
follow JAX's ``jvp`` rules, including the halved tangents of
``maximum``/``minimum`` at ties.
"""

from __future__ import annotations

import math
import numbers

import torch

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


def level(*xs) -> int:
    """The highest dual level among ``xs`` (0 when none is a dual)."""
    return max((x.level for x in xs if isinstance(x, FwdDual)), default=0)


def _primal(x):
    while isinstance(x, FwdDual):
        x = x.v
    return x


def _ndim(x) -> int:
    return x.ndim if isinstance(x, (torch.Tensor, FwdDual)) else 0


def _lift(d, nd: int):
    """A tangent ``(K,) + s`` with singleton axes inserted after K so
    that it broadcasts against values of rank ``nd``."""
    extra = nd - (d.ndim - 1)
    if extra <= 0:
        return d
    return d.reshape(d.shape[:1] + (1,) * extra + d.shape[1:])


def _spread(d, v):
    """A tangent lifted and broadcast to the shape of the value ``v``."""
    K = d.shape[0]
    d = _lift(d, v.ndim)
    shape = (K,) + tuple(v.shape)
    return d if d.shape == shape else d.expand(shape)


def _dim(dim: int) -> int:
    """A value axis as the tangent's axis."""
    return dim + 1 if dim >= 0 else dim


_ALL = slice(None)


def _index(idx):
    return (_ALL,) + (idx if isinstance(idx, tuple) else (idx,))


def _tie_weights(x, y, ans):
    """JAX's ``_balanced_eq``: the share of the tangent of ``x`` in
    ``max``/``min(x, y)``: 1 where x alone attains it, 1/2 at a tie."""
    x, y, ans = _primal(x), _primal(y), _primal(ans)
    xe = (x == ans)
    ye = (y == ans)
    one = torch.ones((), dtype=ans.dtype, device=ans.device)
    return torch.where(xe, torch.where(ye, 0.5 * one, one), 0.0 * one)


class FwdDual:
    """A value ``v`` and ``K`` tangents ``d`` of shape ``(K,) + v.shape``
    at nesting level ``level``.

    Plain tensors, Python numbers and duals of a lower level mixed in
    are constants.  Branch conditions read the primal value
    (comparisons return plain boolean tensors; ``bool``/``float`` read
    it).
    """

    __slots__ = ("v", "d", "level")

    def __init__(self, v, d, level: int = 1):
        self.v, self.d, self.level = v, d, level

    def _new(self, v, d):
        return FwdDual(v, d, self.level)

    def _live(self, x) -> bool:
        """Whether ``x`` carries tangents of this dual's level."""
        return type(x) is FwdDual and x.level == self.level

    # --- attributes of the value ----------------------------------------
    @property
    def shape(self):
        return self.v.shape

    @property
    def ndim(self):
        return self.v.ndim

    @property
    def dtype(self):
        return self.v.dtype

    @property
    def device(self):
        return self.v.device

    def __float__(self):
        return float(self.v)

    def __bool__(self):
        return bool(self.v)

    def __repr__(self):
        return f"FwdDual(v={self.v!r}, d={self.d!r}, level={self.level})"

    @property
    def K(self) -> int:
        return self.d.shape[0]

    # --- indexing ---------------------------------------------------------
    def __getitem__(self, idx):
        didx = (_ALL,) + idx if type(idx) is tuple else (_ALL, idx)
        return FwdDual(self.v[idx], self.d[didx], self.level)

    def __setitem__(self, idx, val):
        # in place on this dual's own storage (callers clone first, as
        # Params.replace does)
        if self._live(val):
            self.v[idx] = val.v
            self.d[_index(idx)] = _lift(val.d, _ndim(self.v[idx]))
        else:
            self.v[idx] = val
            self.d[_index(idx)] = 0.0

    # --- arithmetic -------------------------------------------------------
    # an operand of another class gets NotImplemented; an operand of a
    # higher level takes over through its reflected operator, with this
    # dual as its constant (reflected operators only ever see constants).
    # A result's rank is the larger operand rank, so tangents are lifted
    # to the result's rank; a constant operand's tangent is zero, so
    # addition broadcasts this dual's tangent to the result's shape.
    def __add__(a, b):
        if type(b) is FwdDual:
            if b.level == a.level:
                v = a.v + b.v
                nd = v.ndim
                return FwdDual(v, _lift(a.d, nd) + _lift(b.d, nd), a.level)
            if b.level > a.level:
                return b.__radd__(a)
        elif not isinstance(b, _OPERAND):
            return NotImplemented
        v = a.v + b
        return FwdDual(v, _spread(a.d, v), a.level)

    def __radd__(a, b):
        if not isinstance(b, _OPERAND):
            return NotImplemented
        v = b + a.v
        return FwdDual(v, _spread(a.d, v), a.level)

    def __sub__(a, b):
        if type(b) is FwdDual:
            if b.level == a.level:
                v = a.v - b.v
                nd = v.ndim
                return FwdDual(v, _lift(a.d, nd) - _lift(b.d, nd), a.level)
            if b.level > a.level:
                return b.__rsub__(a)
        elif not isinstance(b, _OPERAND):
            return NotImplemented
        v = a.v - b
        return FwdDual(v, _spread(a.d, v), a.level)

    def __rsub__(a, b):
        if not isinstance(b, _OPERAND):
            return NotImplemented
        v = b - a.v
        return FwdDual(v, -_spread(a.d, v), a.level)

    def __neg__(a):
        return FwdDual(-a.v, -a.d, a.level)

    def __mul__(a, b):
        if type(b) is FwdDual:
            if b.level == a.level:
                v = a.v * b.v
                nd = v.ndim
                return FwdDual(v, _lift(a.d, nd) * b.v + a.v * _lift(b.d, nd),
                               a.level)
            if b.level > a.level:
                return b.__rmul__(a)
        elif not isinstance(b, _OPERAND):
            return NotImplemented
        v = a.v * b
        return FwdDual(v, _lift(a.d, v.ndim) * b, a.level)

    def __rmul__(a, b):
        if not isinstance(b, _OPERAND):
            return NotImplemented
        v = b * a.v
        return FwdDual(v, b * _lift(a.d, v.ndim), a.level)

    def __truediv__(a, b):
        if type(b) is FwdDual:
            if b.level == a.level:
                q = a.v / b.v
                nd = q.ndim
                return FwdDual(q, _lift(a.d, nd) / b.v
                               - _lift(b.d, nd) * (q / b.v), a.level)
            if b.level > a.level:
                return b.__rtruediv__(a)
        elif not isinstance(b, _OPERAND):
            return NotImplemented
        v = a.v / b
        return FwdDual(v, _lift(a.d, v.ndim) / b, a.level)

    def __rtruediv__(a, b):
        if not isinstance(b, _OPERAND):
            return NotImplemented
        q = b / a.v
        return FwdDual(q, -_lift(a.d, q.ndim) * (q / a.v), a.level)

    def __pow__(a, n):
        if not isinstance(n, numbers.Number):
            raise TypeError("FwdDual ** supports a number exponent only")
        return a._new(a.v**n, a.d * (n * a.v ** (n - 1)))

    def __matmul__(a, b):
        if type(b) is FwdDual:
            if b.level > a.level:
                return b.__rmatmul__(a)
        elif not isinstance(b, _OPERAND):
            return NotImplemented
        return _matmul(a, b)

    def __rmatmul__(a, b):
        if not isinstance(b, _OPERAND):
            return NotImplemented
        return _matmul(b, a)

    # comparisons read the primal value
    def __lt__(a, b):
        return _primal(a) < _primal(b)

    def __le__(a, b):
        return _primal(a) <= _primal(b)

    def __gt__(a, b):
        return _primal(a) > _primal(b)

    def __ge__(a, b):
        return _primal(a) >= _primal(b)

    # --- element-wise functions -------------------------------------------
    def abs(a):
        return a._new(a.v.abs(), a.d * torch.sign(_primal(a)))

    def sqrt(a):
        s = torch.sqrt(a.v)
        return a._new(s, a.d * (0.5 / s))

    def exp(a):
        e = torch.exp(a.v)
        return a._new(e, a.d * e)

    def log(a):
        return a._new(torch.log(a.v), a.d / a.v)

    def log_ndtr(a):
        ln = torch.special.log_ndtr(a.v)
        return a._new(ln, a.d * torch.exp(-0.5 * a.v**2 - _LOG_SQRT_2PI
                                          - ln))

    def clamp(a, min=None, max=None):
        v = torch.clamp(a.v, min=min, max=max)
        p = _primal(a)
        keep = torch.ones_like(p, dtype=torch.bool)
        if min is not None:
            keep = keep & (p >= _primal(min))
        if max is not None:
            keep = keep & (p <= _primal(max))
        return a._new(v, torch.where(keep, a.d, 0.0))

    # --- reductions ---------------------------------------------------------
    def sum(a, dim=None, keepdim=False):
        if dim is None:
            return a._new(a.v.sum(), a.d.reshape(a.K, -1).sum(dim=1))
        dims = tuple(_dim(x) for x in (dim if isinstance(dim, tuple)
                                       else (dim,)))
        return a._new(a.v.sum(dim=dim, keepdim=keepdim),
                      a.d.sum(dim=dims, keepdim=keepdim))

    def mean(a, dim=None, keepdim=False):
        if dim is None:
            return a._new(a.v.mean(), a.d.reshape(a.K, -1).mean(dim=1))
        dims = tuple(_dim(x) for x in (dim if isinstance(dim, tuple)
                                       else (dim,)))
        return a._new(a.v.mean(dim=dim, keepdim=keepdim),
                      a.d.mean(dim=dims, keepdim=keepdim))

    # --- shape and placement ------------------------------------------------
    def to(self, *args, **kwargs):
        return self._new(self.v.to(*args, **kwargs),
                         self.d.to(*args, **kwargs))

    def clone(self):
        return self._new(self.v.clone(), self.d.clone())

    def reshape(self, *shape):
        v = self.v.reshape(*shape)
        return self._new(v, self.d.reshape((self.K,) + v.shape))

    def expand(self, *shape):
        v = self.v.expand(*shape)
        return self._new(v, _lift(self.d, v.ndim).expand((self.K,)
                                                         + v.shape))

    def repeat(self, *reps):
        if len(reps) == 1 and isinstance(reps[0], (tuple, list)):
            reps = tuple(reps[0])
        if len(reps) != self.v.ndim:
            raise TypeError("FwdDual.repeat needs one count per axis")
        return self._new(self.v.repeat(*reps), self.d.repeat(1, *reps))

    def movedim(self, src, dst):
        return self._new(self.v.movedim(src, dst),
                         self.d.movedim(_dim(src), _dim(dst)))

    def permute(self, *dims):
        if len(dims) == 1 and isinstance(dims[0], (tuple, list)):
            dims = tuple(dims[0])
        nd = self.v.ndim
        return self._new(self.v.permute(*dims),
                         self.d.permute(0, *[x % nd + 1 for x in dims]))

    @property
    def T(self):
        nd = self.v.ndim
        return self.permute(*reversed(range(nd)))

    def new_zeros(self, *a, **kw):
        return self.v.new_zeros(*a, **kw)

    # --- torch functions ----------------------------------------------------
    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        rule = _RULES.get(func)
        if rule is None:
            # Tensor (op) FwdDual: a TypeError makes Python fall back to
            # FwdDual's reflected operator
            raise TypeError(f"{func} is not defined on FwdDual")
        return rule(*args, **(kwargs or {}))


def _top(*xs) -> FwdDual:
    """The first operand of the highest level."""
    L = level(*xs)
    return next(x for x in xs if isinstance(x, FwdDual) and x.level == L)


def _split(x, top: FwdDual):
    """(value, tangent or None) of ``x`` at ``top``'s level."""
    if top._live(x):
        return x.v, x.d
    return x, None


def _matmul(a, b):
    """``a @ b`` at the higher operand's level; vectors are promoted to
    matrices as ``torch.matmul`` does."""
    if _ndim(a) == 1 and _ndim(b) == 1:
        return _matmul(a[None, :], b[:, None])[0, 0]
    if _ndim(a) == 1:
        return _matmul(a[None, :], b)[..., 0, :]
    if _ndim(b) == 1:
        return _matmul(a, b[:, None])[..., 0]
    top = _top(a, b)
    av, ad = _split(a, top)
    bv, bd = _split(b, top)
    nd = max(_ndim(av), _ndim(bv))
    d = None if bd is None else av @ _lift(bd, nd)
    if ad is not None:
        d = _lift(ad, nd) @ bv if d is None else _lift(ad, nd) @ bv + d
    return top._new(av @ bv, d)


def _cat_like(func):
    def rule(seq, dim=0, **kw):
        seq = list(seq)
        top = _top(*seq)
        vs, ds = [], []
        for x in seq:
            xv, xd = _split(x, top)
            vs.append(xv)
            ds.append(xd if xd is not None else
                      x.new_zeros((top.K,) + tuple(x.shape)))
        return top._new(func(vs, dim, **kw), func(ds, _dim(dim), **kw))
    return rule


def _where(cond, a, b):
    top = _top(a, b)
    av, ad = _split(a, top)
    bv, bd = _split(b, top)
    v = torch.where(cond, av, bv)
    nd = _ndim(v)
    ta = 0.0 if ad is None else _lift(ad, nd)
    tb = 0.0 if bd is None else _lift(bd, nd)
    d = torch.where(cond, ta, tb)
    return top._new(v, d.expand((top.K,) + tuple(v.shape)))


def _extreme(func):
    def rule(a, b):
        top = _top(a, b)
        av, ad = _split(a, top)
        bv, bd = _split(b, top)
        v = func(av, bv)
        nd = _ndim(v)
        terms = [_lift(xd, nd) * _tie_weights(xv, yv, v)
                 for xd, xv, yv in ((ad, av, bv), (bd, bv, av))
                 if xd is not None]
        d = terms[0] if len(terms) == 1 else terms[0] + terms[1]
        return top._new(v, d.expand((top.K,) + tuple(v.shape)))
    return rule


def _einsum(eq, *ops):
    if len(ops) == 1 and isinstance(ops[0], (list, tuple)):
        ops = tuple(ops[0])
    ins, out = eq.replace(" ", "").split("->")
    specs = ins.split(",")
    tl = next(c for c in "ZYXWVUTSRQPONMLKJIHGFEDCBA" if c not in eq)
    top = _top(*ops)
    split = [_split(o, top) for o in ops]
    vals = [s[0] for s in split]
    v = torch.einsum(eq, *vals)
    d = None
    for i, (_, od) in enumerate(split):
        if od is None:
            continue
        sp = list(specs)
        sp[i] = tl + sp[i]
        term = torch.einsum(",".join(sp) + "->" + tl + out,
                            *(vals[:i] + [od] + vals[i + 1:]))
        d = term if d is None else d + term
    return top._new(v, d)


def _trapezoid(y, x, *, dim=-1):
    if level(x) >= level(y):
        raise TypeError("trapezoid with a FwdDual abscissa")
    return y._new(torch.trapezoid(y.v, x, dim=dim),
                  torch.trapezoid(y.d, x, dim=_dim(dim)))


def _on_value(func):
    def rule(x, *a, **kw):
        return func(_primal(x), *a, **kw)
    return rule


_RULES = {
    torch.cat: _cat_like(torch.cat),
    torch.stack: _cat_like(torch.stack),
    torch.where: _where,
    torch.maximum: _extreme(torch.maximum),
    torch.minimum: _extreme(torch.minimum),
    torch.einsum: _einsum,
    torch.matmul: _matmul,
    torch.trapezoid: _trapezoid,
    torch.sqrt: FwdDual.sqrt,
    torch.exp: FwdDual.exp,
    torch.log: FwdDual.log,
    torch.special.log_ndtr: FwdDual.log_ndtr,
    torch.clamp: FwdDual.clamp,
    torch.sum: FwdDual.sum,
    torch.mean: FwdDual.mean,
    torch.isfinite: _on_value(torch.isfinite),
    torch.zeros_like: _on_value(torch.zeros_like),
    torch.full_like: _on_value(torch.full_like),
}


def seed(x, tangents: torch.Tensor, *over) -> FwdDual:
    """``x`` as a dual carrying ``tangents`` ((K,) + x.shape), one level
    above every dual among ``x`` and ``over`` (the other inputs of the
    function it enters)."""
    return FwdDual(x, tangents, level(x, *over) + 1)


def value_and_fwd_grad(f, x: torch.Tensor):
    """``(f(x), grad f(x))`` of a scalar function of a vector ``x`` (n,),
    from one evaluation of ``f`` carrying n tangents (the basis)."""
    n = x.shape[-1]
    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    out = f(seed(x, eye))
    if not isinstance(out, FwdDual):
        return out, torch.zeros_like(x)
    return out.v, out.d.reshape(n)


_OPERAND = (FwdDual, torch.Tensor, numbers.Number)
