"""Double-f32 (error-free-transform) arithmetic.

Counterpart of ``gab1_shp2_tpu/ops/df32.py``.  A value is carried as an
unevaluated float32 pair ``hi + lo`` (|lo| <= ulp(hi)/2) and computed
with compensated primitives:

  * ``two_sum``  (Knuth): exact a+b = s + e in 6 f32 operations
  * ``two_prod`` (Dekker split, no FMA dependence): exact a*b = p + e in
    17 f32 operations
  * df32 +, -, *, / built on those (~20 f32 operations each)

Effective precision ~2^-48 relative.  The JAX package built this for a
TPU, which emulates float64; the H100 computes float64 natively, so here
it backs only ``rhs_mixed="df32"`` of the batched stiff solver.

The error-free transforms are exact only if every float32 operation
rounds on its own: each primitive below is a sequence of separate eager
multiplies, adds and subtracts (one rounding each), with no fused call
(``addcmul``, ``lerp``, ...), no compilation and no float64
intermediate.

Reference for the algorithms: Dekker (1971), Knuth TAOCP v2, and the
double-double literature (Hida-Li-Bailey).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

F32 = torch.float32


class DF32(NamedTuple):
    """An unevaluated f32 sum ``hi + lo``; elementwise tensor semantics."""

    hi: torch.Tensor
    lo: torch.Tensor

    # -- arithmetic (operator sugar used by the generic reaction loop)
    def __add__(self, o):
        return add(self, _lift(o, self))

    def __radd__(self, o):
        return add(_lift(o, self), self)

    def __sub__(self, o):
        return sub(self, _lift(o, self))

    def __rsub__(self, o):
        return sub(_lift(o, self), self)

    def __mul__(self, o):
        return mul(self, _lift(o, self))

    def __rmul__(self, o):
        return mul(_lift(o, self), self)

    def __truediv__(self, o):
        return div(self, _lift(o, self))

    def __rtruediv__(self, o):
        return div(_lift(o, self), self)

    def __neg__(self):
        return DF32(-self.hi, -self.lo)

    def __pow__(self, n):
        if not (isinstance(n, int) and n >= 1):
            raise ValueError(f"DF32 powers are positive ints, got {n!r}")
        out = self
        for _ in range(n - 1):
            out = mul(out, self)
        return out

    # -- tensor plumbing (shape ops apply to both halves)
    def __getitem__(self, idx):
        return DF32(self.hi[idx], self.lo[idx])

    @property
    def T(self):
        return DF32(self.hi.T, self.lo.T)

    @property
    def shape(self):
        return self.hi.shape

    @property
    def dtype(self):
        return self.hi.dtype


def _lift(x, like: DF32) -> DF32:
    """A DF32 of ``x`` on ``like``'s device: float64 values (Python
    floats among them) split exactly, others are cast to float32, as the
    JAX package lifts them with 64-bit mode on."""
    if isinstance(x, DF32):
        return x
    if isinstance(x, (int, float)):
        return _scalar(x, like.hi.device)
    x = torch.as_tensor(x, device=like.hi.device)
    if x.dtype == torch.float64:
        return from_f64(x)
    x = x.to(F32)
    return DF32(x, torch.zeros_like(x))


@functools.lru_cache(maxsize=256)
def _scalar(x, device: torch.device) -> DF32:
    """A Python number lifted once per device: building it on a card is a
    copy from the host that waits for the card."""
    dtype = torch.float64 if isinstance(x, float) else torch.int64
    return _lift(torch.tensor(x, dtype=dtype), DF32(
        torch.zeros((), device=device), torch.zeros((), device=device)))


def from_f64(x: torch.Tensor) -> DF32:
    """Split a float64 tensor into an f32 hi + f32 lo pair."""
    hi = x.to(F32)
    lo = (x - hi.to(x.dtype)).to(F32)
    return DF32(hi, lo)


def to_f64(a: DF32) -> torch.Tensor:
    return a.hi.to(torch.float64) + a.lo.to(torch.float64)


def two_sum(a, b):
    """Exact a + b = s + e (Knuth; no magnitude ordering assumed)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def fast_two_sum(a, b):
    """Exact a + b = s + e, REQUIRES |a| >= |b| (Dekker)."""
    s = a + b
    e = b - (s - a)
    return s, e


_SPLITTER = 4097.0  # 2^12 + 1 for f32 (24-bit significand)


def _split(a):
    """Dekker split: a = a_hi + a_lo with 12-bit halves (exact)."""
    t = _SPLITTER * a
    a_hi = t - (t - a)
    return a_hi, a - a_hi


def two_prod(a, b):
    """Exact a * b = p + e without a fused multiply-add."""
    p = a * b
    a_hi, a_lo = _split(a)
    b_hi, b_lo = _split(b)
    e = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo
    return p, e


def add(a: DF32, b: DF32) -> DF32:
    """Double-f32 addition, accurate variant (AccurateDWPlusDW,
    Joldes-Muller-Popescu 2017: relative error ~3u^2 even under full
    cancellation)."""
    s, e = two_sum(a.hi, b.hi)
    t, f = two_sum(a.lo, b.lo)
    s, e = fast_two_sum(s, e + t)
    return DF32(*fast_two_sum(s, e + f))


def sub(a: DF32, b: DF32) -> DF32:
    return add(a, DF32(-b.hi, -b.lo))


def mul(a: DF32, b: DF32) -> DF32:
    p, e = two_prod(a.hi, b.hi)
    e = e + (a.hi * b.lo + a.lo * b.hi)
    return DF32(*fast_two_sum(p, e))


def div(a: DF32, b: DF32) -> DF32:
    """Double-f32 division by one Newton-corrected long division:
    q0 = a_hi/b_hi, remainder r = a - q0*b evaluated in df32,
    q1 = r_hi/b_hi.  ~1 ulp(df32)."""
    q0 = a.hi / b.hi
    r = sub(a, mul(DF32(q0, torch.zeros_like(q0)), b))
    q1 = (r.hi + r.lo) / b.hi
    return DF32(*fast_two_sum(q0, q1))


# -- tensor helpers (apply a torch shape op to both halves) ----------------

def stack(xs, dim=0) -> DF32:
    return DF32(torch.stack([x.hi for x in xs], dim=dim),
                torch.stack([x.lo for x in xs], dim=dim))


def concatenate(xs, dim=0) -> DF32:
    return DF32(torch.cat([x.hi for x in xs], dim=dim),
                torch.cat([x.lo for x in xs], dim=dim))


def moveaxis(a: DF32, s, d) -> DF32:
    return DF32(a.hi.movedim(s, d), a.lo.movedim(s, d))


def where(c, a: DF32, b: DF32) -> DF32:
    return DF32(torch.where(c, a.hi, b.hi), torch.where(c, a.lo, b.lo))


def zeros_like(a: DF32) -> DF32:
    return DF32(torch.zeros_like(a.hi), torch.zeros_like(a.lo))
