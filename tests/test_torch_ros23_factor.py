"""The storage scheme of the fused Rosenbrock23 kernel's factor, emulated
in plain torch and held against ``cr_factor_lanes``/``cr_solve_lanes``.

``csrc/ros23_step.cu`` keeps only what the solves read: no padding rows,
level 0's L and U as 10-vectors plus the two dense boundary blocks, the
odd diagonal blocks inverted in place, the next level's diagonal in the
even row's slot, LDinv and UDinv in the even row's L and U.  The
emulation below follows that scheme slot by slot, so that these tests
show on the CPU that it is exact algebra: the padded reference differs
from it only by products with exact zeros and ones.

The emulation is a design record of the layout, not a test of the kernel:
it never runs the CUDA source, which only the ``gpu`` tests hold.  If the
kernel's layout changes, rewrite or drop the emulation with it; the tests
of ``arena_bytes`` and ``arena_in_shared`` at the end stand on their own.

Tolerances, as relative norm error of the solution of W x = b taken in
float64: 1e-12 in float64 and 1e-5 in float32 (the two sum the same terms;
einsum and the explicit scalings may round in another order).
"""

import numpy as np
import pytest
import torch

import gab1_shp2_tpu_torch as tg
from gab1_shp2_tpu_torch.models.params import Params
from gab1_shp2_tpu_torch.ops import ros23_cuda
from gab1_shp2_tpu_torch.ops.batch_stiff import (
    cr_factor_lanes,
    cr_solve_lanes,
    gj_inv_lanes,
)
from gab1_shp2_tpu_torch.ops.jacobian import BLK, lane_bands
from gab1_shp2_tpu_torch.ops.rhs import effective_diffusivities, kdict
from gab1_shp2_tpu_torch.ops.trbdf2 import _ROS_D

torch.set_num_threads(2)

B = 4
ZERO, DENSE, DIAG = "zero", "dense", "diag"


def _mm(A, akind, Bm, bkind):
    """A @ Bm for (10, 10, B) blocks; a diagonal factor is a (10, B)
    vector and the product a row or column scaling."""
    if akind == DIAG:
        return A[:, None, :] * Bm
    if bkind == DIAG:
        return A * Bm[None, :, :]
    return torch.einsum("ijb,jkb->ikb", A, Bm)


def _mv(A, kind, x):
    if kind == DIAG:
        return A * x
    return torch.einsum("ijb,jb->ib", A, x)


class TrimmedFactor:
    """The kernel's arena, one tensor per region, blocks as (10, 10, B)."""

    def __init__(self, L, D, U):
        NB = D.shape[0]
        self.NB = NB
        self.n = [NB]
        while self.n[-1] > 1:
            self.n.append((self.n[-1] + 1) // 2)
        self.Lv = len(self.n) - 1
        n = self.n
        idx = torch.arange(BLK)
        # level 0: L and U must be diagonal apart from the boundary blocks
        off = ~torch.eye(BLK, dtype=torch.bool)
        for j in range(1, NB - 1):
            assert not L[j][off].any(), j
        for j in range(NB - 2):
            assert not U[j][off].any(), j
        self.d = D.clone()                       # NB diagonal slots
        self.lvec = L[:, idx, idx].clone()       # (NB, 10, B)
        self.uvec = U[:, idx, idx].clone()
        self.lmemb = L[NB - 1].clone()
        self.ulast = U[NB - 2].clone()
        blk = lambda m: D.new_zeros((m, BLK, BLK, D.shape[-1]))
        self.ld0, self.ud0 = blk(n[1]), blk(n[1])
        self.l = {lv: blk(n[lv]) for lv in range(1, self.Lv)}
        self.u = {lv: blk(n[lv]) for lv in range(1, self.Lv)}
        self.blocks = NB + 2 * n[1] + 2 + 2 * sum(n[1:-1])
        self._factor()

    # views of the storage ------------------------------------------------
    def D(self, l, j):
        return self.d[j << l]

    def L(self, l, j):
        if j == 0:
            return None, ZERO
        if l == 0:
            return ((self.lmemb, DENSE) if j == self.NB - 1
                    else (self.lvec[j], DIAG))
        return self.l[l][j], DENSE

    def U(self, l, j):
        if j == self.n[l] - 1:
            return None, ZERO
        if l == 0:
            return ((self.ulast, DENSE) if j == self.NB - 2
                    else (self.uvec[j], DIAG))
        return self.u[l][j], DENSE

    def LDinv(self, l, i):
        return self.ld0[i] if l == 0 else self.l[l][2 * i]

    def UDinv(self, l, i):
        return self.ud0[i] if l == 0 else self.u[l][2 * i]

    # the reduction --------------------------------------------------------
    def _factor(self):
        for l in range(self.Lv):
            n, nt = self.n[l], self.n[l + 1]
            for i in range(n // 2):
                self.D(l, 2 * i + 1).copy_(
                    gj_inv_lanes(self.D(l, 2 * i + 1)))
            for i in range(nt):
                if i > 0:
                    A, kind = self.L(l, 2 * i)
                    self.LDinv(l, i).copy_(
                        _mm(A, kind, self.D(l, 2 * i - 1), DENSE))
                if 2 * i + 1 < n:
                    A, kind = self.U(l, 2 * i)
                    self.UDinv(l, i).copy_(
                        _mm(A, kind, self.D(l, 2 * i + 1), DENSE))
            for i in range(nt):
                odd = 2 * i + 1 < n
                Dn = self.D(l, 2 * i)
                if i > 0:
                    Um, kind = self.U(l, 2 * i - 1)
                    Dn -= _mm(self.LDinv(l, i), DENSE, Um, kind)
                if odd:
                    Lm, kind = self.L(l, 2 * i + 1)
                    Dn -= _mm(self.UDinv(l, i), DENSE, Lm, kind)
                if i > 0:
                    Lm, kind = self.L(l, 2 * i - 1)
                    self.L(l + 1, i)[0].copy_(
                        -_mm(self.LDinv(l, i), DENSE, Lm, kind))
                if odd:
                    Um, kind = self.U(l, 2 * i + 1)
                    if kind != ZERO:
                        self.U(l + 1, i)[0].copy_(
                            -_mm(self.UDinv(l, i), DENSE, Um, kind))
        self.d[0].copy_(gj_inv_lanes(self.d[0]))

    def solve(self, b):
        bs = [b.clone()]
        for l in range(self.Lv):
            n, nt = self.n[l], self.n[l + 1]
            bl = bs[l]
            bn = b.new_zeros((nt,) + b.shape[1:])
            for i in range(nt):
                v = bl[2 * i]
                if i > 0:
                    v = v - _mv(self.LDinv(l, i), DENSE, bl[2 * i - 1])
                if 2 * i + 1 < n:
                    v = v - _mv(self.UDinv(l, i), DENSE, bl[2 * i + 1])
                bn[i] = v
            bs.append(bn)
        bs[self.Lv][0] = _mv(self.d[0], DENSE, bs[self.Lv][0])
        for l in range(self.Lv - 1, -1, -1):
            n, nt = self.n[l], self.n[l + 1]
            bl, xn = bs[l], bs[l + 1]
            for i in range(nt):
                if 2 * i + 1 < n:
                    Lm, lk = self.L(l, 2 * i + 1)
                    r = bl[2 * i + 1] - _mv(Lm, lk, xn[i])
                    Um, uk = self.U(l, 2 * i + 1)
                    if uk != ZERO:
                        r = r - _mv(Um, uk, xn[i + 1])
                    bl[2 * i + 1] = _mv(self.D(l, 2 * i + 1), DENSE, r)
                bl[2 * i] = xn[i]
        return bs[0]


def _w_bands(system, NB, dr, dtype, seed):
    """Bands of W = I - d*h*J on a random state, and a right-hand side."""
    rng = np.random.default_rng(seed)
    p0 = tg.default_params(device="cpu").pack().numpy()
    P = p0[None] * np.exp(rng.normal(0, 0.2, (B, 24)))
    p = Params.unpack(torch.as_tensor(P, dtype=dtype))
    y = torch.as_tensor(rng.uniform(0.1, 5.0, (NB, BLK, B)), dtype=dtype)
    y[-1, 8:] = 0.0
    rj = (torch.arange(NB + 1, dtype=torch.float64) * dr)[1:-1].to(dtype)
    Lb, Db, Ub = lane_bands(system, y, kdict(p.k),
                            effective_diffusivities(system, p), rj, dr)
    h = torch.as_tensor(np.logspace(-3, -1, B), dtype=dtype)
    dh = (_ROS_D * h)[None, None, None, :]
    eye = torch.eye(BLK, dtype=dtype)[None, :, :, None]
    b = torch.as_tensor(rng.normal(0, 1, (NB, BLK, B)), dtype=dtype)
    return -dh * Lb, eye - dh * Db, -dh * Ub, b


def _rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("dr", [1.0, 0.5])
@pytest.mark.parametrize("variant", ["base_system", "rect_system",
                                     "memb_sfk_system"])
def test_trimmed_factor_matches_padded_reduction(variant, dr, dtype, tol):
    system = getattr(tg, variant)()
    NB = int(round(10.0 / dr))
    L, D, U, b = _w_bands(system, NB, dr, dtype, seed=11)
    want = cr_solve_lanes(cr_factor_lanes(L, D, U), b)
    got = TrimmedFactor(L, D, U).solve(b)
    assert torch.isfinite(got).all()
    assert _rel(got, want) <= tol


@pytest.mark.parametrize("NB", [2, 3, 5, 9, 13])
def test_trimmed_factor_takes_any_row_count(NB):
    """Odd and even row counts put the dense boundary blocks on odd or
    even rows of level 0, and leave levels with a last even row that has
    no odd partner."""
    L, D, U, b = _w_bands(tg.base_system(), NB, 1.0, torch.float64, seed=NB)
    want = cr_solve_lanes(cr_factor_lanes(L, D, U), b)
    got = TrimmedFactor(L, D, U).solve(b)
    assert _rel(got, want) <= 1e-12


@pytest.mark.parametrize("NB,nbytes,shared", [
    (50, 103_680, True),      # dr=0.2: two blocks fit an SM
    (100, 205_680, True),     # dr=0.1: one block an SM
    (200, 409_680, False),    # dr=0.05: global arena
    (113, 233_440, False),    # the first row count that leaves shared memory
    (2, 3_240, True),
])
def test_arena_bytes_and_choice(NB, nbytes, shared):
    """The wrapper's arena size and choice against the header note of
    csrc/ros23_step.cu; the block count against the emulation's."""
    assert ros23_cuda.arena_bytes(NB) == nbytes
    assert ros23_cuda.arena_in_shared(NB) is shared
    n = [NB]
    while n[-1] > 1:
        n.append((n[-1] + 1) // 2)
    z = torch.zeros((NB, BLK, BLK, 1))
    eye = torch.eye(BLK)[None, :, :, None].expand(NB, BLK, BLK, 1)
    blocks = TrimmedFactor(z, eye, z).blocks
    assert nbytes == 4 * (100 * blocks + 90 * NB + 10 * sum(n))
    assert ros23_cuda.SHARED_ARENA_MAX == 232_448 - 256
