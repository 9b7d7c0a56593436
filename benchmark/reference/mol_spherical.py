"""Plain reference: the GAB1-SHP2/EGFR method-of-lines system of one
member, solved tightly by SciPy's Radau IIA (order 5).

Written from the model's equations (the Julia reference's
``basepdesolver.jl:151-231``, the scheme the repository's independent
NumPy twin of the explicit solver transcribes): ten cytosolic species
diffuse in a sphere of radius R and react by mass action; eight membrane
species live on r = R and couple to the cytosol through reactive-flux
boundary values eliminated by a ghost node.  The semi-discrete system:

* interior nodes r_j = j*dr, j = 1..Nr-1:
  dC/dt = D * [(C[j+1] - 2C[j] + C[j-1]) / dr^2
               + (C[j+1] - C[j-1]) / (r_j dr)] + reactions(C[j]),
* the centre C[0] = C[1] (zero flux),
* the surface C[Nr] = (C[Nr-1] + gain*dr/D) / (1 + loss*dr/D) per
  species, gain and loss linear in the membrane state; aSFK's gain uses
  the just-eliminated iSFK value,
* the membrane ODEs at those surface values.

Nothing here comes from the program under test: the state layout, the
right-hand side, the Jacobian (complex-step, exact to rounding) and the
integrator are this file's own.  It imports NumPy and SciPy only, so
worker processes that run it never touch the card.
"""

from __future__ import annotations

import functools

import numpy as np
from scipy.integrate import solve_ivp
from scipy.sparse import csc_matrix

CYTO = ("iSFK", "aSFK", "GAB1", "pGAB1", "GRB2", "G2G1", "G2PG1", "SHP2",
        "PG1S", "G2PG1S")
MEMB = ("mE", "mES", "mESmES", "E", "EG2", "EG2G1", "EG2PG1", "EG2PG1S")
D_NAMES = ("Dsfk", "Dg2", "Dg2g1", "Dg2g1s2", "Dg1", "Dg1s2", "Ds2")
K_NAMES = ("kS2f", "kS2r", "kG1f", "kG1r", "kG2f", "kG2r", "kG1p", "kG1dp",
           "kSa", "kSi", "kp", "kdp", "kEGFf", "kEGFr", "EGF", "kdf", "kdr")
# the diffusivity of each cytosolic species
D_OF = {"iSFK": "Dsfk", "aSFK": "Dsfk", "GAB1": "Dg1", "pGAB1": "Dg1",
        "GRB2": "Dg2", "G2G1": "Dg2g1", "G2PG1": "Dg2g1", "SHP2": "Ds2",
        "PG1S": "Dg1s2", "G2PG1S": "Dg2g1s2"}
# surface exchange: cytosolic species, membrane partner, membrane
# complex, on-rate, off-rate (binding at r = R)
SURFACE = (("GRB2", "E", "EG2", "kG2f", "kG2r"),
           ("G2G1", "E", "EG2G1", "kG2f", "kG2r"),
           ("G2PG1", "E", "EG2PG1", "kG2f", "kG2r"),
           ("G2PG1S", "E", "EG2PG1S", "kG2f", "kG2r"),
           ("GAB1", "EG2", "EG2G1", "kG1f", "kG1r"),
           ("pGAB1", "EG2", "EG2PG1", "kG1f", "kG1r"),
           ("PG1S", "EG2", "EG2PG1S", "kG1f", "kG1r"),
           ("SHP2", "EG2PG1", "EG2PG1S", "kS2f", "kS2r"))
# the active-EGFR total Etot = 2 * (these), which activates SFK at r = R
ETOT = ("E", "EG2", "EG2G1", "EG2PG1", "EG2PG1S")
NC, NMB = len(CYTO), len(MEMB)
_C = {s: i for i, s in enumerate(CYTO)}
_M = {s: i for i, s in enumerate(MEMB)}


class Member:
    """One member's semi-discrete system.

    ``packed``: the 24 parameters, 7 diffusivities then 17 rate
    constants; ``Co``: initial iSFK, GRB2, GAB1, SHP2 and surface EGFR
    concentrations.  The state is the interior profile (species-major)
    followed by the membrane state.
    """

    def __init__(self, packed, Co, R: float, dr: float):
        p = dict(zip(D_NAMES + K_NAMES,
                     np.asarray(packed, dtype=np.float64).tolist()))
        self.p = p
        self.Co = np.asarray(Co, dtype=np.float64)
        nr = R / dr
        if abs(nr - round(nr)) > 1e-9:
            raise ValueError(f"dr={dr} does not divide R={R}")
        self.Nr = int(round(nr))
        self.M = self.Nr - 1
        self.dr = float(dr)
        self.n = NC * self.M + NMB
        self.Dc = np.array([p[D_OF[s]] for s in CYTO])
        rj = np.arange(1, self.Nr) * self.dr
        # stencil weights of the upper and lower neighbour
        self.w_up = 1.0 / self.dr**2 + 1.0 / (rj * self.dr)
        self.w_dn = 1.0 / self.dr**2 - 1.0 / (rj * self.dr)
        # surface gain and loss rates: (10, 8) matrices on the membrane
        gain = np.zeros((NC, NMB))
        loss = np.zeros((NC, NMB))
        for cyto, memb, cplx, kf, kr in SURFACE:
            gain[_C[cyto], _M[cplx]] += p[kr]
            loss[_C[cyto], _M[memb]] += p[kf]
        for s in ETOT:
            loss[_C["iSFK"], _M[s]] += 2.0 * p["kSa"]
        self.gain = gain * (self.dr / self.Dc[:, None])
        self.loss = loss * (self.dr / self.Dc[:, None])
        self.etot_w = np.zeros(NMB)
        self.etot_w[[_M[s] for s in ETOT]] = 2.0

    def split(self, u):
        C = u[:NC * self.M].reshape((NC, self.M) + u.shape[1:])
        return C, u[NC * self.M:]

    def y0(self):
        C = np.zeros((NC, self.M))
        for name, i in (("iSFK", 0), ("GRB2", 1), ("GAB1", 2), ("SHP2", 3)):
            C[_C[name]] = self.Co[i]
        m = np.zeros(NMB)
        m[_M["mE"]] = self.Co[4]
        return np.concatenate([C.ravel(), m])

    def surface(self, C_near, m):
        """The cytosolic concentrations at r = R, (10, ...)."""
        C_R = (C_near + self.gain @ m) / (1.0 + self.loss @ m)
        Et = self.etot_w @ m
        a, i = _C["aSFK"], _C["iSFK"]
        C_R[a] = C_near[a] + (self.p["kSa"] * self.dr / self.Dc[a]) \
            * C_R[i] * Et
        return C_R

    def reactions(self, C):
        p = self.p
        iS, aS, G1, pG1, G2, G2G1, G2PG1, S2, PG1S, G2PG1S = C
        b1 = p["kG1f"] * G2 * G1 - p["kG1r"] * G2G1       # GRB2 + GAB1
        b2 = p["kG1f"] * G2 * pG1 - p["kG1r"] * G2PG1     # GRB2 + pGAB1
        b3 = p["kG1f"] * G2 * PG1S - p["kG1r"] * G2PG1S   # GRB2 + PG1S
        s1 = p["kS2f"] * S2 * pG1 - p["kS2r"] * PG1S      # SHP2 + pGAB1
        s2 = p["kS2f"] * S2 * G2PG1 - p["kS2r"] * G2PG1S  # SHP2 + G2PG1
        ph1 = p["kG1p"] * aS * G1 - p["kG1dp"] * pG1      # GAB1 phospho.
        ph2 = p["kG1p"] * aS * G2G1 - p["kG1dp"] * G2PG1  # G2G1 phospho.
        de = p["kSi"] * aS                                # SFK deactivation
        return np.stack([de, -de, -b1 - ph1, -b2 + ph1 - s1, -b1 - b2 - b3,
                         b1 - ph2, b2 + ph2 - s2, -s1 - s2, s1 - b3,
                         b3 + s2])

    def membrane(self, m, C_R):
        p = self.p
        mE, mES, mESmES, E, EG2, EG2G1, EG2PG1, EG2PG1S = m
        egf = p["kEGFf"] * p["EGF"] * mE - p["kEGFr"] * mES
        dim = p["kdf"] * mES**2 - p["kdr"] * mESmES
        pho = p["kp"] * mESmES - p["kdp"] * E
        net = {}
        for cyto, memb, cplx, kf, kr in SURFACE:
            net[cyto] = (p[kf] * m[_M[memb]] * C_R[_C[cyto]]
                         - p[kr] * m[_M[cplx]])
        to_E = net["GRB2"] + net["G2G1"] + net["G2PG1"] + net["G2PG1S"]
        to_EG2 = net["GAB1"] + net["pGAB1"] + net["PG1S"]
        return np.stack([
            -egf,
            egf - 2.0 * dim,
            dim - pho,
            pho - to_E,
            net["GRB2"] - to_EG2,
            net["G2G1"] + net["GAB1"],
            net["G2PG1"] + net["pGAB1"] - net["SHP2"],
            net["G2PG1S"] + net["PG1S"] + net["SHP2"],
        ])

    def profile(self, u):
        """The bulk profile on all Nr+1 nodes, (10, Nr+1, ...)."""
        C, m = self.split(u)
        C_R = self.surface(C[:, -1], m)
        return np.concatenate([C[:, :1], C, C_R[:, None]], axis=1)

    def rhs(self, t, u):
        """du/dt for ``u`` of shape (n,) or (n, K)."""
        C, m = self.split(u)
        Cf = self.profile(u)
        ext = (1,) * (u.ndim - 1)
        w_up = self.w_up.reshape((1, self.M) + ext)
        w_dn = self.w_dn.reshape((1, self.M) + ext)
        lap = (w_up * Cf[:, 2:] + w_dn * Cf[:, :-2]
               - (2.0 / self.dr**2) * Cf[:, 1:-1])
        dC = self.Dc.reshape((NC, 1) + ext) * lap + self.reactions(C)
        dm = self.membrane(m, Cf[:, -1])
        return np.concatenate([dC.reshape((NC * self.M,) + u.shape[1:]),
                               dm])

    # --- the Jacobian --------------------------------------------------
    def jac(self, t, u):
        """The exact Jacobian (complex step over column colours), sparse."""
        rows, cols, color, seed, indptr = _pattern(self.M)
        h = 1e-40
        F = self.rhs(t, u[:, None] + (1j * h) * seed).imag / h
        return csc_matrix((F[rows, color[cols]], rows, indptr),
                          shape=(self.n, self.n))


@functools.lru_cache(maxsize=4)
def _pattern(M):
    """Which unknowns each equation reads, for M interior nodes: a node's
    species with each other, a species with its neighbours, and the last
    interior node and the membrane with each other (through the surface
    values).  Returns the nonzeros' rows and columns in column-major
    order, a colouring of the columns in which no two columns of one
    colour share a row, its (n, colours) seed matrix and the CSC index
    pointer."""
    n = NC * M + NMB
    A = np.zeros((n, n), dtype=bool)
    for j in range(M):
        node = np.arange(NC) * M + j
        A[np.ix_(node, node)] = True
        for j2 in (j - 1, j + 1):
            if 0 <= j2 < M:
                A[node, node - j + j2] = True
    last = np.arange(NC) * M + (M - 1)
    memb = np.arange(NC * M, n)
    A[np.ix_(last, memb)] = True
    A[np.ix_(memb, last)] = True
    A[np.ix_(memb, memb)] = True
    cols, rows = np.nonzero(A.T)
    # greedy colouring: columns of one colour share no row
    color = np.full(n, -1)
    for c in range(n):
        rows_c = np.nonzero(A[:, c])[0]
        taken = set(color[np.nonzero(A[rows_c].any(axis=0))[0]])
        k = 0
        while k in taken:
            k += 1
        color[c] = k
    ncol = color.max() + 1
    seed = np.zeros((n, ncol))
    seed[np.arange(n), color] = 1.0
    indptr = np.searchsorted(cols, np.arange(n + 1))
    return rows, cols, color, seed, indptr


def solve_member(packed, Co, *, R, dr, tf, rtol=1e-8, atol=1e-9,
                 t_save=None):
    """The final bulk profile (10, Nr+1) and membrane state (8,) of one
    member, and the Radau steps it took.  With ``t_save`` (increasing
    times in [0, tf]) the profiles (T, 10, Nr+1) and membrane states
    (T, 8) at those times instead, from Radau's own continuous
    extension over the same steps.  Raises when the integration
    fails."""
    mb = Member(packed, Co, R, dr)
    res = solve_ivp(mb.rhs, (0.0, float(tf)), mb.y0(), method="Radau",
                    rtol=rtol, atol=atol, jac=mb.jac,
                    dense_output=t_save is not None)
    if res.status != 0:
        raise RuntimeError(f"reference solve failed: {res.message}")
    if t_save is not None:
        U = res.sol(np.asarray(t_save, dtype=np.float64))
        return (mb.profile(U).transpose(2, 0, 1),
                mb.split(U)[1].T.copy(), len(res.t) - 1)
    u = res.y[:, -1]
    return mb.profile(u), mb.split(u)[1].copy(), len(res.t) - 1
