"""The least work of one RODAS4 step of one member, from shapes alone.

The count is of what any implementation has to do for one step of the
method-of-lines system, whatever it reads again or computes twice: it
depends on the grid, the species and the method's six stages, never on
how the program computes a step, so a fused kernel is judged against the
same work as the eager step.

Shapes: M = R/dr - 1 interior nodes of n = 10 cytosolic species, one
membrane row of 8 species; RODAS4 has s = 6 stages, each with one
right-hand-side evaluation and one solve with W = I - gamma*h*J.

Operations (one addition, subtraction, multiplication or division each):

* right-hand side, per evaluation: per interior node 70 for diffusion
  (per species two neighbour weights, the centre weight, two additions,
  times D, plus the reaction term) and 40 for mass action (29 for the
  eight reactions' rates, 11 to sum them into the species); 60 for the
  boundary closure and 58 for the membrane equations;
* stage arithmetic, per unknown: 4*(i - 1) for stage i's argument and
  right-hand side (a_ij and c_ij/h terms), 1 for the new state, 7 for
  the weighted error norm, 1 for the acceptance select;
* Jacobian bands: per interior node 73 for the reaction partials (14
  products, 59 accumulations) and 10 for the diffusion diagonal; 2 for
  each of the 224 entries of the dense membrane couplings;
* W: 2 per nonzero of a node's diagonal block (45 of them) and 1 per
  off-diagonal band entry (20 a node); 2 per membrane coupling entry;
* the block-tridiagonal factor (block LU, no pivoting across blocks;
  the off-diagonal blocks of the interior are diagonal): per interior
  row an inverse of the pivot block, 2n^3, and the Schur complement,
  3n^2; the membrane row: its coupling products 2*8*10*10 + 2*8*10*8,
  the 8x8 inverse 2*8^3, and the last interior row's dense coupling
  2*10*10*8;
* each of the s stage solves: per interior row 4n^2 + 2n (forward and
  backward substitution with the stored inverses), 2*(10*8 + 8*8) + 16
  for the membrane row.

The right-hand side and the stage arithmetic run in the state's dtype,
the bands, W, the factor and the solves in the linear algebra's.

Bytes: each input read once (the state, 24 parameters, t and h) and
each output written once (the state, t, h, the error norm), in the
state's dtype.
"""

from __future__ import annotations

N_SPECIES = 10
N_MEMB = 8
STAGES = 6
DTYPE_BYTES = {"float64": 8, "float32": 4, "bfloat16": 2, "float16": 2}


def rhs_ops(M: int) -> int:
    return 110 * M + 60 + 58


def stage_ops(unknowns: int, stages: int = STAGES) -> int:
    per = sum(4 * (i - 1) for i in range(1, stages + 1)) + 1 + 7 + 1
    return per * unknowns


def band_ops(M: int) -> int:
    return 83 * M + 2 * 224


def w_ops(M: int) -> int:
    return (2 * 45 + 20) * M + 2 * 224


def factor_ops(M: int, n: int = N_SPECIES) -> int:
    memb = 2 * 8 * 10 * 10 + 2 * 8 * 10 * 8 + 2 * 8**3 + 2 * 10 * 10 * 8
    return (2 * n**3 + 3 * n**2) * M + memb


def solve_ops(M: int, n: int = N_SPECIES) -> int:
    return (4 * n**2 + 2 * n) * M + 2 * (10 * 8 + 8 * 8) + 16


def member_step(M: int, state_dtype: str, linsolve_dtype: str) -> dict:
    """Operations by dtype and bytes of one step of one member."""
    unknowns = N_SPECIES * M + N_MEMB
    state = STAGES * rhs_ops(M) + stage_ops(unknowns)
    la = band_ops(M) + w_ops(M) + factor_ops(M) + STAGES * solve_ops(M)
    nbytes = DTYPE_BYTES[state_dtype] * ((unknowns + 24 + 2)
                                         + (unknowns + 3))
    return {"ops": {state_dtype: state}, "la_ops": {linsolve_dtype: la},
            "bytes": nbytes}


def least_time_s(config: dict, peaks: dict) -> float:
    """The least time of one member-step on a device with ``peaks``
    (FLOP/s by dtype, bytes/s): the larger of the operations over their
    dtypes' peaks and the bytes over the memory's."""
    M = int(round(float(config["R"]) / float(config["dr"]))) - 1
    state = config["state_dtype"]
    la = config.get("linsolve_dtype") or state
    w = member_step(M, state, la)
    t_ops = sum(v / peaks["flops"][k] for k, v in w["ops"].items())
    t_ops += sum(v / peaks["flops"][k] for k, v in w["la_ops"].items())
    return max(t_ops, w["bytes"] / peaks["bytes_per_s"])
