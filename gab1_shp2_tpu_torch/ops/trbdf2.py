"""Stiff-method constants and the shared Rosenbrock (ROW) step.

Counterpart of the constants, tableaus, ``_row_step`` and ``StiffStats``
of ``gab1_shp2_tpu/ops/trbdf2.py`` (the single-member ``solve_stiff``
is not ported yet).  See that module for the method citations.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

GAMMA = 2.0 - math.sqrt(2.0)
A = GAMMA / 2.0  # shared implicit coefficient of both TRBDF2 stages
# BDF2-stage combination coefficients
_C_YG = 1.0 / (GAMMA * (2.0 - GAMMA))
_C_YN = (1.0 - GAMMA) ** 2 / (GAMMA * (2.0 - GAMMA))
# third-order embedded weights (order conditions at c = (0, gamma, 1))
_B2 = 1.0 / (6.0 * GAMMA * (1.0 - GAMMA))
_B3 = 0.5 - 1.0 / (6.0 * (1.0 - GAMMA))
_B1 = 1.0 - _B2 - _B3

# Rosenbrock23 (Shampine-Reichelt ode23s) W-method coefficients
_ROS_D = 1.0 / (2.0 + math.sqrt(2.0))
_ROS_E32 = 6.0 + math.sqrt(2.0)

# Transformed Hairer-Wanner Rosenbrock tableaus.  Stage i:
#   (I - h*g*J) u_i = h*g*f(y + sum_{j<i} A[i][j] u_j)
#                     + g*sum_{j<i} C[i][j] u_j
#   y1 = y + sum_i M[i] u_i;  err = sum_i E[i] u_i
_ROW_TABLEAUS = {
    "rodas3": dict(
        g=0.5,
        A=((), (0.0,), (2.0, 0.0), (2.0, 0.0, 1.0)),
        C=((), (4.0,), (1.0, -1.0), (1.0, -1.0, -8.0 / 3.0)),
        M=(2.0, 0.0, 1.0, 1.0),
        E=(0.0, 0.0, 0.0, 1.0),
        est_order=2,
    ),
    "rodas4": dict(
        g=0.25,
        A=((),
           (1.544000000000000,),
           (0.9466785280815826, 0.2557011698983284),
           (3.314825187068521, 2.896124015972201, 0.9986419139977817),
           (1.221224509226641, 6.019134481288629, 12.53708332932087,
            -0.6878860361058950),
           (1.221224509226641, 6.019134481288629, 12.53708332932087,
            -0.6878860361058950, 1.0)),
        C=((),
           (-5.668800000000000,),
           (-2.430093356833875, -0.2063599157091915),
           (-0.1073529058151375, -9.594562251023355, -20.47028614809616),
           (7.496443313967647, -10.24680431464352, -33.99990352819905,
            11.70890893206160),
           (8.083246795921522, -7.981132988064893, -31.52159432874371,
            16.31930543123136, -6.058818238834054)),
        M=(1.221224509226641, 6.019134481288629, 12.53708332932087,
           -0.6878860361058950, 1.0, 1.0),
        E=(0.0, 0.0, 0.0, 0.0, 0.0, 1.0),
        est_order=3,
    ),
}


def _row_step(tab, factor, solve, f, y, f_n, h, Lj, Dj, Uj, eye, ls_dtype):
    """One transformed-Rosenbrock step: factor W = I - g*h*J once, then
    one back-solve per stage.  ``h`` is the pair ``(h_band, h_state)``
    broadcastable against the bands and the state.  Returns
    ``(y_1, est)``; f(y_1) is not computed (dense output does it lazily).
    """
    hb, hd = h
    g = tab["g"]
    fac = factor(-g * hb * Lj, eye - g * hb * Dj.to(ls_dtype), -g * hb * Uj)
    us = []
    # cache f by the stage-argument coefficient signature: RODAS3's
    # second stage argument is y itself, so its f is f_n
    f_cache = {(): f_n}
    for i in range(len(tab["M"])):
        sig = tuple(tab["A"][i])
        while sig and sig[-1] == 0.0:
            sig = sig[:-1]
        if sig not in f_cache:
            arg = y
            for j, a in enumerate(sig):
                if a != 0.0:
                    arg = arg + a * us[j]
            f_cache[sig] = f(arg)
        rhs_i = g * hd * f_cache[sig]
        for j, c in enumerate(tab["C"][i]):
            if c != 0.0:
                rhs_i = rhs_i + (g * c) * us[j]
        us.append(solve(fac, rhs_i))
    y_1 = y
    est = torch.zeros_like(y)
    for m_i, e_i, u_i in zip(tab["M"], tab["E"], us):
        if m_i != 0.0:
            y_1 = y_1 + m_i * u_i
        if e_i != 0.0:
            est = est + e_i * u_i
    return y_1, est


class StiffStats(NamedTuple):
    n_accepted: torch.Tensor
    n_rejected: torch.Tensor
    failed: torch.Tensor
