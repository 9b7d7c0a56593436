"""Parameter containers and baseline values (torch).

Counterpart of ``gab1_shp2_tpu/models/params.py``.  ``Params`` holds the
7 cytosolic diffusivities and the 17 kinetic parameters in the
reference ordering (``Julia/basepdesolver.jl:43-68``) as torch tensors;
initial concentrations ``Co`` are a separate 5-vector
(``Julia/basepdesolver.jl:79``).  The baseline values are the same
literals as the JAX package's, so both packages pack identical vectors.

Every constructor takes ``dtype`` and ``device``; ``device=None`` means
the CUDA card and raises when there is none (see :func:`resolve_device`).
"""

from __future__ import annotations

import dataclasses
import math
import numpy as np
import torch

from gab1_shp2_tpu_torch.models.species import DIFF_NAMES, K_NAMES


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless told otherwise.

    ``None`` means ``"cuda"``.  A CUDA device that is absent raises: the
    port never falls back to the CPU on its own.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested (the default) but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "on the CPU")
    return dev


@dataclasses.dataclass(frozen=True)
class Params:
    """Model parameters: diffusivities ``D`` (..., 7) and kinetics ``k``
    (..., 17).  A leading batch dimension is the ensemble axis."""

    D: torch.Tensor  # (..., 7) um^2/min, order = DIFF_NAMES
    k: torch.Tensor  # (..., 17), order = K_NAMES

    # --- named accessors -------------------------------------------------
    def __getattr__(self, name: str):
        if name in _DIFF_IDX:
            return self.D[..., _DIFF_IDX[name]]
        if name in _K_IDX:
            return self.k[..., _K_IDX[name]]
        raise AttributeError(name)

    # --- packing (reference 24-vector ordering, get_param_posteriors.jl:24) --
    def pack(self) -> torch.Tensor:
        """Concatenate to the reference's 24-parameter vector [D; k]."""
        return torch.cat([self.D, self.k], dim=-1)

    @classmethod
    def unpack(cls, p: torch.Tensor) -> "Params":
        """Build from a packed (..., 24) vector in reference ordering."""
        return cls(D=p[..., :7], k=p[..., 7:24])

    @classmethod
    def from_numpy(cls, D, k, dtype=torch.float64, device=None) -> "Params":
        """Carry parameters across from numpy arrays (e.g. the JAX
        package's ``np.asarray(p.D)``, ``np.asarray(p.k)``)."""
        dev = resolve_device(device)
        return cls(D=torch.tensor(np.asarray(D), dtype=dtype, device=dev),
                   k=torch.tensor(np.asarray(k), dtype=dtype, device=dev))

    def to(self, dtype=None, device=None) -> "Params":
        return Params(D=self.D.to(device=device, dtype=dtype),
                      k=self.k.to(device=device, dtype=dtype))

    def replace(self, **kv) -> "Params":
        """Return a copy with named parameters replaced (e.g. kG1p=...)."""
        D, k = self.D.clone(), self.k.clone()
        for name, val in kv.items():
            if name in _DIFF_IDX:
                D[..., _DIFF_IDX[name]] = val
            elif name in _K_IDX:
                k[..., _K_IDX[name]] = val
            else:
                raise KeyError(name)
        return Params(D=D, k=k)

    def scale(self, **kv) -> "Params":
        """Return a copy with named parameters multiplied by factors."""
        D, k = self.D.clone(), self.k.clone()
        for name, fac in kv.items():
            if name in _DIFF_IDX:
                D[..., _DIFF_IDX[name]] *= fac
            elif name in _K_IDX:
                k[..., _K_IDX[name]] *= fac
            else:
                raise KeyError(name)
        return Params(D=D, k=k)


_DIFF_IDX = {n: i for i, n in enumerate(DIFF_NAMES)}
_K_IDX = {n: i for i, n in enumerate(K_NAMES)}


# ---------------------------------------------------------------------------
# Baseline numeric values (the JAX package's literals; see its docstrings
# for their provenance in the reference's analysis scripts)
# ---------------------------------------------------------------------------

PRIOR_MODES = {
    "Dsfk": 83.90492356885275, "Dg2": 135.82021008988147,
    "Dg2g1": 61.92754655708403, "Dg2g1s2": 55.91981540712498,
    "Dg1": 66.88091525801038, "Dg1s2": 56.921216271953114,
    "Ds2": 79.90018711022756,
    "kS2f": 1.594154765858519, "kS2r": 480.0,
    "kG1f": 0.0008841935962501533, "kG1r": 0.12270919368275156,
    "kG2f": 1.594154765858519, "kG2r": 480.0,
    "kG1p": 0.42, "kG1dp": 9.5, "kSa": 0.42, "kSi": 9.5,
    "kp": 13.84209947593684, "kdp": 41.21160714153434,
    "kEGFf": 55.84051666722567, "kEGFr": 0.13007953061289362,
    "EGF": 1.67e-3, "kdf": 1.2, "kdr": 0.456,
}

# Posterior log-medians of the four fitted parameters
# (Julia/Turing results/..._posteriors_quantiles.csv, 50% column).
POSTERIOR_MEDIAN_FIT = {
    "kG1p": 1.2665193312817182,
    "kG1dp": 3.1179166468335158,
    "kSa": 0.7924254367778611,
    "kSi": 4.665684502848428,
}

# MAP fit (Julia/fitted_parameters.csv).
MAP_FIT = {
    "kG1p": 41.999999999999964,
    "kG1dp": 0.09499999999999997,
    "kSa": 16.175675458812922,
    "kSi": 0.09499999999999997,
}


def default_params(fit: str = "posterior_median", dtype=torch.float64,
                   device=None) -> Params:
    """Baseline parameters.

    ``fit`` selects the values of the four fitted parameters:
    ``"posterior_median"`` (the reference analyses' baseline), ``"map"``
    (the MAP fit) or ``"prior"`` (pure prior modes).
    """
    vals = dict(PRIOR_MODES)
    if fit == "posterior_median":
        vals.update(POSTERIOR_MEDIAN_FIT)
    elif fit == "map":
        vals.update(MAP_FIT)
    elif fit != "prior":
        raise ValueError(f"unknown fit mode {fit!r}")
    dev = resolve_device(device)
    D = torch.tensor([vals[n] for n in DIFF_NAMES], dtype=dtype, device=dev)
    k = torch.tensor([vals[n] for n in K_NAMES], dtype=dtype, device=dev)
    return Params(D=D, k=k)


# ---------------------------------------------------------------------------
# Initial concentrations
# ---------------------------------------------------------------------------

def co_from_copies(
    n_sfk: float, n_grb2: float, n_gab1: float, n_shp2: float, n_egfr: float,
    R: float = 10.0, dtype=torch.float64, device=None,
) -> torch.Tensor:
    """Convert copies/cell to concentrations for a spherical cell of radius R.

    Cytosolic species -> molecules/um^3 (divide by cell volume), EGFR ->
    molecules/um^2 (divide by surface area); ``Julia/run_base_model.jl:67-76``.
    """
    vol_cf = 1.0 / (4.0 / 3.0 * math.pi * R**3)
    surf_cf = 1.0 / (4.0 * math.pi * R**2)
    return torch.tensor(
        [n_sfk * vol_cf, n_grb2 * vol_cf, n_gab1 * vol_cf, n_shp2 * vol_cf,
         n_egfr * surf_cf],
        dtype=dtype, device=resolve_device(device),
    )


def co_from_numpy(co, dtype=torch.float64, device=None) -> torch.Tensor:
    """Carry initial concentrations (5,) or (B, 5) across from numpy."""
    return torch.tensor(np.asarray(co), dtype=dtype,
                           device=resolve_device(device))


def default_co(R: float = 10.0, dtype=torch.float64,
               device=None) -> torch.Tensor:
    """Base-model abundances: 6e5 copies/cell of each protein
    (``Julia/run_base_model.jl:71-76``)."""
    return co_from_copies(6.0e5, 6.0e5, 6.0e5, 6.0e5, 6.0e5, R=R,
                          dtype=dtype, device=device)


def hela_co(R: float = 10.0, dtype=torch.float64,
            device=None) -> torch.Tensor:
    """HeLa abundances (``Julia/run_base_model_HeLa.jl:71-81``):
    SFK 1.66e5, GRB2 6.28e5, GAB1 1.53e3, SHP2 3.00e5, EGFR 9.3e4."""
    return co_from_copies(1.66e5, 6.28e5, 1.53e3, 3.0e5, 9.3e4, R=R,
                          dtype=dtype, device=device)


def stability_dt(params: Params, dr: float) -> torch.Tensor:
    """The reference's explicit-Euler stability bound
    ``dt = 0.99 / (2 (max(D)/dr^2 + sum(k)/4))`` (``basepdesolver.jl:30``)."""
    return 0.99 / (2.0 * (torch.amax(params.D, dim=-1) / dr**2
                          + torch.sum(params.k, dim=-1) / 4.0))
