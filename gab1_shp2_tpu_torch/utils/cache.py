"""Compute-or-load checkpointing.

Counterpart of ``gab1_shp2_tpu/utils/cache.py`` (numpy only; the same
file names, keys and ``.npz`` layouts, so either package loads the
other's caches).

The reference guards every expensive stage with flag-based
compute-or-load: MCMC chains to JLD2
(``param_fitting+inference_finitediff.jl:399-423``), GSA results to
JLD2+CSV (``GSA_diffs+kinetic-params_MoL.jl:81-110``), the MAP fit to
``fitted_parameters.csv``.  This module is that idiom as a utility:
results are stored as ``.npz`` keyed by a content hash of the
configuration, so re-running a driver with unchanged settings loads
instead of recomputing, and changing any setting recomputes
automatically (the reference requires manually flipping ``run_*``
flags).

``Checkpointer`` adds mid-run checkpointing (the reference has none):
long NUTS runs or chunked sweeps can persist partial state every
``every`` units of progress and resume after interruption.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Any, Callable, Dict, Optional

import numpy as np


def _key(config: Dict[str, Any]) -> str:
    blob = json.dumps(config, sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def compute_or_load(name: str, config: Dict[str, Any],
                    compute: Callable[[], Dict[str, np.ndarray]],
                    *, cache_dir: str = "results/cache",
                    force: bool = False) -> Dict[str, np.ndarray]:
    """Return cached arrays for (name, config) or compute and store them."""
    os.makedirs(cache_dir, exist_ok=True)
    path = os.path.join(cache_dir, f"{name}_{_key(config)}.npz")
    if os.path.exists(path) and not force:
        with np.load(path, allow_pickle=False) as z:
            return {k: z[k] for k in z.files}
    out = {k: np.asarray(v) for k, v in compute().items()}
    tmp = path + ".tmp.npz"  # np.savez appends .npz otherwise
    np.savez_compressed(tmp, **out)
    os.replace(tmp, path)
    meta = os.path.join(cache_dir, f"{name}_{_key(config)}.json")
    with open(meta, "w") as fh:
        json.dump(config, fh, indent=1, sort_keys=True, default=str)
    return out


class Checkpointer:
    """Periodic mid-run checkpointing with resume.

    >>> ck = Checkpointer("nuts_chain0", {"dr": 0.2}, every=60.0)
    >>> state = ck.restore() or fresh_state
    >>> for i in loop: ...; ck.maybe_save({"i": i, **state})
    """

    def __init__(self, name: str, config: Dict[str, Any], *,
                 cache_dir: str = "results/cache", every: float = 120.0):
        os.makedirs(cache_dir, exist_ok=True)
        self.path = os.path.join(cache_dir, f"ckpt_{name}_{_key(config)}.npz")
        self.every = every
        self._last = 0.0

    def restore(self) -> Optional[Dict[str, np.ndarray]]:
        if not os.path.exists(self.path):
            return None
        with np.load(self.path, allow_pickle=False) as z:
            return {k: z[k] for k in z.files}

    def save(self, state: Dict[str, Any]) -> None:
        tmp = self.path + ".tmp.npz"  # np.savez appends .npz otherwise
        np.savez_compressed(tmp,
                            **{k: np.asarray(v) for k, v in state.items()})
        os.replace(tmp, self.path)
        self._last = time.time()

    def maybe_save(self, state: Dict[str, Any]) -> bool:
        if time.time() - self._last >= self.every:
            self.save(state)
            return True
        return False

    def clear(self) -> None:
        if os.path.exists(self.path):
            os.remove(self.path)
