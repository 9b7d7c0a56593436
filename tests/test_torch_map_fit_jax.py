"""The port's map_fit against the JAX package's, LBFGS iterations
included, and TestMAPFit's criteria (tests/test_inference.py) on the
port's fit.

Both packages run ``map_fit(n_starts=2, n_local=2, max_iters=1,
dr_coarse=1.0, dr_fine=0.5, rtol=1e-3, seed=123)``: the same two
scrambled Sobol starts (losses 5.98 and 0.022), one LBFGS iteration
(optax's ``lbfgs()``: the scaled first step, the zoom line search, the
projection onto the box) from each through the stiff solve at dr=1,
one more from the better result at dr=0.5.  Start losses agree within
1e-9 relative, the fitted point within 1e-8 in log space, the final
loss within 1e-9 relative, one case each.  Each package's fit runs
once per module and every test reads the port's.  (Tier-1's ``--dist
loadfile`` hands out files by test count, most first: as cases the
parity test no longer leaves this file of ~3 minutes for last.)
TestMAPFit's own configuration is out of the eager port's reach on the
CPU; see tests/test_torch_map_fit.py.
"""

import numpy as np
import pytest
import torch

from gab1_shp2_tpu.inference.map_fit import map_fit as j_map_fit

from gab1_shp2_tpu_torch.inference.loss import FIT_NAMES
from gab1_shp2_tpu_torch.inference.map_fit import map_fit

torch.set_num_threads(2)

FIT_ARGS = dict(n_starts=2, n_local=2, max_iters=1, dr_coarse=1.0,
                dr_fine=0.5, rtol=1e-3, seed=123)


@pytest.fixture(scope="module")
def port_fit():
    return map_fit(device="cpu", **FIT_ARGS)


@pytest.fixture(scope="module")
def jax_fit():
    return j_map_fit(**FIT_ARGS)


@pytest.mark.parametrize("field,rtol,atol", [
    ("starts", 1e-15, 0), ("start_losses", 1e-9, 0), ("log_k4", 0, 1e-8),
    ("loss", 1e-9, 0)])
def test_map_fit_matches_jax(jax_fit, port_fit, field, rtol, atol):
    np.testing.assert_allclose(getattr(port_fit, field),
                               np.asarray(getattr(jax_fit, field)),
                               rtol=rtol, atol=atol)
    # the iterations moved the point and lowered the loss
    assert port_fit.loss < np.min(port_fit.start_losses) - 1e-3
    assert set(port_fit.values) == set(jax_fit.values)


def test_map_fit_criteria(port_fit):
    """A finite loss strictly below the best start's and below 0.05,
    positive fitted values, the values the exponentials of log_k4."""
    res = port_fit
    assert np.isfinite(res.loss)
    # the iterations lowered the loss below the best start's
    assert res.loss < np.nanmin(res.start_losses) - 1e-3
    assert res.loss < 0.05
    for n in FIT_NAMES:
        assert res.values[n] > 0
    np.testing.assert_allclose(np.exp(res.log_k4),
                               [res.values[n] for n in FIT_NAMES],
                               rtol=1e-15)
