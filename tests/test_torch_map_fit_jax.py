"""The port's map_fit against the JAX package's, LBFGS iterations
included.

Both packages run ``map_fit(n_starts=2, n_local=2, max_iters=1,
dr_coarse=0.5, dr_fine=0.4, rtol=1e-3, seed=123)``: the same two
scrambled Sobol starts (losses 5.94 and 0.025), one LBFGS iteration
(optax's ``lbfgs()``: the scaled first step, the zoom line search, the
projection onto the box) from each through the stiff solve at dr=0.5,
one more from the better result at dr=0.4.  Start losses agree within
1e-9 relative, the fitted point within 1e-8 in log space, the final
loss within 1e-9 relative.  (TestMAPFit's own configuration is out of
the eager port's reach on the CPU; see tests/test_torch_map_fit.py.)
"""

import numpy as np
import pytest
import torch

from gab1_shp2_tpu.inference.map_fit import map_fit as j_map_fit

from gab1_shp2_tpu_torch.inference.map_fit import map_fit

torch.set_num_threads(2)

FIT_ARGS = dict(n_starts=2, n_local=2, max_iters=1, dr_coarse=0.5,
                dr_fine=0.4, rtol=1e-3, seed=123)


@pytest.fixture(scope="module")
def fits():
    return j_map_fit(**FIT_ARGS), map_fit(device="cpu", **FIT_ARGS)


def test_map_fit_matches_jax(fits):
    jres, tres = fits
    np.testing.assert_allclose(tres.starts, np.asarray(jres.starts),
                               rtol=1e-15, atol=0)
    np.testing.assert_allclose(tres.start_losses,
                               np.asarray(jres.start_losses), rtol=1e-9)
    np.testing.assert_allclose(tres.log_k4, np.asarray(jres.log_k4),
                               rtol=0, atol=1e-8)
    np.testing.assert_allclose(tres.loss, float(jres.loss), rtol=1e-9)
    # the iterations moved the point and lowered the loss
    assert tres.loss < np.min(tres.start_losses) - 1e-3
    assert set(tres.values) == set(jres.values)
