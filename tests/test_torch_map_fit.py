"""The port's multistart MAP fit against the JAX package's global stage,
and LBFGS through the stiff solve.

The global stage takes TestMAPFit's arguments (16 Sobol starts, seed 1,
dr_coarse=0.5, rtol 1e-3): the same scrambled starts (within 1e-15;
both draw them from scipy, the box's logs may round apart) and start
losses within 1e-9 relative of the JAX package's ``vmap`` of its loss
over the starts (the port solves them as one batch of lanes).

TestMAPFit's full configuration (LBFGS from the 2 best of the 16 starts
for 10 iterations, then 10 at dr_fine=0.4) takes tens of minutes in the
eager port on a CPU: its best starts lie at the loss floor (chi^2
~0.0016), where LBFGS's first step is the gradient itself (optax's
initial scale min(1, 1/|g|)) and the zoom line search doubles it about
a dozen times, each a value-and-gradient solve.  TestMAPFit's criteria
run instead on the fit of tests/test_torch_map_fit_jax.py: 2 starts
(seed 123, losses 5.98 and 0.022 at dr_coarse=1, off the floor), LBFGS
from both for one iteration, then one at dr_fine=0.5, the fit that file
holds against the JAX package's map_fit.  LBFGS through the stiff solve
from a poor start is below, its iterates against optax in
tests/test_torch_inference.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import qmc

from gab1_shp2_tpu.inference.loss import chi2_loss, make_observable_fn
from gab1_shp2_tpu.models.params import default_params as j_default_params

from gab1_shp2_tpu_torch.inference import loss as tl
from gab1_shp2_tpu_torch.inference.loss import FIT_NAMES
from gab1_shp2_tpu_torch.inference.map_fit import lbfgs_minimize, map_fit

torch.set_num_threads(2)

ARGS = dict(n_starts=16, decades=2.0, dr_coarse=0.5, rtol=1e-3, seed=1)


@pytest.fixture(scope="module")
def jax_global_stage():
    """The first stage of the JAX package's map_fit, step for step
    (gab1_shp2_tpu/inference/map_fit.py:107-120)."""
    base = j_default_params(fit="prior")
    center = jnp.log(jnp.stack([getattr(base, n) for n in FIT_NAMES]))
    lb = center - ARGS["decades"] * np.log(10.0)
    ub = center + ARGS["decades"] * np.log(10.0)
    obs = make_observable_fn(None, None, base, dr=ARGS["dr_coarse"],
                             rtol=ARGS["rtol"])
    sampler = qmc.Sobol(4, scramble=True,
                        rng=np.random.default_rng(ARGS["seed"]))
    u = sampler.random(ARGS["n_starts"])
    starts = jnp.asarray(np.asarray(lb) + u * np.asarray(ub - lb))
    losses = jax.jit(jax.vmap(lambda x: chi2_loss(obs, x)))(starts)
    return np.asarray(starts), np.asarray(losses)


def test_global_stage_matches_jax(jax_global_stage):
    # the global stage, and no LBFGS iteration after it
    port = map_fit(device="cpu", n_local=1, max_iters=0, dr_fine=0.5,
                   **ARGS)
    starts, losses = jax_global_stage
    np.testing.assert_allclose(port.starts, starts, rtol=1e-15, atol=0)
    assert np.isfinite(losses).all()
    np.testing.assert_allclose(port.start_losses, losses, rtol=1e-9)


def test_lbfgs_through_the_stiff_solve():
    """Two projected LBFGS iterations on the chi^2 loss through the stiff
    solve (rodas4, dr=1, rtol 1e-2) from a poor start: the loss falls,
    the iterate stays in the box, the returned loss is the loss at the
    returned point."""
    obs = tl.make_observable_fn(device="cpu", dr=1.0, rtol=1e-2,
                                method="rodas4")

    def f(x):
        return tl.chi2_loss(obs, x)

    x0 = torch.as_tensor(np.log([0.42, 9.5, 0.042, 95.0]))
    lb, ub = x0 - 3.0, x0 + 3.0
    v0 = float(f(x0))
    x, v = lbfgs_minimize(f, x0, max_iters=2, lb=lb, ub=ub)
    assert v0 > 1.0
    assert float(v) < 0.5 * v0
    assert bool(((x >= lb) & (x <= ub)).all())
    assert float(v) == float(f(x))
