"""The invariance oracle over the MGMC configuration space.

Every combination of coarsening, smoother sweep, (n_pre, n_post) and
prior/posterior target must leave N(A^{-1}b, A^{-1}) invariant to
machine precision (parmgmc_tpu.testing), on a tiny f64 grid.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from parmgmc_tpu.models.obs import make_observation_mats
from parmgmc_tpu.operators.lrc import LRCOperator
from parmgmc_tpu.operators.stencil import shifted_laplace_fd
from parmgmc_tpu.samplers.mgmc import MGMCSampler
from parmgmc_tpu.testing import invariance_error

GRID = (6, 6)
TOL = 1e-10


def _target(kind):
    op = shifted_laplace_fd(GRID, 2.0, dtype=jnp.float64)
    if kind == "posterior":
        B, sigma_inv, _ = make_observation_mats(
            GRID, 0.1, np.array([[0.3, 0.3], [0.7, 0.6]]), np.full(2, 0.3),
            dtype=jnp.float64,
        )
        op = LRCOperator(base=op, B=B, sigma_inv=sigma_inv)
    return op


@pytest.mark.parametrize("target", ["prior", "posterior"])
@pytest.mark.parametrize("cycle", [(1, 0), (1, 1), (2, 1)])
@pytest.mark.parametrize("sweep", ["forward", "backward", "symmetric"])
@pytest.mark.parametrize("coarsening", ["linear", "aggregate"])
def test_mgmc_invariance_matrix(coarsening, sweep, cycle, target):
    op = _target(target)
    smp = MGMCSampler.create(
        op,
        n_levels=2,
        sweep=sweep,
        n_pre=cycle[0],
        n_post=cycle[1],
        coarsening=coarsening,
    )
    b = jnp.cos(jnp.arange(36, dtype=jnp.float64)).reshape(GRID)
    mean_err, cov_err = invariance_error(smp, op, b)
    assert mean_err < TOL, mean_err
    assert cov_err < TOL, cov_err
