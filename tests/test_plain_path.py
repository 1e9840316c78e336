"""The one device path: zero-RHS convention and uneven grids.

``b=None`` declares a zero right-hand side (prior sampling); every
sampler must treat it exactly like explicit zeros, in both the
explicit-noise step and the keyed step.  Odd and uneven 3D grids must go
through ``MGMCSampler.create`` and ``sample_chain`` and stay exactly
invariant.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from parmgmc_tpu.chain import init_chain, sample_chain
from parmgmc_tpu.models.problems import squared_shifted_laplace_fd
from parmgmc_tpu.operators.lrc import LRCOperator
from parmgmc_tpu.operators.stencil import shifted_laplace_fd
from parmgmc_tpu.samplers.cholesky import CholeskySampler
from parmgmc_tpu.samplers.gibbs import GibbsSampler, _draw
from parmgmc_tpu.samplers.mgmc import MGMCSampler
from parmgmc_tpu.samplers.patch_gibbs import PatchGibbsSampler
from parmgmc_tpu.samplers.sor import NaturalGibbsSampler
from parmgmc_tpu.samplers.woodbury import WoodburySampler
from parmgmc_tpu.testing import invariance_error

GRID = (6, 5)
F64 = jnp.float64


def _op():
    return shifted_laplace_fd(GRID, 2.0, dtype=F64)


def _lrc():
    B = jax.random.normal(jax.random.PRNGKey(3), (*GRID, 2), F64)
    return LRCOperator(base=_op(), B=B, sigma_inv=jnp.asarray([1.5, 0.7], F64))


SAMPLERS = {
    "gibbs-forward": lambda: GibbsSampler.create(_op(), sweep="forward"),
    "gibbs-backward": lambda: GibbsSampler.create(_op(), sweep="backward"),
    "gibbs-symmetric": lambda: GibbsSampler.create(_op(), sweep="symmetric"),
    "gibbs-lrc-symmetric": lambda: GibbsSampler.create(_lrc(), sweep="symmetric"),
    "natural-gibbs": lambda: NaturalGibbsSampler.create(_op()),
    "cholesky": lambda: CholeskySampler.create(_op()),
    "mgmc-linear": lambda: MGMCSampler.create(_op(), n_levels=2),
    "mgmc-aggregate": lambda: MGMCSampler.create(
        _op(), n_levels=2, coarsening="aggregate", n_post=0
    ),
    "mgmc-lrc": lambda: MGMCSampler.create(_lrc(), n_levels=2),
    "mgmc-wcycle": lambda: MGMCSampler.create(_op(), n_levels=2, gamma=2),
    "patch-gibbs": lambda: PatchGibbsSampler.create(
        squared_shifted_laplace_fd(GRID, 2.0, dtype=F64)
    ),
    "woodbury": lambda: WoodburySampler.create(
        _lrc(), CholeskySampler.create(_op())
    ),
}


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_zero_rhs_equals_explicit_zeros(name):
    smp = SAMPLERS[name]()
    key = jax.random.PRNGKey(11)
    x = jax.random.normal(key, GRID, F64)
    zeros = jnp.zeros(GRID, F64)
    noises = _draw(jax.random.fold_in(key, 1), smp.noise_shapes(), F64)
    np.testing.assert_array_equal(
        np.asarray(smp.step_with_noise(x, None, noises)),
        np.asarray(smp.step_with_noise(x, zeros, noises)),
    )
    k1, a = smp.step(key, x, None)
    k2, b = smp.step(key, x, zeros)
    np.testing.assert_array_equal(np.asarray(k1), np.asarray(k2))
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("coarsening", ["linear", "aggregate"])
@pytest.mark.parametrize("shape", [(5, 6, 7), (6, 5, 4), (7, 4, 5), (3, 8, 6)])
def test_uneven_3d_grids_through_create_and_chain(shape, coarsening):
    op = shifted_laplace_fd(shape, 3.0, dtype=F64)
    smp = MGMCSampler.create(
        op, coarsest_size=16, n_pre=1, n_post=1, coarsening=coarsening
    )
    assert smp.n_levels >= 2
    for lo, hi in zip(smp.ops[1:], smp.ops[:-1]):
        assert all(c <= f for c, f in zip(lo.grid_shape, hi.grid_shape))
    mean_err, cov_err = invariance_error(smp, op, None)
    assert mean_err < 1e-10 and cov_err < 1e-10, (mean_err, cov_err)

    st = init_chain(smp, jax.random.PRNGKey(0))
    st, q = jax.jit(lambda s, t: sample_chain(s, t, None, 4, extract=jnp.mean))(
        smp, st
    )
    assert st.x.shape == shape and q.shape == (4,)
    assert bool(jnp.all(jnp.isfinite(st.x)))
