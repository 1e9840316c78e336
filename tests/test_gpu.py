"""Checks that only a GPU can make: f32 contractions that must not run
in TF32, and the sampling path on the card against references.

Marked ``gpu``; each test asks for the ``gpu`` fixture, which skips it
when JAX has no GPU.  On a card (``python chip_smoke.py`` runs these in
its phase B):

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from parmgmc_tpu.models.obs import make_observation_mats
from parmgmc_tpu.operators.lrc import LRCOperator
from parmgmc_tpu.operators.stencil import shifted_laplace_fd
from parmgmc_tpu.samplers.cholesky import CholeskySampler
from parmgmc_tpu.samplers.gibbs import GibbsSampler, _draw
from parmgmc_tpu.samplers.mgmc import MGMCSampler
from parmgmc_tpu.testing import invariance_error

pytestmark = pytest.mark.gpu

# f32 roundoff of these small problems stays near 1e-6; TF32 (a 10-bit
# mantissa) lands near 1e-3
F32_TOL = 1e-5


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_rank_k_contractions_are_f32_exact(gpu):
    grid = (16, 16, 16)
    rng = np.random.default_rng(0)
    B = rng.standard_normal((*grid, 5)).astype(np.float32)
    x = rng.standard_normal(grid).astype(np.float32)
    w = rng.standard_normal(5).astype(np.float32)
    op = LRCOperator(
        base=shifted_laplace_fd(grid, 1.0, dtype=jnp.float32),
        B=jax.device_put(B, gpu),
        sigma_inv=jax.device_put(np.ones(5, np.float32), gpu),
    )
    Bf = B.astype(np.float64).reshape(-1, 5)
    bt = jax.jit(lambda o, v: o.bt_apply(v))(op, jax.device_put(x, gpu))
    bw = jax.jit(lambda o, v: o.b_apply(v))(op, jax.device_put(w, gpu))
    assert _rel(bt, Bf.T @ x.reshape(-1).astype(np.float64)) < F32_TOL
    assert _rel(bw, (Bf @ w.astype(np.float64)).reshape(grid)) < F32_TOL


def test_coarse_cholesky_draw_is_f32_exact(gpu):
    op = shifted_laplace_fd((8, 8, 8), 8.0, dtype=jnp.float32)
    smp = CholeskySampler.create(op)
    assert smp.Li is not None, "explicit inverse rejected: inexact Li @ L"
    rng = np.random.default_rng(1)
    b = rng.standard_normal(op.grid_shape).astype(np.float32)
    eta = rng.standard_normal(op.n).astype(np.float32)
    got = jax.jit(lambda s, bb, e: s.step_with_noise(None, bb, [{"eta": e}]))(
        smp, jax.device_put(b, gpu), jax.device_put(eta, gpu)
    )
    A = np.asarray(op.to_dense(), np.float64)
    L = np.linalg.cholesky(A)
    v = np.linalg.solve(L, b.reshape(-1).astype(np.float64))
    want = np.linalg.solve(L.T, v + eta).reshape(op.grid_shape)
    assert _rel(got, want) < F32_TOL


def test_gibbs_and_mgmc_invariance_on_gpu(gpu):
    op = shifted_laplace_fd((5, 5), 1.5, dtype=jnp.float64)
    b = jnp.sin(jnp.arange(25, dtype=jnp.float64)).reshape(5, 5)
    for smp in (
        GibbsSampler.create(op, sweep="symmetric"),
        MGMCSampler.create(op, n_levels=2, coarsening="aggregate"),
    ):
        errs = invariance_error(smp, op, b)
        assert max(float(e) for e in errs) < 1e-10


def test_posterior_mgmc_step_matches_cpu(gpu):
    grid = (16, 16, 16)
    base = shifted_laplace_fd(grid, 1.0, dtype=jnp.float32)
    B, sigma_inv, f = make_observation_mats(
        grid, 0.01, np.array([[0.3, 0.4, 0.5], [0.6, 0.5, 0.3]]),
        np.full(2, 0.2), obsvals=np.ones(2), dtype=jnp.float32,
    )
    op = LRCOperator(base=base, B=B, sigma_inv=sigma_inv)
    smp = MGMCSampler.create(
        op, n_pre=1, n_post=0, coarsening="aggregate", coarsest_size=64
    )
    key = jax.random.PRNGKey(2)
    x = jax.random.normal(key, grid, jnp.float32)
    noises = _draw(jax.random.fold_in(key, 1), smp.noise_shapes(), jnp.float32)
    step = jax.jit(lambda s, xx, bb, nn: s.step_with_noise(xx, bb, nn))
    cpu = jax.devices("cpu")[0]
    got = step(*jax.device_put((smp, x, f, noises), gpu))
    want = step(*jax.device_put((smp, x, f, noises), cpu))
    assert _rel(got, want) < F32_TOL
