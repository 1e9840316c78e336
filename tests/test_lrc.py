"""The LRC (posterior) step against its materialised oracle.

The posterior Gibbs half-step is the base SOR sweep on the RHS
``b + D^{1/2} c eta + B Sigma^{-1/2} eta2`` followed by the Woodbury
post-correction ``x <- x - Bb (B^T x)`` with
``Bb = M^{-1} B (Sigma + B^T M^{-1} B)^{-1}`` (mc_sor.c:101-112,
456-544).  The oracle below builds M^{-1}, Bb and every product as
dense f64 matrices and must agree with the sampler to roundoff, with
and without the patch (window) views of B and Bb.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from parmgmc_tpu.models.obs import make_observation_mats
from parmgmc_tpu.operators.lrc import LRCOperator
from parmgmc_tpu.operators.stencil import shifted_laplace_fd
from parmgmc_tpu.samplers.gibbs import GibbsSampler
from parmgmc_tpu.samplers.mgmc import MGMCSampler
from parmgmc_tpu.samplers.sor import sor_sweep

GRID = (6, 8, 10)


def make_posterior(k=3, dtype=jnp.float32, patches=True):
    from parmgmc_tpu.operators.lrc import with_patches

    base = shifted_laplace_fd(GRID, 1.0, dtype=dtype)
    coords = np.array(
        [[0.3, 0.4, 0.5], [0.6, 0.3, 0.2], [0.5, 0.7, 0.8]][:k]
    )
    B, sigma_inv, f = make_observation_mats(
        GRID, 0.1, coords, np.full(k, 0.15), obsvals=np.ones(k), dtype=dtype
    )
    op = LRCOperator(base=base, B=B, sigma_inv=sigma_inv)
    return (with_patches(op) if patches else op), f


def test_patch_products_match_dense():
    """The sparse patch view's B^T x / B w / y + B w equal the dense
    contractions (up to fp summation order)."""
    op, _ = make_posterior()
    assert op.patch_vals is not None, "ball columns should patchify"
    dense = LRCOperator(base=op.base, B=op.B, sigma_inv=op.sigma_inv)
    key = jax.random.PRNGKey(0)
    x = jax.random.normal(key, GRID, jnp.float32)
    w = jax.random.normal(jax.random.fold_in(key, 1), (op.k,), jnp.float32)
    np.testing.assert_allclose(
        np.asarray(op.bt_apply(x)), np.asarray(dense.bt_apply(x)), rtol=2e-5
    )
    np.testing.assert_allclose(
        np.asarray(op.b_apply(w)), np.asarray(dense.b_apply(w)),
        atol=1e-6 * float(jnp.abs(dense.b_apply(w)).max()),
    )
    np.testing.assert_allclose(
        np.asarray(op.b_apply_add(w, x)),
        np.asarray(x + dense.b_apply(w)),
        atol=2e-5 * float(jnp.abs(x).max()),
    )



def _dense_minv(base, omega, sweep):
    """M^{-1} of one deterministic sweep from zero, as a dense matrix."""
    n = base.n
    eye = jnp.eye(n, dtype=base.dtype).reshape((n, *base.grid_shape))
    cols = jax.vmap(
        lambda e: sor_sweep(base, e, jnp.zeros_like(e), omega, sweep)
    )(eye)
    return np.asarray(cols, np.float64).reshape(n, n).T


@pytest.mark.parametrize("patches", [False, True])
@pytest.mark.parametrize("sweep", ["forward", "backward"])
@pytest.mark.parametrize("k", [1, 3, 5])
def test_lrc_half_step_matches_materialised_oracle(k, sweep, patches):
    from parmgmc_tpu.operators.lrc import with_patches

    grid = (7, 8, 9)
    base = shifted_laplace_fd(grid, 2.0, dtype=jnp.float64)
    rng = np.random.default_rng(k)
    coords = 0.2 + 0.6 * rng.random((k, 3))
    B, sigma_inv, f = make_observation_mats(
        grid, 0.05, coords, np.full(k, 0.2), obsvals=np.ones(k),
        dtype=jnp.float64,
    )
    op = LRCOperator(base=base, B=B, sigma_inv=sigma_inv)
    if patches:
        op = with_patches(op, max_fill=1.0)
        assert op.patch_vals is not None
    omega = 1.2
    smp = GibbsSampler.create(op, omega=omega, sweep=sweep)

    key = jax.random.PRNGKey(7)
    x = jax.random.normal(key, grid, jnp.float64)
    noises = [
        {
            "eta": jax.random.normal(jax.random.fold_in(key, 1), grid, jnp.float64),
            "eta_lr": jax.random.normal(jax.random.fold_in(key, 2), (k,), jnp.float64),
        }
    ]
    got = np.asarray(smp.step_with_noise(x, f, noises)).reshape(-1)

    A = np.asarray(base.to_dense(), np.float64)
    Bm = np.asarray(B, np.float64).reshape(-1, k)
    S = np.diag(1.0 / np.asarray(sigma_inv, np.float64))
    Minv = _dense_minv(base, omega, sweep)
    Bb = Minv @ Bm @ np.linalg.inv(S + Bm.T @ Minv @ Bm)
    d = np.diag(A)
    eta = np.asarray(noises[0]["eta"]).reshape(-1)
    eta2 = np.asarray(noises[0]["eta_lr"])
    bt = (
        np.asarray(f).reshape(-1)
        + np.sqrt((2 - omega) / omega * d) * eta
        + Bm @ (np.sqrt(np.asarray(sigma_inv)) * eta2)
    )
    x0 = np.asarray(x).reshape(-1)
    x1 = x0 + Minv @ (bt - A @ x0)
    want = x1 - Bb @ (Bm.T @ x1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10 * np.abs(want).max())


@pytest.mark.parametrize("k", [1, 3, 5])
def test_mgmc_posterior_step_matches_materialised_residual(k):
    """One posterior MGMC step equals x + cycle(b - A_post x) with the
    LRC residual formed from the dense posterior matrix."""
    grid = (8, 8, 8)
    base = shifted_laplace_fd(grid, 1.0, dtype=jnp.float64)
    rng = np.random.default_rng(10 + k)
    B, sigma_inv, f = make_observation_mats(
        grid, 0.05, 0.2 + 0.6 * rng.random((k, 3)), np.full(k, 0.3),
        obsvals=np.ones(k), dtype=jnp.float64,
    )
    op = LRCOperator(base=base, B=B, sigma_inv=sigma_inv)
    smp = MGMCSampler.create(op, n_levels=3, n_pre=1, n_post=0, coarsening="aggregate")
    from parmgmc_tpu.samplers.gibbs import _draw

    key = jax.random.PRNGKey(k)
    x = jax.random.normal(key, grid, jnp.float64)
    noises = _draw(jax.random.fold_in(key, 1), smp.noise_shapes(), jnp.float64)
    got = smp.step_with_noise(x, f, noises)
    A = np.asarray(op.to_dense(), np.float64)
    r = np.asarray(f).reshape(-1) - A @ np.asarray(x).reshape(-1)
    want = np.asarray(x) + np.asarray(
        smp._cycle(0, jnp.asarray(r.reshape(grid)), noises)
    )
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=0, atol=1e-11 * np.abs(want).max()
    )
