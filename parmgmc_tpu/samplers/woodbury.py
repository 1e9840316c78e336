"""Woodbury composite sampler: posterior samples from a prior sampler.

Rebuild of the reference's ``woodbury`` PC (``/root/reference/src/
woodbury.c``): given an LRC posterior precision A + B Sigma^{-1} B^T,
wrap ANY sampler targeting the prior N(A^{-1}., A^{-1}) into a posterior
sampler.  Per iteration (woodbury.c:259-286):

    w  = b + B sqrt(Sigma^{-1}) eta2
    y  <- one prior-sampler step with RHS w
    y  <- y - G (B^T y),     G = A^{-1} B (Sigma + B^T A^{-1} B)^{-1}

G is built at setup with an exact solver for A (woodbury.c:21-86 uses a
solver PC column by column; we batch a dense solve / CG over the k
columns).

Note on exactness: the A^{-1}-based correction leaves the posterior
invariant exactly when the inner sampler draws *exact* prior samples
(CholeskySampler) — which is how the reference drives it
(``examples/ex13.py:29-30``: ``-pc_woodbury_sampler cholsampler``).
With an inexact inner sampler (Gibbs/MGMC) the composite kernel is
biased; for those, use the sampler directly on the ``LRCOperator``
(the reference's mcgibbs/gamgmc-on-MATLRC path), whose per-sweep
M^{-1}-based correction is exactly invariant — verified at 1e-10 in
tests/test_sampler_exactness.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from parmgmc_tpu._pytree import pytree_dataclass
from parmgmc_tpu.operators.lrc import HIGHEST, LRCOperator
from parmgmc_tpu.samplers.gibbs import _draw

__all__ = ["WoodburySampler"]


def _solve_columns_dense(base, B):
    """A^{-1} B by a dense solve (small/medium n; exact)."""
    n = base.n
    A = base.to_dense()
    Bf = B.reshape(n, -1)
    return jnp.linalg.solve(A, Bf).reshape(B.shape)


def _solve_columns_cg(base, B, tol=None, maxiter=10_000):
    """A^{-1} B matrix-free via CG (large n)."""
    ndim = base.ndim
    if tol is None:
        # dtype-aware: 1e-10 is unreachable in f32 and would silently
        # burn maxiter iterations per column.
        tol = 1e-10 if B.dtype == jnp.float64 else 2e-6

    def solve_one(col):
        x, _ = jax.scipy.sparse.linalg.cg(base.apply, col, tol=tol, maxiter=maxiter)
        return x

    cols = jnp.moveaxis(B, -1, 0)
    return jnp.moveaxis(jax.vmap(solve_one)(cols), 0, ndim)


@pytree_dataclass
class WoodburySampler:
    sampler: object  # prior sampler targeting N(A^{-1}., A^{-1})
    B: jax.Array  # (*grid, k)
    sqrt_sigma_inv: jax.Array  # (k,)
    G: jax.Array  # (*grid, k)

    @staticmethod
    def create(op: LRCOperator, sampler, solver: str = "auto") -> "WoodburySampler":
        base, B, sigma_inv = op.base, op.B, op.sigma_inv
        k = B.shape[-1]
        if solver == "dense" or (solver == "auto" and base.n <= 16384):
            C = _solve_columns_dense(base, B)
        else:
            C = _solve_columns_cg(base, B)
        ndim = base.ndim
        # (k, k) = B^T C: contract grid axes only
        BtC = jnp.tensordot(
            jnp.moveaxis(B, -1, 0),
            jnp.moveaxis(C, -1, 0),
            axes=(tuple(range(1, ndim + 1)),) * 2,
            precision=HIGHEST,
        )
        small = jnp.diag(1.0 / sigma_inv) + BtC  # Sigma + B^T A^{-1} B
        Sb = jnp.linalg.solve(small, jnp.eye(k, dtype=B.dtype))
        G = jnp.tensordot(
            jnp.moveaxis(C, -1, 0), Sb, axes=((0,), (0,)), precision=HIGHEST
        )
        return WoodburySampler(
            sampler=sampler, B=B, sqrt_sigma_inv=jnp.sqrt(sigma_inv), G=G
        )

    @property
    def grid_shape(self):
        return self.sampler.grid_shape

    @property
    def base(self):
        return self.sampler.base

    @property
    def dtype(self):
        return self.B.dtype

    def noise_shapes(self):
        return {
            "eta_lr": (self.B.shape[-1],),
            "inner": self.sampler.noise_shapes(),
        }

    def step_with_noise(self, x, b, noises):
        if b is None:  # zero-RHS (prior) convention
            b = jnp.zeros_like(x)
        ndim = self.B.ndim - 1
        w = b + jnp.tensordot(
            self.B,
            self.sqrt_sigma_inv * noises["eta_lr"],
            axes=((ndim,), (0,)),
            precision=HIGHEST,
        )
        y = self.sampler.step_with_noise(x, w, noises["inner"])
        axes = tuple(range(ndim))
        bty = jnp.tensordot(self.B, y, axes=(axes, axes), precision=HIGHEST)
        return y - jnp.tensordot(
            self.G, bty, axes=((ndim,), (0,)), precision=HIGHEST
        )

    def prepare(self, b):
        return None

    def step(self, key, x, b, aux=None):
        key, sub = jax.random.split(key)
        noises = _draw(sub, self.noise_shapes(), x.dtype)
        return key, self.step_with_noise(x, b, noises)
