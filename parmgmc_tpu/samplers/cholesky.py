"""Exact Cholesky sampler.

Rebuild of the reference's ``cholsampler`` PC (``/root/reference/src/
pc_chols.c``): draw i.i.d. exact samples of N(A^{-1}b, A^{-1}) via

    v = L^{-1} b,   y = L^{-T}(v + eta),   eta ~ N(0, I),   A = L L^T

(pc_chols.c:262-291).  The reference factors sparsely with MKL
(C)Pardiso plus a dense LAPACK fast path for small blocks
(pc_chols.c:174-194); on the device the coarse grids this serves are small
(<= a few thousand DOFs), so a dense ``lax.linalg.cholesky`` is both
simpler and faster.

The per-sample map is applied with a CACHED EXPLICIT INVERSE factor
``Li = L^{-1}`` (computed once at ``create``): a triangular solve is a
latency-bound sequential recurrence, while ``y = Li^T (Li b + eta)`` is
two dense matvecs.  Same linear map, so
exactness (N(A^{-1}b, A^{-1})) is preserved to rounding; coarse
operators are strongly diagonally dominant (aggregation multiplies
kappa^2 by 2^d per level), so the inversion is well-conditioned.
``create`` verifies ``Li L ~= I`` to near-rounding and silently falls
back to backward-stable triangular solves (Li = None) when the
operator is too ill-conditioned for the explicit inverse — standalone
users on arbitrary operators keep solve accuracy.

``prepare`` caches v = Li b once per chain so repeated samples with a
FIXED b cost one matvec each, the analogue of the Richardson
``v_cache`` optimisation (pc_chols.c:293-342); inside an MGMC cycle
the coarse RHS changes every step, so both matvecs run per sample.
For LRC operators the posterior precision A + B Sigma^{-1} B^T is
assembled densely before factoring (pc_chols.c:118-152).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from parmgmc_tpu._pytree import pytree_dataclass

__all__ = ["CholeskySampler", "SparseCholeskySampler", "exact_sampler"]

# f32 matmuls run in TF32 on tensor-core GPUs unless asked not to; an
# inexact coarse draw wrecks MGMC mixing (docs/samplers.md).
HIGHEST = jax.lax.Precision.HIGHEST


@pytree_dataclass(meta=("grid_shape",))
class CholeskySampler:
    L: jax.Array  # (n, n) lower Cholesky factor of the (possibly LRC) operator
    Li: jax.Array  # (n, n) L^{-1}: per-sample solves become matvecs
    grid_shape: tuple

    @staticmethod
    def create(op) -> "CholeskySampler":
        A = op.to_dense()
        L = jnp.linalg.cholesky(A)
        n = L.shape[0]
        Li = jax.scipy.linalg.solve_triangular(
            L, jnp.eye(n, dtype=L.dtype), lower=True
        )
        # Keep the explicit inverse only when it reproduces the identity
        # to near-rounding: the matvec fast path must not silently trade
        # accuracy on ill-conditioned operators — the diagonal-dominance
        # argument holds for MGMC coarse levels, not for arbitrary user
        # operators.  Otherwise fall back to backward-stable solves.
        err = float(
            jnp.abs(
                jnp.matmul(Li, L, precision=HIGHEST) - jnp.eye(n, dtype=L.dtype)
            ).max()
        )
        if err > 1000 * float(jnp.finfo(L.dtype).eps):
            Li = None
        return CholeskySampler(L=L, Li=Li, grid_shape=op.grid_shape)

    @property
    def n(self) -> int:
        return self.L.shape[0]

    @property
    def dtype(self):
        return self.L.dtype

    def noise_shapes(self):
        return [{"eta": (self.n,)}]

    def _flat(self, b):
        """Flatten the grid dims of b to (n, [C]) keeping trailing chain
        dims (the chain-major multichain layout)."""
        batch = b.shape[len(self.grid_shape) :]
        return b.reshape((self.n,) + batch)

    def prepare(self, b):
        """Cache v = L^{-1} b (reused across every sample of the chain);
        ``b=None`` is a zero RHS."""
        if b is None:
            b = jnp.zeros(self.grid_shape, self.dtype)
        if self.Li is None:
            return jax.scipy.linalg.solve_triangular(
                self.L, self._flat(b), lower=True
            )
        return jnp.matmul(self.Li, self._flat(b), precision=HIGHEST)

    def step_with_noise(self, x, b, noises, aux=None):
        del x  # exact sampler: iterates are i.i.d.
        v = aux if aux is not None else self.prepare(b)
        w = v + noises[0]["eta"]
        if self.Li is None:
            y = jax.scipy.linalg.solve_triangular(self.L.T, w, lower=False)
        else:
            y = jnp.matmul(self.Li.T, w, precision=HIGHEST)
        return y.reshape(self.grid_shape + w.shape[1:])

    def step(self, key, x, b, aux=None):
        key, sub = jax.random.split(key)
        batch = x.shape[len(self.grid_shape) :]
        eta = jax.random.normal(sub, (self.n,) + batch, dtype=self.dtype)
        return key, self.step_with_noise(x, b, [{"eta": eta}], aux)


class SparseCholeskySampler:
    """Large-n exact sampler via sparse LDL^T factorization (host-side).

    Covers the reference cholsampler's PRODUCTION regime: standalone
    exact sampling of 100k+-DOF problems via a sparse direct factor —
    the reference uses MKL (C)Pardiso (``pc_chols.c:17-27``, parallel
    conversion ``:162-164``) and runs it standalone on the refined
    wrench mesh as the ex13 baseline comparator (``examples/ex13.py:
    29-30``).

    Design stance: an exact sparse factorization and its triangular
    solves are sequential, latency-bound recurrences — the wrong shape
    for an accelerator, and the reference runs them on CPU too.  So this
    sampler lives on the HOST (scipy SuperLU in symmetric mode: with
    ``diag_pivot_thresh=0`` + ``SymmetricMode`` on an SPD matrix the
    factorization is P A P^T = L D L^T with unit-lower L and D > 0 —
    verified against the operator at create time), while on-device
    exact sampling remains the dense :class:`CholeskySampler` (use
    :func:`exact_sampler` for the reference's dense-threshold dispatch,
    ``-pc_cholsampler_dense_threshold``).

    Sampling map (exact, i.i.d.):

        x = A^{-1} b + P^T L^{-T} D^{-1/2} eta,     eta ~ N(0, I)

    For LRC (posterior) operators A_post = A + B Sigma^{-1} B^T the
    BASE operator is factored sparsely and posterior draws use
    Matheron's rule (exceeds the reference, which assembles the
    low-rank correction into the matrix it factors, pc_chols.c:118-152):

        x0 = S eta (prior draw),   eps ~ N(0, Sigma)
        x  = mu + x0 - C M^{-1} (B^T x0 + eps),
        C  = A^{-1} B,   M = Sigma + B^T C,
        mu = A^{-1} b - C M^{-1} B^T A^{-1} b       (Woodbury)

    whose covariance is exactly A_post^{-1}.  Everything here is eager
    host code (numpy in, numpy out); ``step`` offers a chain-driver
    compatible wrapper for eager (non-jit) composition.
    """

    def __init__(self, lu, d_sqrt, pc, grid_shape, dtype, lrc=None):
        self._lu = lu
        self._d_sqrt = d_sqrt  # sqrt(diag D)
        self._pc = pc  # column permutation (perm_c == perm_r^T -> P)
        self.grid_shape = tuple(grid_shape)
        self.dtype = dtype
        self._lrc = lrc  # None | dict(B, sigma, C, M_cho)
        self._Lt = None  # cached CSR of L^T for the triangular solves

    @staticmethod
    def create(op) -> "SparseCholeskySampler":
        import numpy as np
        from scipy.sparse.linalg import splu

        from parmgmc_tpu.operators.lrc import LRCOperator

        lrc_op = op if isinstance(op, LRCOperator) else None
        base = op.base if lrc_op is not None else op
        if not hasattr(base, "to_csr"):
            raise TypeError(
                f"{type(base).__name__} exposes no to_csr(); sparse exact "
                "sampling needs a sparse assembly"
            )
        A = base.to_csr().tocsc()
        n = A.shape[0]
        lu = splu(
            A,
            permc_spec="MMD_AT_PLUS_A",
            diag_pivot_thresh=0.0,
            options=dict(SymmetricMode=True),
        )
        d = lu.U.diagonal()
        if not (d > 0).all():
            raise ValueError(
                "SuperLU symmetric-mode factorization produced a "
                "non-positive pivot — operator is not SPD"
            )
        if not np.array_equal(lu.perm_r, lu.perm_c):
            raise ValueError(
                "SuperLU pivoted despite SymmetricMode — the LDL^T "
                "reading of the factors does not hold for this matrix"
            )
        # verify A = P^T L D L^T P on a random probe to near-rounding
        rng = np.random.default_rng(0)
        v = rng.standard_normal(n)
        err = np.abs(A @ lu.solve(v) - v).max() / np.abs(v).max()
        if err > 1e-8:
            raise ValueError(f"sparse factor residual too large: {err}")
        lrc = None
        if lrc_op is not None:
            B = np.asarray(lrc_op.B, dtype=np.float64).reshape(n, -1)
            sigma = 1.0 / np.asarray(lrc_op.sigma_inv, dtype=np.float64)
            C = lu.solve(B)  # A^{-1} B, k sparse solves, once
            M = np.diag(sigma) + B.T @ C
            lrc = dict(B=B, sigma=sigma, C=C, M_cho=np.linalg.cholesky(M))
        return SparseCholeskySampler(
            lu, np.sqrt(d), lu.perm_c, base.grid_shape, base.dtype, lrc
        )

    @property
    def n(self) -> int:
        return self._d_sqrt.shape[0]

    def mean(self, b):
        """A^{-1} b (resp. A_post^{-1} b) as a numpy grid-shaped array."""
        import numpy as np

        bf = np.asarray(b, dtype=np.float64).reshape(self.n)
        mu = self._lu.solve(bf)
        if self._lrc is not None:
            from scipy.linalg import cho_solve

            lr = self._lrc
            mu = mu - lr["C"] @ cho_solve(
                (lr["M_cho"], True), lr["B"].T @ mu
            )
        return mu.reshape(self.grid_shape)

    def _sqrt_apply(self, eta):
        """P^T L^{-T} D^{-1/2} eta for (n, m) eta — m samples batched
        through one triangular solve."""
        import scipy.sparse as sp
        from scipy.sparse.linalg import spsolve_triangular

        if self._Lt is None:
            self._Lt = sp.csr_matrix(self._lu.L.T)
        y = spsolve_triangular(
            self._Lt, eta / self._d_sqrt[:, None], lower=False
        )
        return y[self._pc]

    def sample(self, seed, n_samples: int, b=None):
        """(n_samples, *grid_shape) i.i.d. exact samples (numpy)."""
        import numpy as np

        rng = np.random.default_rng(seed)
        x0 = self._sqrt_apply(rng.standard_normal((self.n, n_samples)))
        if self._lrc is not None:
            from scipy.linalg import cho_solve

            lr = self._lrc
            eps = rng.standard_normal((len(lr["sigma"]), n_samples))
            eps *= np.sqrt(lr["sigma"])[:, None]
            v = lr["B"].T @ x0 + eps
            x0 = x0 - lr["C"] @ cho_solve((lr["M_cho"], True), v)
        if b is not None:
            x0 = x0 + self.mean(b).reshape(self.n)[:, None]
        return np.moveaxis(x0, -1, 0).reshape(n_samples, *self.grid_shape)

    def prepare(self, b):
        """Cache the (expensive) posterior mean for a fixed chain RHS —
        b is constant along a chain, so the sparse solve pair (plus the
        Woodbury solve for LRC) runs once, not per step."""
        import numpy as np

        if b is None:
            return np.zeros(self.grid_shape)
        return np.asarray(self.mean(b))

    def step(self, key, x, b, aux=None):
        """Chain-driver-compatible wrapper (EAGER host execution only —
        this sampler cannot appear inside jit/scan; exact samplers are
        i.i.d., so drive them with :meth:`sample`)."""
        import numpy as np

        del x
        key, sub = jax.random.split(key)
        seed = int(np.asarray(jax.random.key_data(sub)).ravel()[-1])
        out = self.sample(seed, 1, b=None)[0]
        mu = aux if aux is not None else self.prepare(b)
        out = out + np.asarray(mu, dtype=out.dtype)
        return key, jnp.asarray(out, dtype=self.dtype)


def exact_sampler(op, dense_threshold: int = 20_000):
    """Reference-style dispatch (``-pc_cholsampler_dense_threshold``):
    dense CholeskySampler below the threshold, host-side sparse
    LDL^T above it (pc_chols.c:174-194 picks LAPACK vs Pardiso the same
    way)."""
    import math

    n = math.prod(op.grid_shape)
    if n <= dense_threshold:
        return CholeskySampler.create(op)
    return SparseCholeskySampler.create(op)
