"""Grid-transfer abstractions for multigrid hierarchies.

Two implementations of the same protocol (``prolong(xc) -> xf``,
``restrict(xf) -> xc`` with restrict = prolong^T):

* :class:`GeometricTransfer` — the closed-form structured-grid transfers
  (vertex-style linear interpolation / full weighting) from
  ``operators.stencil``;
* :class:`SparseTransfer` — an explicit sparse P in ELL form, used by the
  algebraic (smoothed-aggregation) hierarchy on unstructured meshes —
  the analogue of PETSc GAMG's prolongators consumed by the reference's
  MGMC (pc_gamgmc.c / `-pc_mg_galerkin both`).  Both P and P^T are
  stored as gathers so neither direction needs a scatter.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from parmgmc_tpu._pytree import bcast_trailing as _bc
from parmgmc_tpu._pytree import pytree_dataclass
from parmgmc_tpu.operators import stencil as _st

__all__ = ["GeometricTransfer", "SparseTransfer", "sparse_transfer_from_csr"]


@pytree_dataclass(meta=("fine_shape",))
class GeometricTransfer:
    fine_shape: tuple

    def prolong(self, xc):
        return _st.prolong(xc, self.fine_shape)

    def restrict(self, xf):
        return _st.restrict(xf)


def _agg_up_1d(c, axis, nf):
    c = jnp.moveaxis(c, axis, -1)
    nc = c.shape[-1]
    m = nf // 2
    main = jnp.broadcast_to(c[..., :m, None], c.shape[:-1] + (m, 2)).reshape(
        c.shape[:-1] + (2 * m,)
    )
    if nf % 2:  # odd: last coarse cell covers a single fine node
        main = jnp.concatenate([main, c[..., m:]], axis=-1)
    return jnp.moveaxis(main, -1, axis)


def _agg_down_1d(f, axis):
    f = jnp.moveaxis(f, axis, -1)
    nf = f.shape[-1]
    m = nf // 2
    # explicit pair add == .sum(-1) bitwise
    fp = f[..., : 2 * m].reshape(f.shape[:-1] + (m, 2))
    pair = fp[..., 0] + fp[..., 1]
    if nf % 2:
        pair = jnp.concatenate([pair, f[..., 2 * m :]], axis=-1)
    return jnp.moveaxis(pair, -1, axis)


@pytree_dataclass(meta=("fine_shape",))
class AggregateTransfer:
    """Plain (piecewise-constant) aggregation over 2^d cell blocks.

    P sums/injects over aggregates; crucially, the Galerkin product
    P^T A P of a STAR stencil stays a star stencil (a 2-block offset in
    two axes cannot be bridged by a radius-1 fine edge), so every level
    of an aggregation hierarchy keeps the cheap 2-colour sweep — the
    structured-grid analogue of GAMG's unsmoothed aggregation.
    """

    fine_shape: tuple

    def prolong(self, xc):
        y = xc
        for axis, nf in enumerate(self.fine_shape):
            y = _agg_up_1d(y, axis, nf)
        return y

    def restrict(self, xf):
        y = xf
        for axis in range(xf.ndim):
            y = _agg_down_1d(y, axis)
        return y


@pytree_dataclass
class SparseTransfer:
    """P (nf x nc) stored as row-gather ELL in both orientations.

    Applies accept a trailing chain axis (``(n, C)`` chain-major
    multichain layout) and run as per-k ROW gathers — each gathered
    element is a contiguous C-wide row."""

    p_vals: jax.Array  # (nf, w)
    p_cols: jax.Array  # (nf, w) int32 into coarse
    pt_vals: jax.Array  # (nc, wt)
    pt_cols: jax.Array  # (nc, wt) int32 into fine

    @staticmethod
    def _ell_apply(vals, cols, x):
        if vals.shape[0] < 8192:
            # small coarse levels: one flat gather keeps the op count
            # down (w tiny gathers would cost more in dispatch/compile
            # than the few KB of padding bandwidth they save)
            g = x[cols]
            return jnp.sum(_bc(vals, g) * g, axis=1)
        out = None
        for k in range(vals.shape[1]):
            contrib = _bc(vals[:, k], x) * x[cols[:, k]]
            out = contrib if out is None else out + contrib
        return out

    def prolong(self, xc):
        return self._ell_apply(self.p_vals, self.p_cols, xc)

    def restrict(self, xf):
        return self._ell_apply(self.pt_vals, self.pt_cols, xf)


def _ell_from_csr(M, dtype):
    import scipy.sparse as sp

    M = sp.csr_matrix(M)
    n = M.shape[0]
    w = max(1, int(np.diff(M.indptr).max()))
    vals = np.zeros((n, w))
    cols = np.zeros((n, w), dtype=np.int32)
    for i in range(n):
        lo, hi = M.indptr[i], M.indptr[i + 1]
        k = hi - lo
        vals[i, :k] = M.data[lo:hi]
        cols[i, :k] = M.indices[lo:hi]
        if k < w:
            cols[i, k:] = cols[i, 0] if k else 0
    return jnp.asarray(vals, dtype=dtype), jnp.asarray(cols)


def sparse_transfer_from_csr(P, dtype=jnp.float64) -> SparseTransfer:
    p_vals, p_cols = _ell_from_csr(P, dtype)
    pt_vals, pt_cols = _ell_from_csr(P.T, dtype)
    return SparseTransfer(
        p_vals=p_vals, p_cols=p_cols, pt_vals=pt_vals, pt_cols=pt_cols
    )
