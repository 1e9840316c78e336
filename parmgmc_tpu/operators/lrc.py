"""Low-rank-corrected operators A_post = A + B Σ^{-1} B^T.

JAX analogue of PETSc's ``MATLRC`` as used throughout the reference
(``src/pc_mcgibbs.c:238-247``, ``src/mc_sor.c:565-595``): the posterior
precision of a Bayesian linear inverse problem with Gaussian prior
N(0, A^{-1}), observation operator B^T and noise covariance Σ (diagonal).

``B`` is stored grid-shaped ``(*grid, k)`` so every product is a single
batched contraction; ``sigma_inv`` is the length-k diagonal of Σ^{-1}
(PETSc's ``S`` vector convention).
"""

from __future__ import annotations

from typing import Union

import jax
import jax.numpy as jnp

from parmgmc_tpu._pytree import bcast_trailing as _bc
from parmgmc_tpu._pytree import pytree_dataclass
from parmgmc_tpu.operators.stencil import StencilOperator

__all__ = ["LRCOperator", "with_patches", "column_patches", "patch_apply_add"]

# f32 contractions run in TF32 on tensor-core GPUs unless asked not to.
HIGHEST = jax.lax.Precision.HIGHEST


def column_patches(cols_grid: jax.Array, max_fill: float = 0.25):
    """(patch_vals (k, *box), starts (k, ndim)) sparse view of localized
    columns, or None when the columns are not localized enough.

    Like :func:`with_patches` but (a) standalone — works on ANY
    grid-shaped column stack ``(*grid, k)``, e.g. the Woodbury factor
    Bb = M^{-1} B (Sigma + B^T M^{-1} B)^{-1}, whose columns have EXACT
    compact support for multicolour sweeps (M^{-1} widens a ball by at
    most ncolors-1 stencil rings — one ring for red/black; verified
    numerically, fill ~1e-2 at 32^3) — and (b) device-side: bounding
    boxes come from per-axis any-nonzero reductions, so only k*ndim
    scalars reach the host instead of the full (grid, k) stack
    (335 MB at 256^3 k=5).  EAGER only (reads concrete scalars)."""
    import numpy as np

    gshape = cols_grid.shape[:-1]
    k = cols_grid.shape[-1]
    d = len(gshape)
    nz = cols_grid != 0
    los, his = [], []
    for ax in range(d):
        axes = tuple(a for a in range(d) if a != ax)
        proj = jnp.any(nz, axis=axes)  # (n_ax, k)
        if not bool(jnp.all(jnp.any(proj, axis=0))):
            return None  # an empty column
        idx = jnp.arange(gshape[ax])[:, None]
        los.append(np.asarray(jnp.min(jnp.where(proj, idx, gshape[ax]), axis=0)))
        his.append(np.asarray(jnp.max(jnp.where(proj, idx, -1), axis=0)) + 1)
    ext = [int(max(h[j] - l[j] for j in range(k)) ) for l, h in zip(los, his)]
    if np.prod(ext) * k > max_fill * np.prod(gshape):
        return None
    starts = np.zeros((k, d), np.int32)
    vals = []
    for j in range(k):
        for ax in range(d):
            starts[j, ax] = min(int(los[ax][j]), gshape[ax] - ext[ax])
        vals.append(
            jax.lax.dynamic_slice(
                cols_grid[..., j], tuple(int(s) for s in starts[j]), ext
            )
        )
    return jnp.stack(vals), jnp.asarray(starts)


def patch_apply_add(patch_vals, patch_starts, w, y):
    """y + sum_j w[j] * column_j, columns given as common-size windows
    (`column_patches` layout); w may carry trailing chain dims (k, [C]).
    Sequential window updates (XLA aliases the dus chain) — the apply
    reads/writes k small boxes instead of k full grids."""
    k = patch_vals.shape[0]
    box = patch_vals.shape[1:]
    nd = len(box)
    batch = y.shape[nd:]
    out = y
    for j in range(k):
        st = tuple(patch_starts[j]) + (0,) * len(batch)
        win = jax.lax.dynamic_slice(out, st, box + batch)
        out = jax.lax.dynamic_update_slice(
            out, win + _bc(patch_vals[j], win) * w[j], st
        )
    return out


@pytree_dataclass
class LRCOperator:
    """A + B diag(sigma_inv) B^T with a stencil base operator A.

    ``patch_vals``/``patch_starts`` (optional) are a sparse view of B
    for LOCALIZED columns (ball-average observations touch a tiny
    fraction of the grid, obs.c:37-49): column j's nonzeros live in a
    common-size box at ``patch_starts[j]``.  When present, ``bt_apply``
    and ``b_apply`` run as k static dynamic-slices instead of dense
    (*grid, k) contractions, each of which reads the whole grid.  Build them with
    :func:`with_patches`; the fields default to None (dense fallback)
    and MUST only be attached eagerly (detection reads concrete
    values).  The dense B stays authoritative: patch products equal the
    dense ones up to fp summation order.
    """

    base: StencilOperator
    B: jax.Array  # (*grid, k)
    sigma_inv: jax.Array  # (k,)
    patch_vals: Union[jax.Array, None] = None  # (k, *box)
    patch_starts: Union[jax.Array, None] = None  # (k, ndim) int32

    @property
    def grid_shape(self):
        return self.base.grid_shape

    @property
    def ndim(self):
        return self.base.ndim

    @property
    def n(self):
        return self.base.n

    @property
    def k(self) -> int:
        return self.B.shape[-1]

    @property
    def dtype(self):
        return self.base.dtype

    def bt_apply(self, x: jax.Array) -> jax.Array:
        """(k,[C]) = B^T x for grid-shaped x (+ trailing chain dims)."""
        gaxes = tuple(range(self.ndim))
        if self.patch_vals is not None:
            box = self.patch_vals.shape[1:]
            batch = x.shape[self.ndim :]
            outs = []
            for j in range(self.k):  # k is small and static
                st = tuple(self.patch_starts[j]) + (0,) * len(batch)
                win = jax.lax.dynamic_slice(x, st, box + batch)
                outs.append(
                    jnp.sum(_bc(self.patch_vals[j], win) * win, axis=gaxes)
                )
            return jnp.stack(outs)
        return jnp.tensordot(self.B, x, axes=(gaxes, gaxes), precision=HIGHEST)

    def b_apply(self, w: jax.Array) -> jax.Array:
        """grid-shaped (+ trailing chain dims) = B w for (k,[C]) w."""
        if self.patch_vals is not None:
            batch = w.shape[1:]
            out = jnp.zeros(self.grid_shape + batch, self.B.dtype)
            return self.b_apply_add(w, out)
        return jnp.tensordot(
            self.B, w, axes=((self.ndim,), (0,)), precision=HIGHEST
        )

    def b_apply_add(self, w: jax.Array, y: jax.Array) -> jax.Array:
        """y + B w — with patches this updates y's ball windows in
        place (XLA aliases the dynamic_update_slice chain), avoiding
        the separate zeros+add pass of ``y + b_apply(w)``."""
        if self.patch_vals is None:
            return y + self.b_apply(w)
        return patch_apply_add(self.patch_vals, self.patch_starts, w, y)

    def apply(self, x: jax.Array) -> jax.Array:
        bt = self.bt_apply(x)
        return self.base.apply(x) + self.b_apply(_bc(self.sigma_inv, bt) * bt)

    def to_dense(self) -> jax.Array:
        Bf = self.B.reshape(self.n, self.k)
        return self.base.to_dense() + jnp.matmul(
            Bf * self.sigma_inv, Bf.T, precision=HIGHEST
        )


def with_patches(op: "LRCOperator", max_fill: float = 0.25) -> "LRCOperator":
    """Attach the sparse patch view of B when its columns are localized.

    EAGER ONLY (reads concrete values).  Finds each column's nonzero
    bounding box (numpy, host-side), pads all boxes to a common size,
    and stores (k, *box) values + (k, ndim) starts.  Returns the
    operator unchanged when the combined boxes exceed ``max_fill`` of
    the grid (dense contractions win there) or when a column is empty.
    """
    import numpy as np

    if op.patch_vals is not None:
        return op
    B = np.asarray(op.B)
    gshape = B.shape[:-1]
    k = B.shape[-1]
    d = len(gshape)
    boxes = []
    for j in range(k):
        nz = np.nonzero(B[..., j])
        if nz[0].size == 0:
            return op
        boxes.append([(int(a.min()), int(a.max()) + 1) for a in nz])
    ext = [max(hi - lo for (lo, hi) in (b[ax] for b in boxes)) for ax in range(d)]
    if np.prod(ext) * k > max_fill * np.prod(gshape):
        return op
    starts = np.zeros((k, d), np.int32)
    vals = np.zeros((k, *ext), B.dtype)
    for j in range(k):
        for ax in range(d):
            lo = boxes[j][ax][0]
            # clamp so the common box stays inside the grid
            starts[j, ax] = min(lo, gshape[ax] - ext[ax])
        sl = tuple(
            slice(int(starts[j, ax]), int(starts[j, ax]) + ext[ax])
            for ax in range(d)
        )
        vals[j] = B[sl + (j,)]
    return LRCOperator(
        base=op.base,
        B=op.B,
        sigma_inv=op.sigma_inv,
        patch_vals=jnp.asarray(vals),
        patch_starts=jnp.asarray(starts),
    )
