"""Structured-grid stencil operators.

This is the JAX analogue of the reference's sparse CSR matrices on
DMDA grids (ParMGMC keeps PETSc ``MATAIJ``; see
``/root/reference/src/problems.c:14-75`` for the canonical 5-point
shifted-Laplace assembly).  On an accelerator a sparse CSR sweep would
serialize; we
instead represent an SPD operator as a dense-stencil field over an
``(n0, n1[, n2])`` grid:

* ``offsets`` — static tuple of nonzero off-diagonal offsets in
  ``{-1,0,1}^d \\ {0}``,
* ``coeffs`` — one coefficient array per offset, either a scalar
  (constant-coefficient interior, the fast path) or a full grid-shaped
  array (needed for Galerkin-coarsened operators),
* ``diag`` — grid-shaped diagonal.

Matrix-vector products are sums of shifted element-wise multiplies —
elementwise work that XLA fuses into one pass over device memory.  Out-of-grid neighbours
contribute zero via zero padding, which exactly reproduces the
"links that exist" boundary convention of the reference FD assembly.
"""

from __future__ import annotations

import functools
import itertools
import math
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from parmgmc_tpu._pytree import pytree_dataclass

__all__ = [
    "StencilOperator",
    "FDStencilOperator",
    "shifted_laplace_fd",
    "prolong",
    "restrict",
    "coarse_shape",
    "galerkin_coarse_operator",
    "compress_stencil",
]


def _shifted(
    xp: jax.Array, off: Sequence[int], shape: Sequence[int], pad: int = 1
) -> jax.Array:
    """View of the pad-padded array ``xp`` holding x[i + off] at index i."""
    sl = tuple(slice(pad + o, pad + o + s) for o, s in zip(off, shape))
    return xp[sl]


@pytree_dataclass(meta=("offsets",))
class StencilOperator:
    """SPD operator A on a structured grid, stored as a stencil field."""

    offsets: tuple  # tuple[tuple[int, ...], ...], static
    coeffs: tuple  # tuple[jax.Array, ...] — scalar () or grid-shaped
    diag: jax.Array  # grid-shaped

    # -- basic properties -------------------------------------------------
    @property
    def grid_shape(self) -> tuple:
        return tuple(self.diag.shape)

    @property
    def ndim(self) -> int:
        return self.diag.ndim

    @property
    def n(self) -> int:
        return math.prod(self.grid_shape)

    @property
    def dtype(self):
        return self.diag.dtype

    def is_star(self) -> bool:
        """True if every offset touches exactly one coordinate (5/7-point)."""
        return all(sum(o != 0 for o in off) == 1 for off in self.offsets)

    @property
    def radius(self) -> int:
        """Maximum offset magnitude (1 for 5/7/9/27-point stencils)."""
        return max((max(abs(o) for o in off) for off in self.offsets), default=1)

    # -- linear algebra ----------------------------------------------------
    def apply(self, x: jax.Array) -> jax.Array:
        """y = A x for a grid-shaped x."""
        return self.diag * x + self.offdiag_apply(x)

    def offdiag_apply(self, x: jax.Array) -> jax.Array:
        """y = (A - D) x — the neighbour contributions only."""
        shape = self.grid_shape
        r = self.radius
        xp = jnp.pad(x, r)
        y = jnp.zeros_like(x)
        for off, c in zip(self.offsets, self.coeffs):
            y = y + c * _shifted(xp, off, shape, pad=r)
        return y

    def to_dense(self) -> jax.Array:
        """Assemble the dense (n, n) matrix. For tests and coarse grids only."""
        return _to_dense_jit(self)

    def to_csr(self):
        """scipy CSR assembly (host-side, eager).  Feeds the large-n
        sparse machinery: SparseCholeskySampler and the CPU baseline
        benchmark.  Row i holds diag[i] plus coeff_o[i] at column i+o
        for every in-grid offset o (matching :meth:`apply`)."""
        import numpy as np
        import scipy.sparse as sp

        shape = self.grid_shape
        n = self.n
        idx = np.arange(n).reshape(shape)
        rows = [np.arange(n)]
        cols = [np.arange(n)]
        vals = [np.asarray(self.diag, dtype=np.float64).reshape(-1)]
        for off, c in zip(self.offsets, self.coeffs):
            src = tuple(
                slice(max(0, -o), s - max(0, o)) for o, s in zip(off, shape)
            )
            dst = tuple(
                slice(max(0, o), s - max(0, -o)) for o, s in zip(off, shape)
            )
            r = idx[src].reshape(-1)
            rows.append(r)
            cols.append(idx[dst].reshape(-1))
            ca = np.asarray(c, dtype=np.float64)
            vals.append(
                np.full(r.size, float(ca))
                if ca.ndim == 0
                else ca[src].reshape(-1)
            )
        return sp.csr_matrix(
            (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
            shape=(n, n),
        )

    def scale_dtype(self, dtype) -> "StencilOperator":
        return StencilOperator(
            offsets=self.offsets,
            coeffs=tuple(c.astype(dtype) for c in self.coeffs),
            diag=self.diag.astype(dtype),
        )


class FDStencilOperator(StencilOperator):
    """Link-count FD operator with LAZY setup constants.

    Stores only the two scalars (kappa2, hinv2); ``diag`` and ``coeffs``
    are synthesized from iotas INSIDE whatever trace touches them, so a
    1024^3 operator costs 8 bytes of setup state instead of the 4.3 GB
    materialized diagonal (+ another 4.3 GB for the sampler's
    noise_scale).  The reference's PETSc assembly has no size ceiling
    (``/root/reference/src/problems.c:14-75``); this is the JAX
    equivalent.

    Subclasses :class:`StencilOperator` so every ``isinstance`` gate
    (hierarchy builders, samplers) keeps working; the
    inherited ``apply``/``offdiag_apply``/``to_dense``/``to_csr`` read
    ``diag``/``coeffs`` through the lazy properties.  Outside a trace,
    touching ``.diag`` materializes it (small grids / tests only).
    """

    def __init__(self, kappa2, hinv2, grid_shape, dtype=None):
        if dtype is None:
            dtype = jnp.asarray(kappa2).dtype
        object.__setattr__(self, "kappa2", jnp.asarray(kappa2, dtype))
        object.__setattr__(self, "hinv2", jnp.asarray(hinv2, dtype))
        object.__setattr__(
            self, "_grid_shape", tuple(int(s) for s in grid_shape)
        )
        d = len(self._grid_shape)
        offs = []
        for axis in range(d):
            for s in (-1, 1):
                off = [0] * d
                off[axis] = s
                offs.append(tuple(off))
        object.__setattr__(self, "offsets", tuple(offs))

    # -- lazy synthesis ----------------------------------------------------
    @property
    def grid_shape(self) -> tuple:
        return self._grid_shape

    @property
    def ndim(self) -> int:
        return len(self._grid_shape)

    @property
    def n(self) -> int:
        return math.prod(self._grid_shape)

    @property
    def dtype(self):
        return self.kappa2.dtype

    def links(self) -> jax.Array:
        """#in-grid neighbours per point, from iotas (fuses in-trace)."""
        shape = self._grid_shape
        links = jnp.zeros(shape, self.dtype)
        for ax in range(self.ndim):
            i = jax.lax.broadcasted_iota(jnp.int32, shape, ax)
            links = (
                links
                + (i >= 1).astype(self.dtype)
                + (i <= shape[ax] - 2).astype(self.dtype)
            )
        return links

    @property
    def diag(self) -> jax.Array:
        return self.kappa2 + self.hinv2 * self.links()

    @property
    def coeffs(self) -> tuple:
        c = -self.hinv2
        return tuple(c for _ in self.offsets)

    def scale_dtype(self, dtype) -> "FDStencilOperator":
        return FDStencilOperator(
            self.kappa2.astype(dtype),
            self.hinv2.astype(dtype),
            self._grid_shape,
            dtype=dtype,
        )

    def fd_params(self) -> jax.Array:
        """(kappa2, hinv2) stack — detect_fd_params' short-circuit."""
        return jnp.stack([self.kappa2, self.hinv2])


def _fd_unflatten(aux, kids):
    # no jnp.asarray here: unflatten must accept tracers and
    # ShapeDtypeStruct leaves verbatim (vmap/eval_shape paths)
    op = object.__new__(FDStencilOperator)
    object.__setattr__(op, "kappa2", kids[0])
    object.__setattr__(op, "hinv2", kids[1])
    object.__setattr__(op, "_grid_shape", aux[0])
    object.__setattr__(op, "offsets", aux[1])
    return op


jax.tree_util.register_pytree_node(
    FDStencilOperator,
    lambda op: ((op.kappa2, op.hinv2), (op._grid_shape, op.offsets)),
    _fd_unflatten,
)


@jax.jit
def _to_dense_jit(op: "StencilOperator") -> jax.Array:
    n = op.n
    eye = jnp.eye(n, dtype=op.dtype).reshape((n, *op.grid_shape))
    cols = jax.vmap(op.apply)(eye).reshape(n, n)
    return cols.T  # cols[i] = A e_i is column i


# above this many points the FD constructor returns the LAZY operator:
# a materialized diag at 768^3 is 1.8 GB of device memory (and its
# sampler's noise_scale another 1.8) that the sweep can synthesize
_FD_LAZY_THRESHOLD = 2**28  # 268M points: 768^3 and up


def fd_stencil(
    grid_shape: Sequence[int],
    kappa2: float,
    hinv2: float,
    dtype=jnp.float32,
    lazy: "bool | str" = "auto",
) -> StencilOperator:
    """Link-count-form FD star operator: off-diagonals ``-hinv2``,
    diagonal ``kappa2 + hinv2 * #in-grid neighbours``.  The diagonal is
    built on DEVICE from iotas — no grid-sized host constant, so setup
    at 768^3 neither allocates gigabytes of host memory nor copies
    them to the device.  Past ``_FD_LAZY_THRESHOLD``
    points (or with ``lazy=True``) returns :class:`FDStencilOperator`,
    whose diag/coeffs are synthesized in-trace — removing the setup
    ceiling at 1024^3 entirely."""
    grid_shape = tuple(int(s) for s in grid_shape)
    if lazy is True or (
        lazy == "auto" and math.prod(grid_shape) >= _FD_LAZY_THRESHOLD
    ):
        return FDStencilOperator(
            jnp.asarray(kappa2, dtype), jnp.asarray(hinv2, dtype), grid_shape
        )
    d = len(grid_shape)

    offsets = []
    for axis in range(d):
        for s in (-1, 1):
            off = [0] * d
            off[axis] = s
            offsets.append(tuple(off))

    links = jnp.zeros(grid_shape, dtype)
    for ax in range(d):
        i = jax.lax.broadcasted_iota(jnp.int32, grid_shape, ax)
        links = (
            links
            + (i >= 1).astype(dtype)
            + (i <= grid_shape[ax] - 2).astype(dtype)
        )
    diag = jnp.asarray(kappa2, dtype) + jnp.asarray(hinv2, dtype) * links
    coeffs = tuple(jnp.asarray(-hinv2, dtype=dtype) for _ in offsets)
    return StencilOperator(offsets=tuple(offsets), coeffs=coeffs, diag=diag)


def shifted_laplace_fd(
    grid_shape: Sequence[int], kappa: float, dtype=jnp.float32
) -> StencilOperator:
    """(kappa^2 - Laplace) with the reference's FD boundary convention.

    Matches ``/root/reference/src/problems.c:14-75``: off-diagonals are
    ``-1/h^2`` with ``h = 1/(n0 - 1)`` (the reference uses the first grid
    dimension for the spacing in every direction), and the diagonal is
    ``kappa^2`` plus ``1/h^2`` for each neighbour that exists.
    """
    grid_shape = tuple(int(s) for s in grid_shape)
    hinv2 = float((grid_shape[0] - 1) ** 2)
    return fd_stencil(grid_shape, float(kappa) ** 2, hinv2, dtype)


def detect_fd_params(op: "StencilOperator") -> "jax.Array | None":
    """(kappa2, hinv2) f32 stack if diag == kappa2 + hinv2 * #in-grid
    links and all off-diagonals equal -hinv2 (the link-count FD pattern,
    i.e. exactly what :func:`fd_stencil` builds); else None.  Requires
    SCALAR coefficients — array-valued (even if uniform) coefficient
    fields return None so callers fall back to general machinery rather
    than receiving grid-shaped "scalars".

    Detection inspects concrete values (``bool(jnp.allclose(...))``), so
    it only works EAGERLY — sampler setup is documented as an eager-mode
    operation.  Called on an operator of tracers (inside a user's jit)
    it returns None rather than raising, and callers fall back to the
    general (diag-streaming) machinery."""
    if isinstance(op, FDStencilOperator):
        # lazy FD operators ARE the pattern by construction; probing the
        # materialized diag here would allocate the full grid
        return op.fd_params()
    c0 = op.coeffs[0]
    if any(getattr(c, "ndim", 0) != 0 for c in op.coeffs):
        return None
    try:
        if not all(bool(jnp.allclose(c, c0)) for c in op.coeffs[1:]):
            return None
    except jax.errors.ConcretizationTypeError:
        return None
    hinv2 = -c0
    d = op.ndim
    shape = op.grid_shape
    links = jnp.zeros(shape, op.dtype)
    for ax in range(d):
        i = jax.lax.broadcasted_iota(jnp.int32, shape, ax)
        links = links + (i >= 1) + (i <= shape[ax] - 2)
    kappa2 = op.diag.reshape(-1)[op.n // 2] - hinv2 * links.reshape(-1)[op.n // 2]
    expected = kappa2 + hinv2 * links
    try:
        diag_matches = bool(jnp.allclose(op.diag, expected, rtol=1e-6))
    except jax.errors.ConcretizationTypeError:
        return None
    if diag_matches:
        # operator dtype: the hierarchy builder scales these exactly
        return jnp.stack(
            [kappa2.astype(op.dtype), jnp.asarray(hinv2, op.dtype)]
        )
    return None


# ---------------------------------------------------------------------------
# Grid-transfer operators (geometric multigrid).
#
# Vertex-style coarsening with coarse size ceil(n/2): coarse node i sits at
# fine node 2i; odd fine nodes interpolate linearly from their coarse
# neighbours.  On EVEN-sized dims the last fine node n-1 has only one
# coarse neighbour — it gets full weight 1 (nearest-neighbour extension)
# rather than 1/2, so constants are interpolated exactly everywhere.
# Without this the coarse correction cannot represent near-constant error
# at the boundary of Neumann-type operators and the V-cycle stalls.
# R = P^T exactly, which makes Galerkin products A_c = P^T A P exact —
# the analogue of PETSc's ``-pc_mg_galerkin both`` the reference injects
# (pc_gamgmc.c:344-349).
# ---------------------------------------------------------------------------


def coarse_shape(fine_shape: Sequence[int]) -> tuple:
    return tuple((int(s) + 1) // 2 for s in fine_shape)


def _shift_last(x: jax.Array, by: int) -> jax.Array:
    """x[..., i + by] with zero fill — a unit pad+slice (GSPMD-safe)."""
    n = x.shape[-1]
    pads = [(0, 0)] * (x.ndim - 1) + [(max(0, -by), max(0, by))]
    xp = jnp.pad(x, pads)
    return xp[..., max(0, by) : max(0, by) + n]


def _last_mask(n: int, dtype) -> jnp.ndarray:
    return (jnp.arange(n) == n - 1).astype(dtype)


def _prolong_1d(c: jax.Array, axis: int, nf: int) -> jax.Array:
    """1D linear interpolation along ``axis`` from ceil(nf/2) to nf points.

    Implemented with reshapes-to-pairs and unit shifts only: stride-2
    slices/scatters on sharded dims miscompile under the SPMD partitioner,
    so none are used on the (potentially sharded) even-size path.
    """
    c = jnp.moveaxis(c, axis, -1)
    nc = c.shape[-1]
    if nf % 2 == 1:
        # odd fine size: nc - 1 interior midpoints; never sharded (odd dims
        # don't divide a mesh), strided construction is fine.
        out_shape = c.shape[:-1] + (nf,)
        z = jnp.zeros(out_shape, dtype=c.dtype)
        z = z.at[..., 0::2].set(c)
        z = z.at[..., 1::2].set(0.5 * (c[..., :-1] + c[..., 1:]))
    else:
        c_next = _shift_last(c, 1)
        od = 0.5 * (c + c_next)
        # boundary fix: last odd fine node takes full weight from c[-1]
        od = od + 0.5 * c * _last_mask(nc, c.dtype)
        z = jnp.stack([c, od], axis=-1).reshape(c.shape[:-1] + (nf,))
    return jnp.moveaxis(z, -1, axis)


def _restrict_1d(f: jax.Array, axis: int) -> jax.Array:
    """Exact transpose of :func:`_prolong_1d` along ``axis``."""
    f = jnp.moveaxis(f, axis, -1)
    nf = f.shape[-1]
    nc = (nf + 1) // 2
    if nf % 2 == 1:
        y = f[..., 0::2]
        odds = f[..., 1::2]  # nc - 1 of them, all interior
        y = y.at[..., :-1].add(0.5 * odds)
        y = y.at[..., 1:].add(0.5 * odds)
    else:
        fr = f.reshape(f.shape[:-1] + (nc, 2))
        ev, od = fr[..., 0], fr[..., 1]
        y = ev + 0.5 * od + 0.5 * _shift_last(od, -1)
        # transpose of the boundary fix: f[-1] contributes 1.0 in total
        y = y + 0.5 * od * _last_mask(nc, f.dtype)
    return jnp.moveaxis(y, -1, axis)


def prolong(xc: jax.Array, fine_shape: Sequence[int]) -> jax.Array:
    """Interpolate a coarse-grid field to the fine grid ((bi/tri)linear)."""
    fine_shape = tuple(fine_shape)
    y = xc
    for axis, nf in enumerate(fine_shape):
        y = _prolong_1d(y, axis, nf)
    return y


def restrict(xf: jax.Array) -> jax.Array:
    """Full-weighting restriction, the exact transpose of :func:`prolong`."""
    y = xf
    for axis in range(xf.ndim):
        y = _restrict_1d(y, axis)
    return y


@functools.partial(jax.jit, static_argnames=("transfer",))
def galerkin_coarse_operator(op: StencilOperator, transfer=None) -> StencilOperator:
    """Exact Galerkin triple product A_c = P^T A P as a coarse stencil.

    T = P^T ∘ A ∘ P has stencil radius 1 on the coarse grid, so its
    coefficient fields are recovered exactly from T applied to 4^d "comb"
    indicator grids: impulses spaced 4 apart never interact, and
    ``u_phase[j] = T[j, j+off]`` for the unique comb column ``j+off`` of
    matching phase.  Extraction is a static gather over the stacked comb
    responses (no scatters — compiles fast, runs at 256^3+).  This
    replaces the reference's sparse ``MatPtAP`` under
    ``-pc_mg_galerkin both`` (pc_gamgmc.c:344-349) and remains exact for
    the boundary-corrected prolongation on even-sized grids.
    """
    fshape = op.grid_shape
    cshape = coarse_shape(fshape)
    d = len(fshape)
    dtype = op.dtype
    zero = (0,) * d
    # coarse radius: fine path length is P(1) + A(radius) + R(1) = r+2
    # fine units = 2*rc coarse units; comb spacing must exceed 2*rc.
    rc = (op.radius + 2) // 2
    spacing = 2 * rc + 2
    nphase = spacing**d

    # Phase code of each coarse node (mod `spacing` per axis), built from
    # iotas inside the trace (a 128^3 host constant would be embedded
    # in the executable).
    def phase_code(off):
        code = jnp.zeros(cshape, dtype=jnp.int32)
        for ax in range(d):
            i = jax.lax.broadcasted_iota(jnp.int32, cshape, ax)
            code = code * spacing + ((i + off[ax]) % spacing)
        return code

    pcode_j = phase_code(zero)

    if transfer is None:
        up = lambda v: prolong(v, fshape)
        down = restrict
    else:
        up, down = transfer.prolong, transfer.restrict

    def T(p):
        comb = (pcode_j == p).astype(dtype)
        return down(op.apply(up(comb)))

    U = jax.lax.map(T, jnp.arange(nphase, dtype=jnp.int32))  # (4^d, *coarse)

    rng = tuple(range(-rc, rc + 1))
    offsets = tuple(
        off for off in itertools.product(rng, repeat=d) if any(o != 0 for o in off)
    )

    def extract(off):
        # Row j's coefficient at offset off lives in the comb response of
        # phase (j + off) mod spacing (per axis) at position j; out-of-grid
        # neighbours yield 0 automatically (no comb point of that phase
        # within radius rc of j).
        sel = phase_code(off)[None]
        return jnp.take_along_axis(U, sel, axis=0)[0]

    coeffs = tuple(extract(off) for off in offsets)
    diag = extract(zero)
    return StencilOperator(offsets=offsets, coeffs=coeffs, diag=diag)


def compress_stencil(op: StencilOperator) -> StencilOperator:
    """Drop identically-zero offsets and scalarise constant coefficient
    fields (eager, setup-time).  Aggregation-coarsened star operators come
    back star with constant interiors, unlocking the 2-colour sweep at
    coarse levels too."""
    shape = op.grid_shape
    offsets, coeffs = [], []
    for off, c in zip(op.offsets, op.coeffs):
        c = jnp.asarray(c)
        if c.ndim == 0:
            if float(c) != 0.0:
                offsets.append(off)
                coeffs.append(c)
            continue
        # Only entries whose neighbour is in-grid matter (zero padding
        # nullifies the rest), so compare on the valid region only.
        valid = np.ones(shape, dtype=bool)
        for axis, o in enumerate(off):
            idx = [slice(None)] * len(shape)
            if o < 0:
                idx[axis] = slice(0, -o)
            elif o > 0:
                idx[axis] = slice(shape[axis] - o, shape[axis])
            else:
                continue
            valid[tuple(idx)] = False
        vals = np.asarray(c)[valid]
        lo, hi = float(vals.min()), float(vals.max())
        if lo == 0.0 and hi == 0.0:
            continue
        if lo == hi:
            offsets.append(off)
            coeffs.append(jnp.asarray(lo, dtype=c.dtype))
        else:
            offsets.append(off)
            coeffs.append(c)
    return StencilOperator(offsets=tuple(offsets), coeffs=tuple(coeffs), diag=op.diag)
