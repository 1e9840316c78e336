"""Multicolor SOR / Gauss-Seidel sweeps on stencil operators.

JAX rebuild of the reference's multicolour sweep kernel
(``/root/reference/src/mc_sor.c:241-381``).  Instead of a CSR row loop
over JP-colored index sets with per-color MPI ghost scatters, we exploit
the structured grid: a parity coloring is a valid distance-1 coloring for
any 3^d stencil —

* star stencils (5/7-point): 2 colors by total-coordinate parity
  (red/black),
* dense 3^d stencils (Galerkin-coarsened): 2^d colors by per-coordinate
  parity.

Each color update is one masked, fully-vectorised stencil pass;
colors are applied sequentially, which preserves the Gauss-Seidel
dependency structure exactly as the reference's color loop does.  The
deterministic forward sweep from ``x`` computes
``x' = x + M^{-1}(b - A x)`` with ``M = D/omega + L`` where ``L`` is the
strictly-lower part of A in the color ordering — the same family of
iteration operators as the reference (a different color order than JP,
which changes only the iteration operator, not the targeted
distribution).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from parmgmc_tpu._pytree import pytree_dataclass
from parmgmc_tpu.operators.stencil import StencilOperator

__all__ = [
    "color_masks",
    "num_colors",
    "sor_sweep",
    "natural_sweep",
    "NaturalGibbsSampler",
]


def num_colors(op: StencilOperator) -> int:
    r = op.radius
    return (r + 1) if op.is_star() else (r + 1) ** op.ndim


def color_masks(grid_shape, ncolors: int, op: StencilOperator = None):
    """Boolean masks, one per color, tiling the grid.

    Built from broadcasted iotas *inside* the trace (never as host
    constants — a 256^3 constant mask would bloat the executable), so XLA
    fuses the mask computation into the update.

    Star stencils of radius r: color = (sum of coords) mod (r+1)
    (red/black for r=1).  Dense stencils: base-(r+1) code of the
    per-coordinate residues — a valid distance-type coloring for any
    stencil contained in {-r..r}^d.
    """
    d = len(grid_shape)
    r = op.radius if op is not None else 1
    base = r + 1
    if ncolors == base:  # star coloring
        code = sum(
            jax.lax.broadcasted_iota(jnp.int32, grid_shape, ax) for ax in range(d)
        ) % base
    elif ncolors == base**d:
        code = jnp.zeros(grid_shape, dtype=jnp.int32)
        for ax in range(d):
            code = base * code + (
                jax.lax.broadcasted_iota(jnp.int32, grid_shape, ax) % base
            )
    else:
        raise ValueError(f"unsupported ncolors={ncolors} for d={d}, r={r}")
    return tuple(code == c for c in range(ncolors))


def sor_sweep(
    op: StencilOperator,
    b,
    x,
    omega: float = 1.0,
    sweep: str = "forward",
    masks=None,
):
    """One multicolor SOR sweep; ``sweep`` in {forward, backward, symmetric}.

    Matches the per-row update of mc_sor.c:260-267:
    ``x_r <- (1-omega) x_r + (omega/d_r) (b_r - sum_{j != r} a_rj x_j)``
    applied color by color (backward = reverse color order; symmetric =
    forward then backward, cf. MCSORApply at mc_sor.c:223-232).
    """
    if masks is None:
        masks = color_masks(op.grid_shape, num_colors(op), op)
    if sweep == "symmetric":
        x = sor_sweep(op, b, x, omega, "forward", masks)
        return sor_sweep(op, b, x, omega, "backward", masks)
    order = range(len(masks)) if sweep == "forward" else reversed(range(len(masks)))
    inv_diag = omega / op.diag
    for c in order:
        r = b - op.offdiag_apply(x)
        xc = (1.0 - omega) * x + inv_diag * r
        x = jnp.where(masks[c], xc, x)
    return x


def natural_sweep(
    op: StencilOperator, b, x, omega: float = 1.0, sweep: str = "forward"
):
    """EXACT natural-order (lexicographic) SOR sweep by wavefronts.

    The production equivalent of the reference's PCPARSOR
    (``src/pc_parsor.c:703-878``), which keeps the exact lexicographic
    update order across MPI ranks with a dependency-driven dataflow
    pipeline.  The data-parallel scheduling is the classic wavefront
    observation: for a STAR stencil every lower-lexicographic neighbour
    of a cell has a strictly smaller coordinate sum and no two
    equal-sum cells couple, so updating whole anti-diagonal hyperplanes
    ``sum(coords) == s`` in increasing s reproduces lexicographic
    Gauss-Seidel EXACTLY in arithmetic (verified to 1e-14 against the
    sequential scan in tests).  Non-star stencils (e.g. squared
    radius-2 priors with cross terms) use a SKEWED wavefront: per-axis
    weights ``w_d = 1, w_ax = r * sum(later w) + 1`` guarantee every
    lexicographically-negative offset has ``w . o < 0`` and no offset
    has ``w . o == 0``, so skewed hyperplanes ``w . coords == s`` again
    reproduce the natural order exactly (at ``w_0 (N_0-1) + ...``
    passes instead of ``sum(N_ax - 1) + 1``).  Each wavefront is one
    fully-vectorised masked pass — the price of exact natural order
    (the multicolour ``sor_sweep`` needs only r + 1 passes, and the
    measured IACT/spectral-radius gap between the two orderings is
    zero for this operator family; docs/samplers.md).
    """
    if sweep == "symmetric":
        x = natural_sweep(op, b, x, omega, "forward")
        return natural_sweep(op, b, x, omega, "backward")
    d = op.ndim
    shape = op.grid_shape
    if op.is_star():
        w = [1] * d
    else:
        r = op.radius
        w = [1] * d
        for ax in reversed(range(d - 1)):
            w[ax] = r * sum(w[ax + 1 :]) + 1
    S = sum(wi * (n - 1) for wi, n in zip(w, shape)) + 1
    code = sum(
        w[ax] * jax.lax.broadcasted_iota(jnp.int32, shape, ax)
        for ax in range(d)
    )
    inv_diag = omega / op.diag
    forward = sweep == "forward"

    def body(i, x):
        s = i if forward else S - 1 - i
        r = b - op.offdiag_apply(x)
        xc = (1.0 - omega) * x + inv_diag * r
        return jnp.where(code == s, xc, x)

    return jax.lax.fori_loop(0, S, body, x, unroll=False)


@pytree_dataclass(meta=("omega", "sweep"))
class NaturalGibbsSampler:
    """Stochastic SOR Gibbs sampler in EXACT natural (lexicographic)
    order — the PCPARSOR sampler configuration, scheduled by wavefronts
    (:func:`natural_sweep`).  Same target N(A^{-1}b, A^{-1}) and same
    ``b~ = b + sqrt((2-w)/w) sqrt(D) eta`` stochastic RHS as
    ``GibbsSampler``; only the update order differs.  Registry type:
    ``{"type": "gibbs", "ordering": "natural"}``."""

    base: StencilOperator
    noise_scale: jax.Array
    omega: float = 1.0
    sweep: str = "forward"

    @staticmethod
    def create(op, omega: float = 1.0, sweep: str = "forward"):
        assert isinstance(op, StencilOperator)
        scale = jnp.sqrt((2.0 - omega) / omega) * jnp.sqrt(op.diag)
        return NaturalGibbsSampler(
            base=op, noise_scale=scale, omega=omega, sweep=sweep
        )

    @property
    def grid_shape(self):
        return self.base.grid_shape

    @property
    def dtype(self):
        return self.base.dtype

    def noise_shapes(self):
        halves = 2 if self.sweep == "symmetric" else 1
        return [{"eta": self.base.grid_shape} for _ in range(halves)]

    def step_with_noise(self, x, b, noises):
        if b is None:  # zero-RHS (prior) convention
            b = jnp.zeros_like(x)
        if self.sweep == "symmetric":  # fresh noise per half-sweep
            x = natural_sweep(
                self.base,
                b + self.noise_scale * noises[0]["eta"],
                x,
                self.omega,
                "forward",
            )
            return natural_sweep(
                self.base,
                b + self.noise_scale * noises[1]["eta"],
                x,
                self.omega,
                "backward",
            )
        btilde = b + self.noise_scale * noises[0]["eta"]
        return natural_sweep(self.base, btilde, x, self.omega, self.sweep)

    def prepare(self, b):
        return None

    def step(self, key, x, b, aux=None):
        from parmgmc_tpu.samplers.gibbs import _draw

        key, sub = jax.random.split(key)
        noises = _draw(sub, self.noise_shapes(), x.dtype)
        return key, self.step_with_noise(x, b, noises)


def lexicographic_sweep(op, b, x, omega: float = 1.0, sweep: str = "forward"):
    """Sequential-scan natural-order Gauss-Seidel/SOR sweep (test oracle).

    O(n^2) dense scan used to VERIFY ``natural_sweep``'s wavefront
    scheduling bit-for-bit on small problems (iteration-operator
    comparisons, ex5-style identities).  Production natural-order
    sweeps use :func:`natural_sweep`.
    """
    A = op.to_dense()
    n = A.shape[0]
    d = jnp.diagonal(A)
    xf = x.reshape(n)
    bf = b.reshape(n)
    order = jnp.arange(n) if sweep == "forward" else jnp.arange(n - 1, -1, -1)
    if sweep == "symmetric":
        xf = lexicographic_sweep(op, b, x, omega, "forward").reshape(n)
        return lexicographic_sweep(
            op, bf.reshape(x.shape), xf.reshape(x.shape), omega, "backward"
        )

    def body(xv, i):
        s = A[i] @ xv - d[i] * xv[i]
        xi = (1.0 - omega) * xv[i] + (omega / d[i]) * (bf[i] - s)
        return xv.at[i].set(xi), None

    xf, _ = jax.lax.scan(body, xf, order)
    return xf.reshape(x.shape)
