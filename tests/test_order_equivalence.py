"""Ordering equivalence: lexicographic vs multicolour Gauss-Seidel.

The reference's PCPARSOR exists to keep the EXACT natural
(lexicographic) update order across ranks via an MPI dataflow pipeline
(/root/reference/src/pc_parsor.c:703-878).  This framework instead uses
colouring as the production ordering (SURVEY hard part #1).  These tests
supply the quantitative evidence that the reformulation changes only the
iteration operator, not the quality of the sampler:

* every ordering is an EXACTLY invariant sampler for N(A^{-1}b, A^{-1})
  (machine-precision fixed-point identities via jacfwd),
* the integrated autocorrelation time of the domain-mean QOI — computed
  EXACTLY from tau = 1 + 2 sum_k c'G^k Sigma c / c'Sigma c, no Monte
  Carlo noise — agrees across lexicographic, red/black (2-colour) and
  4-colour orderings to a small factor (numbers in docs/samplers.md).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from parmgmc_tpu.operators.stencil import shifted_laplace_fd
from parmgmc_tpu.samplers.sor import (
    color_masks,
    lexicographic_sweep,
    sor_sweep,
)
from parmgmc_tpu.testing import invariance_error, transition_matrices

GRID = (8, 8)
DTYPE = jnp.float64
KAPPA = 1.0  # hard problem: slow GS convergence amplifies order effects


class _OrderedGibbs:
    """Gibbs sampler with a pluggable deterministic sweep (affine in
    (x, b, eta) — transition_matrices applies)."""

    def __init__(self, op, sweep_fn, omega=1.0):
        self.op = op
        self.sweep_fn = sweep_fn
        self.omega = omega
        self.noise_scale = jnp.sqrt((2.0 - omega) / omega) * jnp.sqrt(op.diag)

    @property
    def grid_shape(self):
        return self.op.grid_shape

    def noise_shapes(self):
        return [{"eta": self.op.grid_shape}]

    def step_with_noise(self, x, b, noises):
        btilde = b + self.noise_scale * noises[0]["eta"]
        return self.sweep_fn(self.op, btilde, x, self.omega, "forward")


def _four_color_sweep(op, b, x, omega, sweep):
    masks = color_masks(op.grid_shape, 4, op)
    inv_diag = omega / op.diag
    order = range(4) if sweep == "forward" else reversed(range(4))
    for c in order:
        r = b - op.offdiag_apply(x)
        xc = (1.0 - omega) * x + inv_diag * r
        x = jnp.where(masks[c], xc, x)
    return x


def _exact_iact(G, Sigma, c, kmax=20000, tol=1e-14):
    """tau = 1 + 2 sum_{k>=1} c'G^k Sigma c / c'Sigma c (chain x'=Gx+...)."""
    G = np.asarray(G, np.float64)
    v = np.asarray(Sigma, np.float64) @ c
    denom = float(c @ v)
    tau = 1.0
    for _ in range(kmax):
        v = G @ v
        rho = float(c @ v) / denom
        tau += 2.0 * rho
        if abs(rho) < tol:
            break
    return tau


def _samplers(op):
    return {
        "lexicographic": _OrderedGibbs(op, lexicographic_sweep),
        "redblack": _OrderedGibbs(op, sor_sweep),
        "fourcolor": _OrderedGibbs(op, _four_color_sweep),
    }


@pytest.fixture(scope="module")
def problem():
    op = shifted_laplace_fd(GRID, KAPPA, dtype=DTYPE)
    b = jnp.ones(GRID, DTYPE)
    return op, b


def test_all_orderings_exactly_invariant(problem):
    """Any update order is an exact Gibbs sampler — the mathematical
    core of why dropping PARSOR's pipeline loses nothing in law."""
    op, b = problem
    for name, smp in _samplers(op).items():
        me, ce = invariance_error(smp, op, b)
        assert float(me) < 1e-10, (name, float(me))
        assert float(ce) < 1e-10, (name, float(ce))


def test_ordering_iact_gap_is_small(problem):
    """Exact IACT of the domain mean across orderings: colouring pays at
    most a small constant factor vs the natural order (and the spectral
    radii match closely)."""
    op, b = problem
    n = math.prod(GRID)
    A = np.asarray(op.to_dense(), np.float64)
    Sigma = np.linalg.inv(A)
    c = np.full((n,), 1.0 / n)

    taus, rhos = {}, {}
    for name, smp in _samplers(op).items():
        G, K, _ = transition_matrices(smp, b)
        taus[name] = _exact_iact(G, Sigma, c)
        rhos[name] = float(np.max(np.abs(np.linalg.eigvals(np.asarray(G)))))
    print("exact IACT:", taus)
    print("spectral radii:", rhos)

    for name in ("redblack", "fourcolor"):
        ratio = taus[name] / taus["lexicographic"]
        assert 0.4 < ratio < 2.0, (name, taus)
        assert abs(rhos[name] - rhos["lexicographic"]) < 0.1, (name, rhos)


def test_wavefront_equals_sequential_lexicographic():
    """natural_sweep (production wavefront scheduling) reproduces the
    sequential lexicographic scan EXACTLY — radius-1 and radius-2 star
    stencils, 2D and 3D, forward/backward/symmetric, omega != 1."""
    from parmgmc_tpu.models.problems import squared_shifted_laplace_fd
    from parmgmc_tpu.samplers.sor import natural_sweep

    ops = [
        shifted_laplace_fd((6, 5), 1.3, dtype=DTYPE),
        shifted_laplace_fd((4, 3, 5), 0.8, dtype=DTYPE),
        squared_shifted_laplace_fd((7, 6), 1.1, dtype=DTYPE),
    ]
    for op in ops:
        key = 0
        x0 = jnp.sin(jnp.arange(math.prod(op.grid_shape), dtype=DTYPE)).reshape(
            op.grid_shape
        )
        b = jnp.cos(x0)
        for sweep in ("forward", "backward", "symmetric"):
            a = natural_sweep(op, b, x0, 1.35, sweep)
            c = lexicographic_sweep(op, b, x0, 1.35, sweep)
            err = float(jnp.max(jnp.abs(a - c)))
            assert err < 1e-13, (op.grid_shape, sweep, err)


def test_natural_gibbs_sampler_invariance():
    """The PCPARSOR sampler configuration (exact natural-order Gibbs)
    as a production sampler: exactly invariant, registry-buildable."""
    from parmgmc_tpu.samplers.registry import build_sampler

    op = shifted_laplace_fd(GRID, KAPPA, dtype=DTYPE)
    b = jnp.ones(GRID, DTYPE)
    for sweep in ("forward", "symmetric"):
        smp = build_sampler(
            op, {"type": "gibbs", "ordering": "natural", "sweep": sweep}
        )
        me, ce = invariance_error(smp, op, b)
        assert float(me) < 1e-10 and float(ce) < 1e-10, (sweep, me, ce)
