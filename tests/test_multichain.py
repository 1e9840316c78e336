"""Chain-major multichain layout: x of shape (n, C) advances C
independent chains through ONE keyed step, with every ELL gather
amortized over the trailing chain axis.

Correctness contract tested here:
  * batched ops/sweeps == per-column unbatched (bitwise for the pure
    gather/elementwise paths; f64-epsilon for paths through dense
    coarse matmuls, whose reduction order legitimately differs),
  * the >= 3-level aggregation hierarchy keeps EXACT Galerkin
    (regression for the round-4 ordering bug: deeper levels continued
    in the unpermuted coarse ordering, silently breaking P^T A P and
    the MGMC invariance oracle),
  * the MaternMeshSampler.sample_chains driver routes mesh samplers
    through the batched layout and produces independent chains.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from parmgmc_tpu.models.mesh import matern_precision_mesh, unit_square_mesh
from parmgmc_tpu.operators.graph import from_csr
from parmgmc_tpu.operators.lrc import LRCOperator
from parmgmc_tpu.samplers.gibbs import GibbsSampler, _draw
from parmgmc_tpu.samplers.mgmc import MGMCSampler, build_hierarchy
from parmgmc_tpu.testing import invariance_error

C = 5


@pytest.fixture(scope="module")
def mesh_op():
    pts, cells = unit_square_mesh(12)  # 169 nodes -> 3 aggregation levels
    A = matern_precision_mesh(pts, cells, 7.0)
    return from_csr(A, dtype=jnp.float64), A


def _col(tree, j):
    return jax.tree_util.tree_map(
        lambda a: a[..., j], tree, is_leaf=lambda l: isinstance(l, jax.Array)
    )


def test_graph_op_batched_matches_per_column(mesh_op):
    op, _ = mesh_op
    rng = np.random.default_rng(0)
    X = jnp.asarray(rng.standard_normal((op.n, C)))
    B = jnp.asarray(rng.standard_normal((op.n, C)))
    Y = op.sor_sweep(B, X, 1.3, "symmetric")
    AX = op.apply(X)
    for j in range(C):
        yj = op.sor_sweep(B[:, j], X[:, j], 1.3, "symmetric")
        assert float(jnp.abs(Y[:, j] - yj).max()) == 0.0
        assert float(jnp.abs(AX[:, j] - op.apply(X[:, j])).max()) == 0.0


def test_graph_op_batched_b_broadcast(mesh_op):
    """An unbatched b against batched x broadcasts per column."""
    op, _ = mesh_op
    rng = np.random.default_rng(1)
    X = jnp.asarray(rng.standard_normal((op.n, C)))
    b = jnp.asarray(rng.standard_normal(op.n))
    Y = op.sor_sweep(b, X, 1.0, "forward")
    for j in range(C):
        yj = op.sor_sweep(b, X[:, j], 1.0, "forward")
        assert float(jnp.abs(Y[:, j] - yj).max()) == 0.0


def test_gibbs_batched_step_with_noise(mesh_op):
    op, _ = mesh_op
    smp = GibbsSampler.create(op, omega=1.1, sweep="symmetric")
    rng = np.random.default_rng(2)
    X = jnp.asarray(rng.standard_normal((op.n, C)))
    b = jnp.asarray(rng.standard_normal(op.n))
    noises = _draw(jax.random.PRNGKey(0), smp.noise_shapes(), jnp.float64, (C,))
    Y = smp.step_with_noise(X, b, noises)
    for j in range(C):
        yj = smp.step_with_noise(X[:, j], b, _col(noises, j))
        assert float(jnp.abs(Y[:, j] - yj).max()) == 0.0


def test_deep_aggregation_galerkin_exact(mesh_op):
    """Regression: levels >= 2 must keep P^T A P == A_c exactly (the
    pre-round-4 hierarchy silently broke this past the first level)."""
    op, _ = mesh_op
    ops, trs = build_hierarchy(op, coarsest_size=16)
    assert len(ops) >= 3
    for l, tr in enumerate(trs):
        Af = np.asarray(ops[l].to_dense())
        Ac = np.asarray(ops[l + 1].to_dense())
        nc = Ac.shape[0]
        P = np.stack(
            [
                np.asarray(tr.prolong(jnp.eye(nc)[:, j]))
                for j in range(nc)
            ],
            axis=1,
        )
        assert np.abs(P.T @ Af @ P - Ac).max() < 1e-12, l


def test_deep_mgmc_invariance(mesh_op):
    op, _ = mesh_op
    b = jnp.asarray(np.random.default_rng(3).standard_normal(op.n))
    smp = MGMCSampler.create(op, coarsest_size=16)
    assert smp.n_levels >= 3
    me, ce = invariance_error(smp, op, b)
    assert me < 1e-10 and ce < 1e-10, (me, ce)


def test_mgmc_batched_step_with_noise(mesh_op):
    op, _ = mesh_op
    smp = MGMCSampler.create(op, coarsest_size=16)
    rng = np.random.default_rng(4)
    X = jnp.asarray(rng.standard_normal((op.n, C)))
    b = jnp.asarray(rng.standard_normal(op.n))
    noises = _draw(jax.random.PRNGKey(1), smp.noise_shapes(), jnp.float64, (C,))
    Y = smp.step_with_noise(X, b, noises)
    worst = 0.0
    for j in range(C):
        yj = smp.step_with_noise(X[:, j], b, _col(noises, j))
        worst = max(worst, float(jnp.abs(Y[:, j] - yj).max()))
    # dense coarse matmul reduction order differs (n,n)@(n,C) vs @(n,)
    assert worst < 1e-13, worst


def test_mgmc_lrc_batched_step_with_noise(mesh_op):
    """Posterior (LRC over graph) batched parity."""
    op, _ = mesh_op
    rng = np.random.default_rng(5)
    k = 3
    Bcols = np.zeros((op.n, k))
    for j in range(k):
        idx = rng.integers(0, op.n, 6)
        Bcols[idx, j] = rng.standard_normal(6)
    lrc = LRCOperator(
        base=op,
        B=jnp.asarray(Bcols),
        sigma_inv=jnp.asarray(rng.uniform(1.0, 2.0, k)),
    )
    smp = MGMCSampler.create(lrc, coarsest_size=16)
    X = jnp.asarray(rng.standard_normal((op.n, C)))
    b = jnp.asarray(rng.standard_normal(op.n))
    noises = _draw(jax.random.PRNGKey(2), smp.noise_shapes(), jnp.float64, (C,))
    Y = smp.step_with_noise(X, b, noises)
    worst = 0.0
    for j in range(C):
        yj = smp.step_with_noise(X[:, j], b, _col(noises, j))
        worst = max(worst, float(jnp.abs(Y[:, j] - yj).max()))
    assert worst < 1e-12, worst


def test_prefix_path_matches_flat_on_large_mesh():
    """The per-k prefix gathers (enabled at n >= _PREFIX_MIN_ROWS) must
    agree with the flat-gather fallback to rounding."""
    import dataclasses

    pts, cells = unit_square_mesh(91)  # 8464 nodes >= 8192
    A = matern_precision_mesh(pts, cells, 20.0)
    op = from_csr(A, dtype=jnp.float64)
    assert op._use_prefix()
    flat = dataclasses.replace(op, color_counts=())
    rng = np.random.default_rng(6)
    X = jnp.asarray(rng.standard_normal((op.n, 3)))
    b = jnp.asarray(rng.standard_normal(op.n))
    d1 = float(jnp.abs(op.apply(X) - flat.apply(X)).max())
    d2 = float(
        jnp.abs(
            op.sor_sweep(b, X, 1.0, "forward")
            - flat.sor_sweep(b, X, 1.0, "forward")
        ).max()
    )
    assert d1 < 1e-11 and d2 < 1e-11, (d1, d2)


def test_mesh_sampler_multichain_driver():
    """MaternMeshSampler.sample_chains routes through the chain-major
    layout and returns per-chain traces with chain-independent stats."""
    from parmgmc_tpu.models.matern import (
        MaternMeshSampler,
        _batched_chains_supported,
    )

    pts, cells = unit_square_mesh(8)
    ms = MaternMeshSampler(
        points=pts, cells=cells, kappa=5.0, dtype=jnp.float64,
        coarsest_size=12,
    )
    assert _batched_chains_supported(ms.sampler)
    ms.set_qoi(lambda x: jnp.mean(x))
    q = np.asarray(ms.sample_chains(64, 7, burnin=16))
    assert q.shape == (7, 64)
    assert np.isfinite(q).all()
    # chains are distinct streams
    assert np.abs(q[0] - q[1]).max() > 0
    # continuation reuses the persistent state
    q2 = np.asarray(ms.sample_chains(8, 7))
    assert q2.shape == (7, 8)
