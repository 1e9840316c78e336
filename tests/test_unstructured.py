"""Unstructured-mesh path: FEM assembly, graph operators, algebraic MGMC.

Covers the reference's MS/DMPlex + GAMG capabilities (ms.c, pc_gamgmc.c
algebraic mode, ex2/ex13 flows) on the JAX stack: Gmsh parsing,
P1 assembly, colour-blocked ELL operators, smoothed-aggregation
hierarchies — with the same machine-precision invariance oracles as the
structured path.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from parmgmc_tpu.chain import init_chain, sample_moments
from parmgmc_tpu.models.mesh import (
    assemble_p1,
    matern_precision_mesh,
    mesh_observation_mats,
    read_gmsh,
    refine,
    unit_square_mesh,
)
from parmgmc_tpu.operators.graph import from_csr
from parmgmc_tpu.operators.lrc import LRCOperator
from parmgmc_tpu.samplers.gibbs import GibbsSampler
from parmgmc_tpu.samplers.mgmc import MGMCSampler
from parmgmc_tpu.testing import invariance_error

from parmgmc_tpu.models.mesh import mesh_path

WRENCH = mesh_path("wrench")  # repo-owned data/wrench.msh (reference fallback)
TOL = 1e-10


def small_mesh_op(n=6, kappa=2.0):
    pts, cells = unit_square_mesh(n)
    A = matern_precision_mesh(pts, cells, kappa)
    return from_csr(A, dtype=jnp.float64), A, pts, cells


def test_p1_assembly_identities():
    pts, cells = unit_square_mesh(5)
    K, M = assemble_p1(pts, cells)
    # grad of constants vanishes; total mass = area of unit square
    assert abs(K @ np.ones(K.shape[0])).max() < 1e-12
    assert abs(M.sum() - 1.0) < 1e-12
    # SPD-ness of kappa^2 M + K
    A = matern_precision_mesh(pts, cells, 1.0).toarray()
    assert np.linalg.eigvalsh(A).min() > 0


def test_graph_operator_matches_csr():
    op, A, _, _ = small_mesh_op()
    perm = np.asarray(op.perm)
    np.testing.assert_allclose(
        np.asarray(op.to_dense()), A.toarray()[perm][:, perm], atol=1e-14
    )
    x = np.random.default_rng(0).standard_normal(op.n)
    y = np.asarray(op.apply(jnp.asarray(x)))
    np.testing.assert_allclose(y, (A.toarray()[perm][:, perm]) @ x, atol=1e-12)


def test_coloring_is_valid():
    op, _, _, _ = small_mesh_op()
    cols = np.asarray(op.cols)
    vals = np.asarray(op.vals)
    for c in range(op.ncolors):
        s, e = op.color_starts[c], op.color_starts[c + 1]
        block_cols = cols[s:e]
        block_vals = vals[s:e]
        assert not ((block_cols >= s) & (block_cols < e) & (block_vals != 0)).any()


def test_gibbs_invariance_on_mesh():
    op, _, _, _ = small_mesh_op()
    b = jnp.asarray(np.random.default_rng(1).standard_normal(op.n))
    for sweep in ("forward", "symmetric"):
        smp = GibbsSampler.create(op, omega=1.1, sweep=sweep)
        me, ce = invariance_error(smp, op, b)
        assert me < TOL and ce < TOL, (sweep, me, ce)


def test_algebraic_mgmc_invariance():
    op, _, _, _ = small_mesh_op()
    b = jnp.asarray(np.random.default_rng(2).standard_normal(op.n))
    smp = MGMCSampler.create(op, coarsest_size=12)
    assert smp.n_levels >= 2
    me, ce = invariance_error(smp, op, b)
    assert me < TOL and ce < TOL, (me, ce)


def test_algebraic_mgmc_lrc_invariance():
    """Posterior MGMC on a mesh: LRC base + projected factors per level."""
    op, _, pts, cells = small_mesh_op()
    B, sigma_inv, f = mesh_observation_mats(
        pts, cells, 0.01, [[0.3, 0.3], [0.7, 0.6]], [0.25, 0.2], [1.0, -0.5]
    )
    lrc = LRCOperator(
        base=op,
        B=jnp.asarray(B)[op.perm],
        sigma_inv=jnp.asarray(sigma_inv),
    )
    b = jnp.asarray(f)[op.perm]
    smp = MGMCSampler.create(lrc, coarsest_size=12)
    me, ce = invariance_error(smp, lrc, b)
    assert me < TOL and ce < TOL, (me, ce)


def test_mesh_chain_statistics():
    """End-to-end: algebraic MGMC chain mean matches the dense solve."""
    op, A, _, _ = small_mesh_op(n=5, kappa=5.0)
    b = jnp.ones((op.n,), jnp.float64)
    perm = np.asarray(op.perm)
    mu = np.linalg.solve(A.toarray()[perm][:, perm], np.ones(op.n))
    smp = MGMCSampler.create(op, coarsest_size=10)
    st = init_chain(smp, jax.random.PRNGKey(3))
    _, mean, _ = jax.jit(
        lambda s: sample_moments(smp, s, b, 40_000, burnin=200)
    )(st)
    rel = np.linalg.norm(np.asarray(mean) - mu) / np.linalg.norm(mu)
    assert rel < 0.03, rel


def test_refine_preserves_volume():
    pts, cells = unit_square_mesh(3)
    for _ in range(2):
        pts, cells = refine(pts, cells)
    _, M = assemble_p1(pts, cells)
    assert abs(M.sum() - 1.0) < 1e-12


@pytest.mark.skipif(not os.path.exists(WRENCH), reason="reference mesh absent")
def test_wrench_mesh_end_to_end():
    """The ex13 flagship geometry: parse, refine, assemble, sample."""
    pts, cells = read_gmsh(WRENCH)
    assert pts.shape[1] == 3 and cells.shape[1] == 4
    pts, cells = refine(pts, cells)
    _, M = assemble_p1(pts, cells)
    assert M.sum() > 0
    A = matern_precision_mesh(pts, cells, kappa=6.0)
    op = from_csr(A, dtype=jnp.float64)
    smp = MGMCSampler.create(op, coarsest_size=64)
    assert smp.n_levels >= 2
    b = jnp.zeros((op.n,), jnp.float64)
    st = init_chain(smp, jax.random.PRNGKey(0))
    st, x = jax.jit(lambda k, x, bb: smp.step(k, x, bb))(st.key, st.x, b)
    assert bool(jnp.isfinite(x).all())


def test_native_graph_setup_matches_python():
    """The C++ setup kernels (coloring/aggregation/ELL) must be
    bit-identical to the Python fallbacks."""
    import scipy.sparse as sp

    from parmgmc_tpu import native

    if native.lib() is None:
        pytest.skip("no native toolchain")
    pts, cells = unit_square_mesh(8)
    A = matern_precision_mesh(pts, cells, 2.0)
    Ao = (A - sp.diags(A.diagonal())).tocsr()
    Ao.eliminate_zeros()
    n = A.shape[0]

    # coloring
    c_nat = native.greedy_coloring_native(Ao.indptr, Ao.indices, n)
    colors = np.full(n, -1, dtype=np.int32)
    for i in range(n):
        nb = Ao.indices[Ao.indptr[i] : Ao.indptr[i + 1]]
        used = set(colors[j] for j in nb if colors[j] >= 0)
        c = 0
        while c in used:
            c += 1
        colors[i] = c
    np.testing.assert_array_equal(c_nat, colors)

    # ELL pack
    w = int(np.diff(Ao.indptr).max())
    vals_n, cols_n = native.ell_pack_native(Ao.indptr, Ao.indices, Ao.data, n, w)
    vals_p = np.zeros((n, w))
    cols_p = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, w))
    for i in range(n):
        lo, hi = Ao.indptr[i], Ao.indptr[i + 1]
        k = hi - lo
        vals_p[i, :k] = Ao.data[lo:hi]
        cols_p[i, :k] = Ao.indices[lo:hi]
    np.testing.assert_array_equal(vals_n, vals_p)
    np.testing.assert_array_equal(cols_n, cols_p)

    # aggregation
    from parmgmc_tpu.operators.aggregation import _strength_graph

    S = _strength_graph(A, 0.02)
    agg_n, na_n = native.aggregate_native(S.indptr, S.indices, n)
    agg_p = np.full(n, -1, dtype=np.int64)
    n_agg = 0
    for i in range(n):
        if agg_p[i] >= 0:
            continue
        nb = S.indices[S.indptr[i] : S.indptr[i + 1]]
        if np.all(agg_p[nb] < 0):
            agg_p[i] = n_agg
            agg_p[nb] = n_agg
            n_agg += 1
    for i in range(n):
        if agg_p[i] >= 0:
            continue
        nb = S.indices[S.indptr[i] : S.indptr[i + 1]]
        hit = nb[agg_p[nb] >= 0]
        if hit.size:
            agg_p[i] = agg_p[hit[0]]
        else:
            agg_p[i] = n_agg
            n_agg += 1
    np.testing.assert_array_equal(agg_n, agg_p)
    assert na_n == n_agg


def test_algebraic_mgmc_patch_smoother_invariance():
    """MGMC on a mesh graph with the GRAPH patch-Gibbs smoother (ex9's
    ASMStarPC-in-MG configuration on unstructured meshes)."""
    from parmgmc_tpu.samplers.registry import build_sampler

    op, _, _, _ = small_mesh_op()
    b = jnp.asarray(np.random.default_rng(3).standard_normal(op.n))
    smp = build_sampler(
        op,
        {
            "type": "mgmc",
            "coarsest_size": 12,
            "smoother": {"type": "patch_gibbs"},
        },
    )
    assert type(smp.smoothers[0]).__name__ == "GraphPatchGibbsSampler"
    me, ce = invariance_error(smp, op, b)
    assert me < TOL and ce < TOL, (me, ce)


def test_geometric_mesh_hierarchy_invariance():
    """Geometric P1 Galerkin hierarchy (the reference's ex9/PCMG path):
    refine-with-transfer, exact P^T A P per level, MGMC invariance for
    prior AND posterior; the MaternMeshSampler hierarchy="geometric"
    entry builds the same thing end-to-end."""
    from parmgmc_tpu.models.matern import MaternMeshSampler
    from parmgmc_tpu.models.mesh import (
        geometric_mgmc_hierarchy,
        matern_precision_mesh,
        refine,
    )
    from parmgmc_tpu.samplers.cholesky import CholeskySampler
    from parmgmc_tpu.samplers.gibbs import GibbsSampler
    from parmgmc_tpu.samplers.mgmc import MGMCSampler

    pts, cells = unit_square_mesh(3)
    Ps = []
    for _ in range(2):
        pts, cells, P = refine(pts, cells, True)
        Ps.append(P)
    A = matern_precision_mesh(pts, cells, 2.0)
    op = from_csr(A, dtype=jnp.float64)

    ops, transfers = geometric_mgmc_hierarchy(op, Ps)
    assert len(ops) == 3 and ops[-1].n == 16  # coarsest = unrefined mesh
    rng = np.random.default_rng(5)
    smp = MGMCSampler(
        ops=tuple(ops),
        transfers=transfers,
        smoothers=tuple(GibbsSampler.create(o) for o in ops[:-1]),
        coarse=CholeskySampler.create(ops[-1]),
        n_pre=1,
        n_post=1,
        n_levels=len(ops),
    )
    b = jnp.asarray(rng.standard_normal(op.n))
    me, ce = invariance_error(smp, op, b)
    assert me < TOL and ce < TOL, (me, ce)

    # end-to-end entry, posterior (LRC) variant
    pts0, cells0 = unit_square_mesh(3)
    ms = MaternMeshSampler(
        points=pts0,
        cells=cells0,
        kappa=2.0,
        refinements=2,
        hierarchy="geometric",
        observations=dict(
            sigma2=0.1,
            coords=np.asarray([[0.3, 0.4], [0.7, 0.6]]),
            radii=np.asarray([0.15, 0.15]),
            values=np.asarray([1.0, -0.5]),
        ),
    )
    assert ms.sampler.n_levels == 3
    me, ce = invariance_error(ms.sampler, ms.operator, ms.b)
    assert me < 1e-9 and ce < 1e-9, (me, ce)


def test_p2_assembly_exactness():
    """CG2 assembly (ex13's space): machine-precision identities —
    constants in the kernel of K, exact total mass, and EXACT energy /
    L2 norm of a quadratic (P2 interpolates quadratics exactly and the
    monomial-formula integration has no quadrature error)."""
    from parmgmc_tpu.models.mesh import assemble_p2

    pts, cells = unit_square_mesh(6)
    K, M, dp = assemble_p2(pts, cells)
    n = dp.shape[0]
    assert abs(K @ np.ones(n)).max() < 1e-12
    assert abs(M.sum() - 1.0) < 1e-12
    u = dp[:, 0] ** 2 + dp[:, 0] * dp[:, 1]  # x^2 + xy
    assert abs(u @ (K @ u) - 3.0) < 1e-11  # int |grad u|^2 over [0,1]^2
    assert abs(u @ (M @ u) - 101.0 / 180.0) < 1e-12  # int u^2
    assert np.linalg.eigvalsh((4.0 * M + K).toarray()).min() > 0


def test_p2_matern_sampler_invariance():
    """CG2 Matérn prior + posterior via MaternMeshSampler(order=2):
    algebraic MGMC on the P2 operator, exactly invariant."""
    from parmgmc_tpu.models.matern import MaternMeshSampler

    pts, cells = unit_square_mesh(4)
    ms = MaternMeshSampler(
        points=pts,
        cells=cells,
        kappa=2.0,
        order=2,
        coarsest_size=16,
        observations=dict(
            sigma2=0.1,
            coords=np.asarray([[0.35, 0.45]]),
            radii=np.asarray([0.2]),
            values=np.asarray([1.0]),
        ),
    )
    assert ms.n == 25 + 56  # vertices + edges of the 4x4 triangulation
    me, ce = invariance_error(ms.sampler, ms.operator, ms.b)
    assert me < 1e-9 and ce < 1e-9, (me, ce)
