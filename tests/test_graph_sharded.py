"""Row-partitioned mesh SPMD (parallel/graph_sharded): the mc_sor
row-distribution + per-colour ghost-scatter capability, on device meshes.

Exactness contract: the sharded multicolour sweep applies the SAME
operator as the single-device sweep (colour-internal updates are
independent; ghosts refresh per colour), and the sharded MGMC cycle is
deterministically equal to the single-device ``step_with_noise``.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from parmgmc_tpu.models.mesh import (
    matern_precision_mesh,
    unit_square_mesh,
)
from parmgmc_tpu.operators.graph import from_csr
from parmgmc_tpu.parallel.graph_sharded import (
    make_sharded_graph_gibbs_step,
    make_sharded_graph_mgmc_step,
    partition_graph_operator,
    sharded_apply,
    sharded_sor_sweep,
    to_global,
    to_local,
)
from parmgmc_tpu.parallel.mesh import make_mesh
from parmgmc_tpu.samplers.mgmc import MGMCSampler

S = 8


@pytest.fixture(scope="module")
def mesh_problem():
    pts, cells = unit_square_mesh(12)  # 169 nodes, 3-level hierarchy
    A = matern_precision_mesh(pts, cells, 7.0)
    op = from_csr(A, dtype=jnp.float64)
    mesh = make_mesh((S,), axis_names=("x",))
    spec = partition_graph_operator(op, S, coords=pts)
    return op, mesh, spec, pts


def test_layout_roundtrip(mesh_problem):
    op, mesh, spec, _ = mesh_problem
    v = jnp.asarray(np.random.default_rng(0).standard_normal(op.n))
    vl = to_local(spec, v)
    back = to_global(spec, vl, op.n)
    assert float(jnp.abs(back - v).max()) == 0.0
    # every node owned exactly once
    assert float(jnp.sum(spec.own_mask)) == op.n


def test_sharded_apply_matches(mesh_problem):
    op, mesh, spec, _ = mesh_problem
    v = jnp.asarray(np.random.default_rng(1).standard_normal(op.n))
    vl = to_local(spec, v)
    pspec = P("x")
    f = jax.jit(
        jax.shard_map(
            lambda sp, x: sharded_apply(sp, x[0], "x")[None],
            mesh=mesh,
            in_specs=(jax.tree_util.tree_map(lambda _: pspec, spec), pspec),
            out_specs=pspec,
            check_vma=False,
        )
    )
    got = to_global(spec, f(spec, vl), op.n)
    want = op.apply(v)
    assert float(jnp.abs(got - want).max()) < 1e-12


def test_sharded_sweep_matches(mesh_problem):
    op, mesh, spec, _ = mesh_problem
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.standard_normal(op.n))
    b = jnp.asarray(rng.standard_normal(op.n))
    pspec = P("x")
    for sweep in ("forward", "backward", "symmetric"):
        f = jax.jit(
            jax.shard_map(
                lambda sp, bb, xx, sw=sweep: sharded_sor_sweep(
                    sp, bb[0], xx[0], 1.3, "x", sw
                )[None],
                mesh=mesh,
                in_specs=(
                    jax.tree_util.tree_map(lambda _: pspec, spec),
                    pspec,
                    pspec,
                ),
                out_specs=pspec,
                check_vma=False,
            )
        )
        got = to_global(spec, f(spec, to_local(spec, b), to_local(spec, x)), op.n)
        want = op.sor_sweep(b, x, 1.3, sweep)
        assert float(jnp.abs(got - want).max()) < 1e-12, sweep


def test_sharded_mgmc_deterministic_parity(mesh_problem):
    op, mesh, spec, pts = mesh_problem
    smp = MGMCSampler.create(op, coarsest_size=16)
    assert smp.n_levels >= 3
    step, spec2, sharding = make_sharded_graph_mgmc_step(
        smp, mesh, coords=pts, with_noise=False
    )
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal(op.n))
    b = jnp.asarray(rng.standard_normal(op.n))
    xl = jax.device_put(to_local(spec2, x), sharding)
    bl = jax.device_put(to_local(spec2, b), sharding)
    _, out = step(jax.random.PRNGKey(0), xl, bl)
    got = to_global(spec2, out, op.n)

    zeros = jax.tree_util.tree_map(
        lambda s: jnp.zeros(s, jnp.float64),
        smp.noise_shapes(),
        is_leaf=lambda l: isinstance(l, tuple),
    )
    want = smp.step_with_noise(x, b, zeros)
    err = float(jnp.abs(got - want).max())
    assert err < 1e-11, err


def test_sharded_gibbs_chain_statistics(mesh_problem):
    """Keyed sharded Gibbs chain: mean converges to A^{-1} b."""
    op, mesh, spec, pts = mesh_problem
    step, spec2, sharding = make_sharded_graph_gibbs_step(
        op, mesh, omega=1.0, sweep="forward", coords=pts
    )
    b = jnp.ones((op.n,), jnp.float64)
    bl = jax.device_put(to_local(spec2, b), sharding)
    x0 = jax.device_put(
        jnp.zeros((spec2.n_shards, spec2.n_local), jnp.float64), sharding
    )

    def body(carry, i):
        key, x, mean = carry
        key, x = step(key, x, bl)
        mean = mean + (x - mean) / (i + 1.0)
        return (key, x, mean), None

    run = jax.jit(
        lambda: jax.lax.scan(
            body,
            (jax.random.PRNGKey(5), x0, jnp.zeros_like(x0)),
            jnp.arange(20_000, dtype=jnp.float64),
        )
    )
    (key, xf, mean), _ = run()
    got = np.asarray(to_global(spec2, mean, op.n))
    ex = np.linalg.solve(np.asarray(op.to_dense()), np.ones(op.n))
    rel = np.linalg.norm(got - ex) / np.linalg.norm(ex)
    assert rel < 0.05, rel


def test_ghost_modes_agree(mesh_problem):
    """Neighbor-wise ppermute ghosts (default) apply the same operator
    as the legacy all_gather exchange AND the single device — and the
    received-ghost volume is O(neighbors), not O(S)."""
    op, mesh, spec, pts = mesh_problem
    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.standard_normal(op.n))
    b = jnp.asarray(rng.standard_normal(op.n))
    pspec = P("x")
    outs = {}
    for mode in ("neighbor", "allgather"):
        sp = partition_graph_operator(op, S, coords=pts, ghost_mode=mode)
        f = jax.jit(
            jax.shard_map(
                lambda sp_, bb, xx: sharded_sor_sweep(
                    sp_, bb[0], xx[0], 1.0, "x", "symmetric"
                )[None],
                mesh=mesh,
                in_specs=(
                    jax.tree_util.tree_map(lambda _: pspec, sp),
                    pspec,
                    pspec,
                ),
                out_specs=pspec,
                check_vma=False,
            )
        )
        outs[mode] = to_global(
            sp, f(sp, to_local(sp, b), to_local(sp, x)), op.n
        )
        if mode == "neighbor":
            # coordinate cut on a planar mesh: only near ring neighbors
            # talk (this 169-node mesh has ~21-node slabs, so +-2 shows
            # up; thicker slabs reduce to +-1) — never all S-1 offsets
            assert len(sp.nbr_shifts) <= 4, sp.nbr_shifts
            assert sp.ghost_rows_received < S * sp.bmax
    want = op.sor_sweep(b, x, 1.0, "symmetric")
    assert float(jnp.abs(outs["neighbor"] - want).max()) < 1e-12
    assert float(jnp.abs(outs["allgather"] - want).max()) < 1e-12


def _lrc_mesh_sampler(op, k=3, seed=11):
    """MGMC posterior sampler over a synthetic localized LRC on the mesh
    (internal ordering, like MaternMeshSampler's ball observations)."""
    from parmgmc_tpu.operators.lrc import LRCOperator
    from parmgmc_tpu.samplers.mgmc import MGMCSampler

    rng = np.random.default_rng(seed)
    B = np.zeros((op.n, k))
    for j in range(k):
        sup = rng.choice(op.n, size=7, replace=False)
        B[sup, j] = rng.standard_normal(7)
    lrc = LRCOperator(
        base=op,
        B=jnp.asarray(B),
        sigma_inv=jnp.asarray(rng.uniform(0.5, 2.0, k)),
    )
    return MGMCSampler.create(lrc, coarsest_size=16)


def test_sharded_mgmc_lrc_deterministic_parity(mesh_problem):
    """Posterior (LRC) MGMC under unstructured domain decomposition
    equals the single-device cycle exactly (zero noises) — the graph
    analogue of parallel/fused.py's sharded LRC (ex13.py:128-185)."""
    op, mesh, spec, pts = mesh_problem
    smp = _lrc_mesh_sampler(op)
    assert smp.n_levels >= 3
    step, spec2, sharding = make_sharded_graph_mgmc_step(
        smp, mesh, coords=pts, with_noise=False
    )
    rng = np.random.default_rng(4)
    x = jnp.asarray(rng.standard_normal(op.n))
    b = jnp.asarray(rng.standard_normal(op.n))
    xl = jax.device_put(to_local(spec2, x), sharding)
    bl = jax.device_put(to_local(spec2, b), sharding)
    _, out = step(jax.random.PRNGKey(0), xl, bl)
    got = to_global(spec2, out, op.n)

    zeros = jax.tree_util.tree_map(
        lambda s: jnp.zeros(s, jnp.float64),
        smp.noise_shapes(),
        is_leaf=lambda l: isinstance(l, tuple),
    )
    want = smp.step_with_noise(x, b, zeros)
    err = float(jnp.abs(got - want).max())
    assert err < 1e-11, err


def test_sharded_mgmc_lrc_statistics(mesh_problem):
    """Keyed sharded posterior chain targets N(A_post^{-1} b, A_post^{-1}):
    mean converges under the sharded LRC noise scheme (shared low-rank
    draws + per-shard field noise)."""
    op, mesh, spec, pts = mesh_problem
    smp = _lrc_mesh_sampler(op)
    step, spec2, sharding = make_sharded_graph_mgmc_step(
        smp, mesh, coords=pts, with_noise=True
    )
    b = jnp.ones((op.n,), jnp.float64)
    bl = jax.device_put(to_local(spec2, b), sharding)
    x0 = jax.device_put(
        jnp.zeros((spec2.n_shards, spec2.n_local), jnp.float64), sharding
    )

    def body(carry, i):
        key, x, mean = carry
        key, x = step(key, x, bl)
        mean = mean + (x - mean) / (i + 1.0)
        return (key, x, mean), None

    run = jax.jit(
        lambda: jax.lax.scan(
            body,
            (jax.random.PRNGKey(6), x0, jnp.zeros_like(x0)),
            jnp.arange(4_000, dtype=jnp.float64),
        )
    )
    (_, _, mean), _ = run()
    got = np.asarray(to_global(spec2, mean, op.n))
    from parmgmc_tpu.operators.lrc import LRCOperator

    lrc = smp.fine_op
    assert isinstance(lrc, LRCOperator)
    dense = np.asarray(lrc.to_dense())
    ex = np.linalg.solve(dense, np.ones(op.n))
    rel = np.linalg.norm(got - ex) / np.linalg.norm(ex)
    assert rel < 0.05, rel


def test_sharded_mgmc_multichain(mesh_problem):
    """Domain decomposition composes with the trailing chain axis."""
    op, mesh, spec, pts = mesh_problem
    smp = MGMCSampler.create(op, coarsest_size=16)
    C = 3
    step, spec2, sharding = make_sharded_graph_mgmc_step(
        smp, mesh, coords=pts, n_chains=C
    )
    x0 = jax.device_put(
        jnp.zeros((spec2.n_shards, spec2.n_local, C), jnp.float64), sharding
    )
    b = jnp.ones((op.n,), jnp.float64)
    bl = jax.device_put(to_local(spec2, b), sharding)
    key, out = step(jax.random.PRNGKey(9), x0, bl)
    assert out.shape == (spec2.n_shards, spec2.n_local, C)
    g = to_global(spec2, out, op.n)
    assert np.isfinite(np.asarray(g)).all()
    # chains are distinct
    assert float(jnp.abs(g[:, 0] - g[:, 1]).max()) > 0
