"""Multi-device sharding tests on the 8-device virtual CPU mesh.

The strongest check is *exactness*: the sharded jitted transition is the
same mathematical function as the single-device one, so with identical
explicit noise draws the outputs must agree to float reassociation
tolerance.  (The reference can only compare distributions across NP=1 vs
NP=4 because its parallel sweep changes the iteration operator; GSPMD
partitioning does not.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from parmgmc_tpu.chain import init_chain, sample_moments
from parmgmc_tpu.operators.stencil import shifted_laplace_fd
from parmgmc_tpu.samplers.gibbs import GibbsSampler, _draw
from parmgmc_tpu.samplers.mgmc import MGMCSampler
from parmgmc_tpu.parallel.mesh import make_mesh, shard_sampler

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)

GRID = (32, 32)
DTYPE = jnp.float64


def fixed_noises(sampler, seed=0):
    return _draw(jax.random.PRNGKey(seed), sampler.noise_shapes(), DTYPE)


@pytest.mark.parametrize("mesh_shape", [(8,), (4, 2)])
def test_sharded_gibbs_step_matches_single_device(mesh_shape):
    op = shifted_laplace_fd(GRID, 3.0, dtype=DTYPE)
    smp = GibbsSampler.create(op, omega=1.0, sweep="symmetric")
    b = jnp.ones(GRID, DTYPE)
    key = jax.random.PRNGKey(2)
    x = jax.random.normal(key, GRID, dtype=DTYPE)
    noises = fixed_noises(smp)

    ref = smp.step_with_noise(x, b, noises)

    mesh = make_mesh(mesh_shape)
    smp_sh, xsh = shard_sampler(smp, mesh)
    x_s = jax.device_put(x, xsh)
    b_s = jax.device_put(b, xsh)
    out = jax.jit(lambda s, xx, bb, nn: s.step_with_noise(xx, bb, nn))(
        smp_sh, x_s, b_s, noises
    )
    # executed on all 8 devices
    assert len(out.sharding.device_set) == 8
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-12)


def test_sharded_mgmc_step_matches_single_device():
    op = shifted_laplace_fd(GRID, 3.0, dtype=DTYPE)
    smp = MGMCSampler.create(op, n_levels=3)
    b = jnp.ones(GRID, DTYPE)
    x = jax.random.normal(jax.random.PRNGKey(4), GRID, dtype=DTYPE)
    noises = fixed_noises(smp)

    ref = smp.step_with_noise(x, b, noises)

    mesh = make_mesh((4, 2))
    smp_sh, xsh = shard_sampler(smp, mesh)
    out = jax.jit(lambda s, xx, bb, nn: s.step_with_noise(xx, bb, nn))(
        smp_sh, jax.device_put(x, xsh), jax.device_put(b, xsh), noises
    )
    assert len(out.sharding.device_set) == 8
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-11)


def test_sharded_chain_statistics():
    """Full sharded chain: same tolerances as the single-device ex1 test."""
    op = shifted_laplace_fd(GRID, 10.0, dtype=DTYPE)
    smp = MGMCSampler.create(op, n_levels=3)
    b = jnp.ones(GRID, DTYPE)
    A = np.asarray(op.to_dense())
    ex_mean = np.linalg.solve(A, np.ones(op.n)).reshape(GRID)

    mesh = make_mesh((4, 2))
    smp_sh, xsh = shard_sampler(smp, mesh)
    st = init_chain(smp_sh, jax.random.PRNGKey(1))
    st = st._replace(x=jax.device_put(st.x, xsh))
    b_s = jax.device_put(b, xsh)

    run = jax.jit(lambda s: sample_moments(smp_sh, s, b_s, 8_000, burnin=100))
    _, mean, _ = run(st)
    rel = np.linalg.norm(np.asarray(mean) - ex_mean) / np.linalg.norm(ex_mean)
    assert rel < 0.05, rel


def test_sharded_aggregation_mgmc_matches_single_device():
    """The flagship bench hierarchy (aggregation coarsening) must shard:
    block-sum transfers are reshape-based and GSPMD-safe."""
    op = shifted_laplace_fd(GRID, 3.0, dtype=DTYPE)
    smp = MGMCSampler.create(op, n_levels=3, coarsening="aggregate")
    b = jnp.ones(GRID, DTYPE)
    x = jax.random.normal(jax.random.PRNGKey(4), GRID, dtype=DTYPE)
    noises = fixed_noises(smp)
    ref = smp.step_with_noise(x, b, noises)

    mesh = make_mesh((4, 2))
    smp_sh, xsh = shard_sampler(smp, mesh)
    out = jax.jit(lambda s, xx, bb, nn: s.step_with_noise(xx, bb, nn))(
        smp_sh, jax.device_put(x, xsh), jax.device_put(b, xsh), noises
    )
    assert len(out.sharding.device_set) == 8
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-11)


def test_explicit_shard_map_sweep_exact_mode():
    """parallel.sharded exact mode == single-device multicolor sweep."""
    from parmgmc_tpu.parallel.sharded import sharded_gibbs_sweep
    from parmgmc_tpu.samplers.sor import sor_sweep
    from jax.sharding import PartitionSpec as P

    op = shifted_laplace_fd((32, 16), 3.0, dtype=DTYPE)
    cmap = dict(zip(op.offsets, op.coeffs))
    coeffs = jnp.stack(
        [cmap[o] for o in [(-1, 0), (1, 0), (0, -1), (0, 1)]]
    ).astype(DTYPE)
    key = jax.random.PRNGKey(0)
    x = jax.random.normal(key, op.grid_shape, DTYPE)
    b = jax.random.normal(jax.random.fold_in(key, 1), op.grid_shape, DTYPE)

    mesh = make_mesh((8,), axis_names=("x",))
    f = jax.jit(
        jax.shard_map(
            lambda xx, bb, dd: sharded_gibbs_sweep(
                xx, bb, dd, coeffs, 1.3, "x", sweep="forward", halo_mode="exact"
            ),
            mesh=mesh,
            in_specs=(P("x"), P("x"), P("x")),
            out_specs=P("x"),
        )
    )
    out = f(x, b, op.diag)
    ref = sor_sweep(op, b, x, 1.3, "forward")
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-12)


def test_hogwild_frozen_halo_chain_statistics():
    """The frozen-halo ("Hogwild" local-forward analogue,
    pc_sorgibbs.c:264-278) chain: statistically close to the target on a
    well-conditioned problem, like the reference's variant."""
    from parmgmc_tpu.parallel.sharded import make_sharded_gibbs_step

    op = shifted_laplace_fd((32, 16), 10.0, dtype=DTYPE)
    b = jnp.ones(op.grid_shape, DTYPE)
    mesh = make_mesh((8,), axis_names=("x",))
    step, sharding = make_sharded_gibbs_step(
        op, mesh, omega=1.0, halo_mode="frozen"
    )
    x = jax.device_put(jnp.zeros(op.grid_shape, DTYPE), sharding)
    bs = jax.device_put(b, sharding)

    def body(carry, i):
        key, x, mean = carry
        key, x = step(key, x, bs)
        mean = mean + (x - mean) / (i + 1.0)
        return (key, x, mean), None

    run = jax.jit(
        lambda: jax.lax.scan(
            body,
            (jax.random.PRNGKey(2), x, jnp.zeros_like(x)),
            jnp.arange(30_000, dtype=DTYPE),
        )
    )
    (key, xf, mean), _ = run()
    ex = np.linalg.solve(np.asarray(op.to_dense()), np.ones(op.n)).reshape(
        op.grid_shape
    )
    rel = np.linalg.norm(np.asarray(mean) - ex) / np.linalg.norm(ex)
    # Hogwild mode is intentionally approximate across shards; the bias on
    # a diagonally-dominant problem is small (matches the reference's use).
    assert rel < 0.05, rel


def test_mesh_chains_sharded_over_devices():
    """Unstructured (mesh/graph) problems scale over devices by CHAIN
    parallelism: vmapped chains with keys/states sharded over the
    device mesh must equal the unsharded vmap exactly.  This is the
    rebuild's wrench-weak-scaling story for meshes (reference ex13
    ranks -> devices; domain decomposition serves structured grids,
    chain data-parallelism serves graphs — SURVEY §2.3 item 4)."""
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from parmgmc_tpu.models.mesh import matern_precision_mesh, unit_square_mesh
    from parmgmc_tpu.operators.graph import from_csr
    from parmgmc_tpu.samplers.mgmc import MGMCSampler

    pts, cells = unit_square_mesh(9)
    A = matern_precision_mesh(pts, cells, 2.0)
    op = from_csr(A, dtype=jnp.float32)
    smp = MGMCSampler.create(op, coarsest_size=12)
    b = jnp.zeros((op.n,), jnp.float32)
    n_chains = 8
    keys = jax.random.split(jax.random.PRNGKey(3), n_chains)
    x0 = jnp.zeros((n_chains, op.n), jnp.float32)

    def chain_step(smp, key, x, bb):
        for _ in range(3):
            key, x = smp.step(key, x, bb)
        return key, x

    step = jax.jit(jax.vmap(chain_step, in_axes=(None, 0, 0, None)))
    k_ref, x_ref = step(smp, keys, x0, b)

    mesh = make_mesh((8,), axis_names=("chain",))
    csh = NamedSharding(mesh, P("chain"))
    keys_sh = jax.device_put(keys, csh)
    x0_sh = jax.device_put(x0, csh)
    k_sh, x_sh = step(smp, keys_sh, x0_sh, b)
    assert len(x_sh.sharding.device_set) == 8
    # sharding retiles the dense coarse solve — identical chains up to
    # f32 reduction-order rounding (measured 2.6e-7 relative)
    err = float(
        jnp.abs(x_ref - x_sh).max() / jnp.abs(x_ref).max()
    )
    assert err < 1e-5, err


def _lrc_3d(grid):
    from parmgmc_tpu.models.obs import make_observation_mats
    from parmgmc_tpu.operators.lrc import LRCOperator

    base = shifted_laplace_fd(grid, 2.0, dtype=DTYPE)
    B, sigma_inv, _ = make_observation_mats(
        grid, 0.1, np.array([[0.3, 0.4, 0.5], [0.7, 0.6, 0.4]]),
        np.full(2, 0.3), dtype=DTYPE,
    )
    return LRCOperator(base=base, B=B, sigma_inv=sigma_inv)


@pytest.mark.parametrize("target", ["prior", "posterior"])
@pytest.mark.parametrize(
    "mesh_shape,grid_axes",
    [
        ((8,), ("x", None, None)),
        ((4,), ("x", None, None)),
        ((4, 2), ("x", "y", None)),
        ((2, 2, 2), ("x", "y", "z")),
    ],
)
def test_sharded_3d_mgmc_matches_single_device(mesh_shape, grid_axes, target):
    """The lax sharded MGMC step (1D, 2D and 3D meshes, prior and
    posterior) equals the single-device step under the same noise."""
    from parmgmc_tpu.testing import sharded_step_error

    grid = (16, 8, 8)
    op = shifted_laplace_fd(grid, 2.0, dtype=DTYPE) if target == "prior" else _lrc_3d(grid)
    smp = MGMCSampler.create(op, n_levels=3, n_pre=1, n_post=1, coarsening="aggregate")
    x = jax.random.normal(jax.random.PRNGKey(6), grid, DTYPE)
    b = jnp.ones(grid, DTYPE)
    err, out = sharded_step_error(
        smp, make_mesh(mesh_shape), x, b, fixed_noises(smp, 3),
        min_local=2, grid_axes=grid_axes,
    )
    assert len(out.sharding.device_set) == int(np.prod(mesh_shape))
    assert err < 1e-12, err
