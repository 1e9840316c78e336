"""ex13 analogue: weak-scaling benchmark over a device mesh.

Reference: /root/reference/examples/ex13.py — wrench-mesh weak scaling
(refinements grow with MPI ranks in {1,8,64,512}), printing DOFs, wall
time per sample, IACT and time per independent sample.

Here the scaling axis is devices over a ``jax.sharding.Mesh``: the
3D GMRF grows with the device count while the per-device block stays
fixed, the same chain code runs sharded (GSPMD inserts the halo
collectives), and we report the same metrics.  On a CPU host this runs
on virtual devices (functional, not a performance measurement):

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/ex13_weak_scaling.py --devices 1 2 4 8 --base 32
"""

import argparse
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import time

import jax
import jax.numpy as jnp
import numpy as np

from parmgmc_tpu.chain import ChainState, sample_chain
from parmgmc_tpu.diagnostics.iact import iact
from parmgmc_tpu.models.problems import gmrf_3d
from parmgmc_tpu.operators.stencil import shifted_laplace_fd
from parmgmc_tpu.parallel.mesh import make_mesh, shard_sampler
from parmgmc_tpu.samplers.mgmc import MGMCSampler


def run_config(n_dev: int, base: int, n_samples: int, kappa: float):
    shape = (base * n_dev, base, base)
    op = shifted_laplace_fd(shape, kappa, dtype=jnp.float32)
    smp = MGMCSampler.create(op, n_pre=1, n_post=1, coarsest_size=128)
    b = jnp.zeros(shape, jnp.float32)
    qoi = lambda x: jnp.mean(x)

    if n_dev > 1:
        mesh = make_mesh((n_dev,), axis_names=("x",))
        smp, xsh = shard_sampler(smp, mesh, min_local=4, grid_axes=("x", None, None))
        b = jax.device_put(b, xsh)
        x0 = jax.device_put(jnp.zeros(shape, jnp.float32), xsh)
    else:
        x0 = jnp.zeros(shape, jnp.float32)

    run = jax.jit(
        lambda smp, s, bb: sample_chain(smp, s, bb, n_samples, extract=qoi)
    )
    st = ChainState(x=x0, key=jax.random.PRNGKey(0))
    st, q = run(smp, st, b)
    jax.block_until_ready(st.x)
    t0 = time.perf_counter()
    st, q = run(smp, st, b)
    q = np.asarray(q)
    wall = time.perf_counter() - t0

    tau, valid = iact(q)
    tau = max(float(tau), 1.0)
    tps = wall / n_samples * 1000
    print(
        f"devices={n_dev:3d} dofs={np.prod(shape):>12,} "
        f"time/sample={tps:8.2f} ms  IACT={tau:5.2f}{'' if valid else '*'} "
        f"time/indep-sample={tau * tps:8.2f} ms"
    )


def run_mesh_config(n_dev: int, n_refine: int, n_samples: int, kappa: float):
    """Unstructured weak scaling: ranks -> devices via CHAIN parallelism.

    The reference's wrench ex13 grows the mesh with ranks under domain
    decomposition; graph sweeps are gather-bound, so the data-parallel
    scaling axis for meshes is independent chains (SURVEY §2.3 item 4 —
    the reference runs chains serially).  One chain per device; reported
    throughput is TOTAL ESS/sec across chains.
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    from parmgmc_tpu.models.mesh import (
        matern_precision_mesh,
        refine,
        unit_square_mesh,
    )
    from parmgmc_tpu.operators.graph import from_csr

    pts, cells = unit_square_mesh(9)
    for _ in range(n_refine):
        pts, cells = refine(pts, cells)
    A = matern_precision_mesh(pts, cells, kappa)
    op = from_csr(A, dtype=jnp.float32)
    smp = MGMCSampler.create(op, coarsest_size=64)
    b = jnp.zeros((op.n,), jnp.float32)
    keys = jax.random.split(jax.random.PRNGKey(0), n_dev)
    x0 = jnp.zeros((n_dev, op.n), jnp.float32)
    if n_dev > 1:
        mesh = make_mesh((n_dev,), axis_names=("chain",))
        csh = NamedSharding(mesh, P("chain"))
        keys = jax.device_put(keys, csh)
        x0 = jax.device_put(x0, csh)

    qoi = lambda x: jnp.mean(x)
    run = jax.jit(
        jax.vmap(
            lambda s, st, bb: sample_chain(s, st, bb, n_samples, extract=qoi),
            in_axes=(None, 0, None),
        )
    )
    sts = jax.vmap(lambda k, x: ChainState(x=x, key=k))(keys, x0)
    sts, q = run(smp, sts, b)
    jax.block_until_ready(sts.x)
    t0 = time.perf_counter()
    sts, q = run(smp, sts, b)
    q = np.asarray(q)
    wall = time.perf_counter() - t0
    tau, valid = iact(q[0])
    tau = max(float(tau), 1.0)
    tps = wall / n_samples * 1000
    total_ess = n_dev / (tau * wall / n_samples)
    print(
        f"devices={n_dev:3d} chains={n_dev} dofs={op.n:>9,} "
        f"time/sample={tps:8.2f} ms  IACT={tau:5.2f}{'' if valid else '*'} "
        f"total ESS/sec={total_ess:8.1f}"
    )


def run_mesh_dd_config(
    n_dev: int,
    n_refine: int,
    n_samples: int,
    kappa: float,
    posterior: bool = False,
    mesh_file: str = "wrench",
):
    """Unstructured weak scaling under DOMAIN DECOMPOSITION on the 3D
    wrench (round 5): the mesh GROWS with the device count (one
    refinement per 8x devices — 3D refinement multiplies nodes ~8x, so
    nodes/device stays ~constant, the reference's ex13 semantics on the
    same geometry, ``/root/reference/examples/ex13.py:80-87``) and the
    row-partitioned sharded MGMC of parallel/graph_sharded.py samples
    it: level 0 sharded with per-colour NEIGHBOR-WISE ghost exchange
    (ppermute; ``mc_sor.c:152-214``), coarse levels replicated.

    ``--posterior`` attaches ball-average observations and samples the
    LRC posterior under the same decomposition — the reference's MATLRC
    weak-scaling configuration (``ex13.py:128-185``)."""
    from parmgmc_tpu.models.matern import MaternMeshSampler
    from parmgmc_tpu.models.mesh import mesh_path, read_gmsh
    from parmgmc_tpu.parallel.graph_sharded import (
        make_sharded_graph_mgmc_step,
        to_local,
    )

    extra = max(0, round(math.log(max(n_dev, 1), 8)))
    obs = None
    if posterior:
        pts0, _ = read_gmsh(mesh_path(mesh_file))
        lo, hi = pts0.min(0), pts0.max(0)
        rel = np.array([[0.25, 0.5, 0.5], [0.5, 0.5, 0.5], [0.75, 0.5, 0.5]])
        coords = lo + rel * (hi - lo)
        radii = np.full(3, 0.12 * float(np.linalg.norm(hi - lo)))
        obs = dict(
            sigma2=0.1, coords=coords, radii=radii, values=[1.0, -1.0, 2.0]
        )
    ms = MaternMeshSampler(
        mesh_file=mesh_file,
        kappa=kappa,
        refinements=n_refine + extra,
        dtype=jnp.float32,
        observations=obs,
        coarsest_size=64,
    )
    op = ms.op
    smp = ms.sampler
    mesh = make_mesh((n_dev,), axis_names=("x",))
    step, spec, sharding = make_sharded_graph_mgmc_step(
        smp, mesh, coords=ms.dof_points
    )
    bl = jax.device_put(to_local(spec, ms.b), sharding)
    x0 = jax.device_put(
        jnp.zeros((spec.n_shards, spec.n_local), jnp.float32), sharding
    )
    mask = spec.own_mask / jnp.sum(spec.own_mask)

    def body(carry, _):
        key, x = carry
        key, x = step(key, x, bl)
        return (key, x), jnp.sum(x * mask)  # global mean QOI

    run = jax.jit(
        lambda key, x: jax.lax.scan(body, (key, x), None, length=n_samples)
    )
    (key, x), q = run(jax.random.PRNGKey(0), x0)
    jax.block_until_ready(x)
    t0 = time.perf_counter()
    (key, x), q = run(key, x)
    q = np.asarray(q)
    wall = time.perf_counter() - t0
    tau, valid = iact(q)
    tau = max(float(tau), 1.0)
    tps = wall / n_samples * 1000
    # ghost traffic: O(neighbors) received rows vs the O(S) all_gather
    ghosts = spec.ghost_rows_received
    print(
        f"devices={n_dev:3d} ({'posterior ' if posterior else ''}"
        f"domain-decomposed {mesh_file}) dofs={op.n:>9,} "
        f"local={spec.n_local:>7,} "
        f"ghost-rows/exchange={ghosts:>6,} "
        f"(allgather would be {spec.n_shards * spec.bmax:>6,}; "
        f"shifts={list(spec.nbr_shifts)}) "
        f"time/sample={tps:8.2f} ms  IACT={tau:5.2f}{'' if valid else '*'} "
        f"ESS/sec={1000.0 / (tau * tps):8.1f}"
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--base", type=int, default=32, help="per-device block edge")
    ap.add_argument("--samples", type=int, default=64)
    ap.add_argument("--kappa", type=float, default=1.0)
    ap.add_argument(
        "--unstructured",
        action="store_true",
        help="mesh problem, chains-over-devices scaling (wrench-style)",
    )
    ap.add_argument("--refine", type=int, default=1, help="mesh refinements")
    ap.add_argument(
        "--domain-decompose",
        action="store_true",
        help="unstructured weak scaling via row-partitioned sharded "
        "MGMC (mesh grows with devices) instead of chain parallelism",
    )
    ap.add_argument(
        "--posterior",
        action="store_true",
        help="with --domain-decompose: sample the LRC posterior "
        "(ball observations) under the decomposition (ex13.py:128-185)",
    )
    ap.add_argument(
        "--mesh", default="wrench", help="mesh asset for --domain-decompose"
    )
    args = ap.parse_args()
    avail = len(jax.devices())
    for nd in args.devices:
        if nd > avail:
            print(f"devices={nd}: skipped (only {avail} available)")
            continue
        if args.unstructured and args.domain_decompose:
            run_mesh_dd_config(
                nd, args.refine, args.samples, args.kappa,
                posterior=args.posterior, mesh_file=args.mesh,
            )
        elif args.unstructured:
            run_mesh_config(nd, args.refine, args.samples, args.kappa)
        else:
            run_config(nd, args.base, args.samples, args.kappa)


if __name__ == "__main__":
    from parmgmc_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()
