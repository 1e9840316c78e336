"""ex13's cholsampler baseline: standalone large-n exact sampling.

Reference: ``/root/reference/examples/ex13.py:29-30`` runs
``-pc_type cholsampler`` (sparse MKL Pardiso factorization,
pc_chols.c:17-27) standalone on the refined wrench mesh as the exact
baseline that MGMC is compared against.  This drives the JAX rebuild's
equivalent — :class:`SparseCholeskySampler` (host-side sparse LDL^T) —
on the same mesh at 100k+ DOFs and cross-validates MGMC posterior
moments against it.

    python examples/ex13_cholsampler.py --refine 4 --samples 64
    python examples/ex13_cholsampler.py --refine 3 --samples 256 --mgmc-samples 2000
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--mesh", default="wrench")
    p.add_argument("--refine", type=int, default=4)
    p.add_argument("--samples", type=int, default=64)
    p.add_argument("--kappa", type=float, default=1.0)
    p.add_argument("--nobs", type=int, default=4)
    p.add_argument(
        "--mgmc-samples", type=int, default=0,
        help="if > 0, run an MGMC chain and cross-validate probe "
        "means/variances against the exact sampler",
    )
    args = p.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from parmgmc_tpu.models.mesh import (
        matern_precision_mesh,
        mesh_observation_mats,
        read_gmsh,
        refine,
    )
    from parmgmc_tpu.operators.graph import from_csr
    from parmgmc_tpu.operators.lrc import LRCOperator
    from parmgmc_tpu.samplers.cholesky import SparseCholeskySampler

    from parmgmc_tpu.models.mesh import mesh_path

    pts, cells = read_gmsh(mesh_path(args.mesh))
    for _ in range(args.refine):
        pts, cells = refine(pts, cells)
    t0 = time.perf_counter()
    A = matern_precision_mesh(pts, cells, args.kappa)
    t_asm = time.perf_counter() - t0
    op = from_csr(A, dtype=jnp.float64)
    n = op.n
    print(f"mesh: {args.mesh} refine={args.refine}  n={n}  nnz={A.nnz}")
    print(f"assembly: {t_asm:.1f} s")

    # posterior: ball-average observations on the mesh (obs.c analogue)
    rng = np.random.default_rng(0)
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    centers = lo + (0.2 + 0.6 * rng.random((args.nobs, pts.shape[1]))) * (hi - lo)
    radius = 0.15 * float((hi - lo).max())
    B, sigma_inv, f = mesh_observation_mats(
        pts, cells, 0.05, centers, np.full(args.nobs, radius),
        obsvals=rng.standard_normal(args.nobs),
    )
    # internal (colour-blocked) ordering of the graph operator
    Bi = jnp.asarray(np.asarray(B)[np.asarray(op.perm)], jnp.float64)
    fi = jnp.asarray(np.asarray(f)[np.asarray(op.perm)], jnp.float64)
    lrc = LRCOperator(base=op, B=Bi, sigma_inv=jnp.asarray(sigma_inv, jnp.float64))

    t0 = time.perf_counter()
    smp = SparseCholeskySampler.create(lrc)
    t_fac = time.perf_counter() - t0
    print(f"sparse LDL^T factorization: {t_fac:.1f} s  "
          f"(nnz(L) = {smp._lu.L.nnz})")

    t0 = time.perf_counter()
    xs = smp.sample(7, args.samples, b=fi).reshape(args.samples, n)
    t_smp = (time.perf_counter() - t0) / args.samples
    print(f"{args.samples} exact posterior samples: {t_smp * 1e3:.1f} ms/sample "
          f"(i.i.d. -> {1.0 / t_smp:.1f} ESS/sec host-side)")

    mu = smp.mean(fi).reshape(-1)
    probes = [rng.standard_normal(n) / np.sqrt(n) for _ in range(3)]
    print("probe validation (g^T x): exact vs sample estimates")
    exact_done = True
    for i, g in enumerate(probes):
        proj = xs @ g
        # exact probe variance g^T A_post^{-1} g via the factor + Woodbury
        from scipy.linalg import cho_solve

        lr = smp._lrc
        Aig = smp._lu.solve(g)
        want = float(
            g @ Aig - (g @ lr["C"]) @ cho_solve((lr["M_cho"], True), lr["B"].T @ Aig)
        )
        got_m, got_v = float(proj.mean()), float(proj.var(ddof=1))
        z = abs(got_m - g @ mu) / np.sqrt(want / args.samples)
        dv = abs(got_v - want) / want
        print(f"  probe {i}: mean z={z:.2f}  var rel err={dv:.3f} "
              f"(MC SE ~{np.sqrt(2.0 / args.samples):.3f})")
        assert z < 5.0 and dv < 6 * np.sqrt(2.0 / args.samples)

    if args.mgmc_samples > 0:
        from parmgmc_tpu.chain import ChainState, sample_chain
        from parmgmc_tpu.samplers.mgmc import MGMCSampler

        t0 = time.perf_counter()
        mg = MGMCSampler.create(lrc, n_pre=1, n_post=1, coarsest_size=512)
        print(f"MGMC algebraic hierarchy: {time.perf_counter() - t0:.1f} s, "
              f"{mg.n_levels} levels")
        gmat = jnp.asarray(np.stack(probes, axis=1))  # (n, 3)
        extract = lambda x: x.reshape(-1) @ gmat
        run = jax.jit(
            lambda smp_, st, bb: sample_chain(
                smp_, st, bb, args.mgmc_samples, extract=extract, burnin=50
            )
        )
        st = ChainState(x=jnp.zeros((n,), jnp.float64), key=jax.random.PRNGKey(1))
        t0 = time.perf_counter()
        _, q = run(mg, st, fi)
        q = np.asarray(q)
        t_mg = (time.perf_counter() - t0) / args.mgmc_samples
        from parmgmc_tpu.diagnostics.iact import iact

        print(f"MGMC: {t_mg * 1e3:.1f} ms/cycle ({args.mgmc_samples} samples)")
        print("cross-validation MGMC vs exact cholsampler:")
        for i, g in enumerate(probes):
            tau, _ = iact(q[:, i])
            neff = args.mgmc_samples / max(tau, 1.0)
            m_mg, v_mg = float(q[:, i].mean()), float(q[:, i].var(ddof=1))
            proj = xs @ g
            want = float(proj.var(ddof=1))
            z = abs(m_mg - g @ mu) / np.sqrt(want / neff)
            dv = abs(v_mg - want) / want
            print(f"  probe {i}: tau={tau:.2f}  mean z={z:.2f}  "
                  f"var rel diff={dv:.3f}")
            assert z < 5.0, "MGMC mean disagrees with exact sampler"
        print("cross-validation OK")


if __name__ == "__main__":
    from parmgmc_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()
