"""ex1 analogue: sampler mean-convergence on a 2D shifted-Laplace GMRF.

Reference: /root/reference/examples/ex1.c — 9x9 DMDA grid, kappa=10,
every sampler family, relative sample-mean error vs a direct solve.

    python examples/ex1_samplers.py [--sampler gibbs|cholesky|mgmc]
                                    [--samples 100000] [--grid 9]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from parmgmc_tpu.chain import init_chain, sample_moments
from parmgmc_tpu.models.problems import gmrf_2d
from parmgmc_tpu.samplers.registry import build_sampler

CONFIGS = {
    "gibbs": {"type": "gibbs", "omega": 1.0, "sweep": "forward"},
    "gibbs-symmetric": {"type": "gibbs", "sweep": "symmetric"},
    "cholesky": {"type": "cholesky"},
    "mgmc": {"type": "mgmc", "n_pre": 1, "n_post": 1, "coarsest_size": 16},
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sampler", default="mgmc", choices=sorted(CONFIGS))
    ap.add_argument("--samples", type=int, default=100_000)
    ap.add_argument("--burnin", type=int, default=1_000)
    ap.add_argument("--grid", type=int, default=9)
    ap.add_argument("--kappa", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    op = gmrf_2d(args.grid, kappa=args.kappa, dtype=jnp.float64)
    b = jnp.ones(op.grid_shape, op.dtype)
    sampler = build_sampler(op, dict(CONFIGS[args.sampler]))

    ex_mean = np.linalg.solve(np.asarray(op.to_dense()), np.ones(op.n)).reshape(
        op.grid_shape
    )

    state = init_chain(sampler, jax.random.PRNGKey(args.seed))
    run = jax.jit(
        lambda smp, st: sample_moments(smp, st, b, args.samples, burnin=args.burnin)
    )
    _, mean, var = run(sampler, state)
    rel = np.linalg.norm(np.asarray(mean) - ex_mean) / np.linalg.norm(ex_mean)
    print(f"sampler={args.sampler} samples={args.samples}")
    print(f"Rel. mean error: {rel:.5f}")
    assert rel < 0.05, "sample mean has not converged"


if __name__ == "__main__":
    from parmgmc_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()
