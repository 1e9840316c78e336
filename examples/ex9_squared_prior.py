"""ex9 analogue: squared-operator prior with star-patch smoothers.

Reference: /root/reference/examples/ex9.py — geometric MGMC on the
C0-IP discretisation of (kappa^2 - Lap)^2 with ASMStarPC patch smoothers
whose sub-sub-PC is a Cholesky sampler.  Here: the FD (kappa^2 - Lap)^2
radius-2 stencil, MGMC with vertex-star block-Gibbs smoothers (batched
per-patch Cholesky), sample-mean acceptance vs a direct solve.

    python examples/ex9_squared_prior.py [--grid 17] [--samples 30000]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from parmgmc_tpu.chain import init_chain, sample_moments
from parmgmc_tpu.models.problems import squared_shifted_laplace_fd
from parmgmc_tpu.samplers.registry import build_sampler


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--grid", type=int, default=17)
    ap.add_argument("--samples", type=int, default=30_000)
    ap.add_argument("--kappa", type=float, default=2.0)
    args = ap.parse_args()

    op = squared_shifted_laplace_fd(
        (args.grid, args.grid), args.kappa, dtype=jnp.float64
    )
    sampler = build_sampler(
        op,
        {
            "type": "mgmc",
            "n_levels": 3,
            "smoother": {"type": "patch_gibbs"},
            "n_pre": 1,
            "n_post": 1,
        },
    )
    b = jnp.ones(op.grid_shape, op.dtype)
    mu = np.linalg.solve(np.asarray(op.to_dense()), np.ones(op.n)).reshape(
        op.grid_shape
    )
    st = init_chain(sampler, jax.random.PRNGKey(0))
    run = jax.jit(
        lambda smp, s: sample_moments(smp, s, b, args.samples, burnin=300)
    )
    _, mean, _ = run(sampler, st)
    rel = np.linalg.norm(np.asarray(mean) - mu) / np.linalg.norm(mu)
    print(f"(kappa^2-Lap)^2 prior, patch-smoothed MGMC: rel mean err {rel:.4f}")
    assert rel < 0.05


if __name__ == "__main__":
    from parmgmc_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()
