"""ex4 analogue: Bayesian posterior sampling with low-rank updates.

Reference: /root/reference/examples/ex4.c — every sampler family on
A + B Sigma^{-1} B^T posteriors with ball observations; posterior-mean
error vs a direct solve under per-config tolerances.

    python examples/ex4_posterior.py [--sampler gibbs|mgmc|woodbury]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from parmgmc_tpu.chain import init_chain, sample_moments
from parmgmc_tpu.models.obs import make_posterior_operator
from parmgmc_tpu.models.problems import gmrf_2d
from parmgmc_tpu.samplers.registry import build_sampler

CONFIGS = {
    "gibbs": {"type": "gibbs", "omega": 1.0},
    "mgmc": {"type": "mgmc", "n_pre": 1, "n_post": 1, "coarsest_size": 32},
    "woodbury": {"type": "woodbury", "sampler": {"type": "cholesky"}},
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sampler", default="mgmc", choices=sorted(CONFIGS))
    ap.add_argument("--samples", type=int, default=50_000)
    ap.add_argument("--tol", type=float, default=0.05)
    args = ap.parse_args()

    base = gmrf_2d(17, kappa=2.0, dtype=jnp.float64)
    op, f = make_posterior_operator(
        base,
        sigma2=1e-2,
        coords=[[0.25, 0.25], [0.75, 0.75], [0.5, 0.3]],
        radii=[0.12, 0.1, 0.15],
        obsvals=[0.8, -0.5, 0.3],
    )
    sampler = build_sampler(op, dict(CONFIGS[args.sampler]))

    mu = np.linalg.solve(np.asarray(op.to_dense()), np.asarray(f).ravel()).reshape(
        op.grid_shape
    )
    st = init_chain(sampler, jax.random.PRNGKey(1))
    run = jax.jit(
        lambda smp, s: sample_moments(smp, s, f, args.samples, burnin=500)
    )
    _, mean, _ = run(sampler, st)
    rel = np.linalg.norm(np.asarray(mean) - mu) / np.linalg.norm(mu)
    print(f"sampler={args.sampler}: rel posterior mean error {rel:.4f}")
    assert rel < args.tol


if __name__ == "__main__":
    from parmgmc_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()
