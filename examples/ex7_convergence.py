"""ex7 analogue: overdispersed chains until R-hat converges.

Reference: /root/reference/examples/ex7.c — 8 chains with inits scaled
by 1e6, Gelman-Rubin R-hat of a scalar QOI recomputed every 50 samples
until it drops below 1.05.  Chains here run vmapped on device instead
of serially, and the convergence statistic is selectable: the
reference's moment R-hat (``--method classic``) or the rank-normalized
split-R-hat with folding of Vehtari et al. 2021 (``--method rank``,
``diagnostics/rhat.py``).  Also reports bulk/tail ESS of the trace.

    python examples/ex7_convergence.py [--grid 9] [--chains 8]
        [--method rank|classic]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from parmgmc_tpu.diagnostics.rhat import ess_bulk, ess_tail, rhat_rank
from parmgmc_tpu.diagnostics.stats import sample_until_converged
from parmgmc_tpu.operators.stencil import shifted_laplace_fd
from parmgmc_tpu.samplers.mgmc import MGMCSampler


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--grid", type=int, default=9)
    ap.add_argument("--kappa", type=float, default=1.0)
    ap.add_argument("--chains", type=int, default=8)
    ap.add_argument("--method", default="rank", choices=("classic", "rank"))
    ap.add_argument("--check-every", type=int, default=50)
    ap.add_argument("--tol", type=float, default=1.05)
    ap.add_argument("--max-steps", type=int, default=100_000)
    args = ap.parse_args()

    op = shifted_laplace_fd((args.grid, args.grid), args.kappa, dtype=jnp.float32)
    smp = MGMCSampler.create(op, n_levels=2)
    b = jnp.ones(op.grid_shape, jnp.float32)

    trace, steps, rhat = sample_until_converged(
        smp,
        b,
        lambda x: jnp.mean(x),
        n_chains=args.chains,
        check_every=args.check_every,
        rhat_tol=args.tol,
        max_steps=args.max_steps,
        method=args.method,
    )
    print(
        f"converged after {steps} steps/chain: "
        f"{args.method} R-hat = {rhat:.4f} (tol {args.tol})"
    )
    print(
        f"rank diagnostics on the trace: rhat_rank = {rhat_rank(trace):.4f}, "
        f"ess_bulk = {ess_bulk(trace):.0f}, ess_tail = {ess_tail(trace):.0f} "
        f"of {trace.size} draws"
    )
    assert rhat < args.tol


if __name__ == "__main__":
    from parmgmc_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()
