"""Cross-chain statistics: covariance-error trajectories and Gelman-Rubin.

JAX rebuild of ``/root/reference/src/stats.c`` (sample-covariance
Frobenius error vs the exact covariance A^{-1}) and the Gelman-Rubin
R-hat of ``examples/ex7.c:61-91``.  Where the reference loops over Vec
arrays per sample index, we batch everything: samples arrive as a single
(chains, steps, n) array and the whole trajectory is one einsum-heavy
jitted computation.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = [
    "sample_covariance",
    "covariance_error_trajectory",
    "gelman_rubin",
]


def sample_covariance(samples: jax.Array) -> jax.Array:
    """Unbiased sample covariance over the leading axis: (m, n) -> (n, n)."""
    m = samples.shape[0]
    mean = jnp.mean(samples, axis=0)
    d = samples - mean
    return d.T @ d / (m - 1)


def covariance_error_trajectory(samples: jax.Array, A_dense: jax.Array) -> jax.Array:
    """Relative Frobenius error of the cross-chain sample covariance at each
    sample index (stats.c:94-117 / ex6 semantics).

    samples: (chains, steps, n) — sample j of every chain estimates one
    covariance; errs[j] = ||Cov_hat_j - A^{-1}||_F / ||A^{-1}||_F.
    """
    n = A_dense.shape[0]
    Q = jnp.linalg.solve(A_dense, jnp.eye(n, dtype=A_dense.dtype))
    Qnorm = jnp.linalg.norm(Q)

    def err_at(step_samples):  # (chains, n)
        C = sample_covariance(step_samples)
        return jnp.linalg.norm(C - Q) / Qnorm

    return jax.vmap(err_at)(jnp.swapaxes(samples, 0, 1))


def gelman_rubin(vals: jax.Array) -> jax.Array:
    """R-hat of scalar chains (chains, n), per examples/ex7.c:61-91.

    B = n/(chains-1) * sum (mean_i - mean)^2,
    W = mean of within-chain variances,
    R = ((n-1)/n W + B/n) / W.
    """
    chains, n = vals.shape
    means = jnp.mean(vals, axis=1)
    mean = jnp.mean(means)
    B = n / (chains - 1.0) * jnp.sum((means - mean) ** 2)
    W = jnp.mean(jnp.sum((vals - means[:, None]) ** 2, axis=1) / (n - 1.0))
    return ((n - 1.0) / n * W + B / n) / W


def sample_until_converged(
    sampler,
    b,
    qoi,
    n_chains: int = 8,
    check_every: int = 50,
    rhat_tol: float = 1.05,
    max_steps: int = 100_000,
    overdispersion: float = 1e3,
    seed: int = 0,
    method: str = "classic",
):
    """Run overdispersed chains until Gelman-Rubin R-hat < tol (ex7 flow).

    Returns (qoi_trace (chains, steps), n_steps, rhat).  Chains run
    vmapped on device; convergence is checked on host every
    ``check_every`` steps on the accumulated scalar QOI traces
    (examples/ex7.c:196-218 semantics with overdispersed inits,
    ex7.c:170-177).  ``method="classic"`` is ex7's moment R-hat;
    ``method="rank"`` uses the rank-normalized split-R-hat with folding
    (``diagnostics.rhat.rhat_rank``, Vehtari et al. 2021) — stricter on
    trends and tail mismatches, recommended for production runs.
    """
    import numpy as np

    from parmgmc_tpu.chain import ChainState, sample_chain

    if method == "rank":
        from parmgmc_tpu.diagnostics.rhat import rhat_rank as _rhat
    elif method == "classic":
        _rhat = lambda v: float(gelman_rubin(v))  # noqa: E731
    else:
        raise ValueError(f"method must be 'classic' or 'rank', got {method!r}")

    keys = jax.random.split(jax.random.PRNGKey(seed), n_chains)

    def init_one(key):
        kinit, kchain = jax.random.split(key)
        x0 = overdispersion * jax.random.normal(
            kinit, sampler.grid_shape, dtype=sampler.dtype
        )
        return ChainState(x=x0, key=kchain)

    states = jax.vmap(init_one)(keys)
    run = jax.jit(
        jax.vmap(
            lambda smp, st, bb: sample_chain(smp, st, bb, check_every, extract=qoi),
            in_axes=(None, 0, None),
        )
    )

    traces = []
    steps = 0
    rhat = float("inf")
    while steps < max_steps:
        states, q = run(sampler, states, b)
        traces.append(np.asarray(q))
        steps += check_every
        vals = jnp.asarray(np.concatenate(traces, axis=1))
        rhat = _rhat(vals)
        if rhat < rhat_tol:
            break
    return np.concatenate(traces, axis=1), steps, rhat
