"""End-to-end statistical acceptance tests (the reference's test style).

These mirror the reference's calibrated chain tests: ex1 (sample-mean
convergence vs a direct solve, tol 0.02 at 1e6 samples — we use fewer
samples and proportionally looser tolerances), ex4 (LRC posterior
means), ex6 (cross-chain covariance error trajectory), ex7
(Gelman-Rubin).  The machine-precision invariance tests in
test_sampler_exactness.py carry the correctness burden; these validate
the full chain pipeline (scan driver, RNG threading, moments, vmap
chain parallelism).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from parmgmc_tpu.chain import ChainState, init_chain, sample_chain, sample_moments
from parmgmc_tpu.diagnostics.stats import covariance_error_trajectory, gelman_rubin
from parmgmc_tpu.operators.stencil import shifted_laplace_fd
from parmgmc_tpu.samplers.cholesky import CholeskySampler
from parmgmc_tpu.samplers.gibbs import GibbsSampler
from parmgmc_tpu.samplers.mgmc import MGMCSampler
from parmgmc_tpu.samplers.registry import build_sampler

GRID = (9, 9)
KAPPA = 10.0
DTYPE = jnp.float64


def setup_problem():
    op = shifted_laplace_fd(GRID, KAPPA, dtype=DTYPE)
    b = jnp.ones(GRID, dtype=DTYPE)
    A = np.asarray(op.to_dense())
    ex_mean = np.linalg.solve(A, np.ones(op.n)).reshape(GRID)
    return op, b, A, ex_mean


OP, B, A_DENSE, EX_MEAN = setup_problem()


def run_mean(sampler, n, burnin, seed=1):
    st = init_chain(sampler, jax.random.PRNGKey(seed))
    run = jax.jit(lambda s: sample_moments(sampler, s, B, n, burnin=burnin))
    _, mean, _ = run(st)
    return np.linalg.norm(np.asarray(mean) - EX_MEAN) / np.linalg.norm(EX_MEAN)


# --- ex1 analogues: sample-mean convergence per sampler configuration ------


@pytest.mark.parametrize("sweep", ["forward", "backward", "symmetric"])
def test_ex1_gibbs_mean(sweep):
    smp = GibbsSampler.create(OP, omega=1.0, sweep=sweep)
    assert run_mean(smp, 120_000, 2_000) < 0.03


def test_ex1_cholesky_mean():
    smp = CholeskySampler.create(OP)
    assert run_mean(smp, 60_000, 1) < 0.03


def test_ex1_mgmc_coarse_cholesky_mean():
    smp = MGMCSampler.create(OP, n_levels=3, n_pre=1, n_post=1)
    assert run_mean(smp, 60_000, 100) < 0.03


def test_ex1_mgmc_coarse_gibbs_mean():
    """MGMC with an iterated Gibbs coarse sampler (ex1 RUN line 35)."""
    smp = build_sampler(
        OP,
        {
            "type": "mgmc",
            "n_levels": 3,
            "smoother": {"type": "gibbs", "omega": 1.0},
            "coarse": {"type": "gibbs", "omega": 1.0},
            "n_coarse": 2,
            "n_pre": 2,
            "n_post": 2,
        },
    )
    assert run_mean(smp, 60_000, 100) < 0.03


# --- ex6 analogue: cross-chain covariance error trajectory ------------------


def test_ex6_covariance_trajectory():
    smp = GibbsSampler.create(OP, omega=1.0, sweep="forward")
    nchains, nsteps = 512, 60
    keys = jax.random.split(jax.random.PRNGKey(3), nchains)

    def one_chain(key):
        st = init_chain(smp, key)
        _, xs = sample_chain(smp, st, B, nsteps, extract=lambda x: x.reshape(-1))
        return xs

    samples = jax.jit(jax.vmap(one_chain))(keys)  # (chains, steps, n)
    errs = np.asarray(
        covariance_error_trajectory(jnp.asarray(samples), jnp.asarray(A_DENSE))
    )
    # Early samples far from stationarity (started at 0), late samples close:
    # the MC floor for 512 chains and n=81 is ~ sqrt((n + tr^2/..)/chains) —
    # empirically ~0.3-0.4; the key property is decay toward the floor.
    assert errs[-1] < 0.5
    assert errs[-1] < errs[0]


# --- ex7 analogue: Gelman-Rubin convergence ---------------------------------


def test_ex7_gelman_rubin():
    smp = MGMCSampler.create(OP, n_levels=2)
    nchains, nsteps = 8, 600
    # Overdispersed inits (ex7 scales random vectors by 1e6).
    keys = jax.random.split(jax.random.PRNGKey(9), nchains)
    qoi = lambda x: jnp.mean(x)

    def one_chain(key):
        kinit, kchain = jax.random.split(key)
        x0 = 1e3 * jax.random.normal(kinit, GRID, dtype=DTYPE)
        st = ChainState(x=x0, key=kchain)
        _, qs = sample_chain(smp, st, B, nsteps, extract=qoi)
        return qs

    vals = jax.jit(jax.vmap(one_chain))(keys)  # (chains, steps)
    # Discard the transient half, as ex7 checks R-hat on the recorded window.
    r = float(gelman_rubin(vals[:, nsteps // 2 :]))
    assert r < 1.05, f"R-hat {r}"


# --- chain parallelism: vmap over chains matches serial statistics ---------


def test_vmap_chain_parallelism():
    smp = CholeskySampler.create(OP)
    nchains = 64
    keys = jax.random.split(jax.random.PRNGKey(5), nchains)

    def one_chain(key):
        st = init_chain(smp, key)
        _, mean, _ = sample_moments(smp, st, B, 2_000)
        return mean

    means = jax.jit(jax.vmap(one_chain))(keys)
    grand = np.asarray(jnp.mean(means, axis=0))
    rel = np.linalg.norm(grand - EX_MEAN) / np.linalg.norm(EX_MEAN)
    # 128k iid samples, field sd ~ 1/kappa vs mean ~ 1/kappa^2: MC floor ~0.028
    assert rel < 0.03


def test_fmg_init_is_near_stationary():
    """FMG cold start: chains started from fmg_init need no burn-in —
    the burnin=0 sample mean matches the direct solve as well as a
    well-burned chain does, and independent fmg_init draws already
    have approximately the stationary mean and pointwise variance."""
    smp = MGMCSampler.create(OP, n_levels=3, coarsest_size=8)

    # (a) many independent FMG draws: stationary mean + variance
    keys = jax.random.split(jax.random.PRNGKey(7), 512)
    draw = jax.jit(jax.vmap(lambda k: smp.fmg_init(k, B)[1]))
    xs = np.asarray(draw(keys))
    var_ex = np.diag(np.linalg.inv(A_DENSE)).reshape(GRID)
    mean_err = np.abs(xs.mean(0) - EX_MEAN) / np.sqrt(var_ex / len(keys))
    assert mean_err.max() < 5.0, mean_err.max()  # z-scores
    rel_var = np.abs(xs.var(0) - var_ex) / var_ex
    assert np.median(rel_var) < 0.25, np.median(rel_var)

    # (b) burnin-free chain from one FMG start
    key = jax.random.PRNGKey(3)
    key, x0 = smp.fmg_init(key, B)
    st = init_chain(smp, key, x0=x0)
    run = jax.jit(lambda s: sample_moments(smp, s, B, 4000, burnin=0))
    _, mean, _ = run(st)
    rel = np.linalg.norm(np.asarray(mean) - EX_MEAN) / np.linalg.norm(EX_MEAN)
    # MC noise floor at 4000 samples is ~0.1 (ex1: 0.015 at 200k); a
    # cold non-FMG start at burnin=0 fails this bound badly
    assert rel < 0.15, rel


def test_sample_chains_vmapped_facade():
    """sample_chains: vmapped independent chains through the Matérn
    façade — distinct traces per chain, persistent continuation, and a
    cross-chain mean matching the (zero) field mean."""
    from parmgmc_tpu.models.matern import MaternSampler

    ms = MaternSampler((9, 9), kappa=10.0, dtype=jnp.float64, n_levels=2)
    ms.set_qoi(lambda x: jnp.mean(x))
    q = np.asarray(ms.sample_chains(200, 4, burnin=20))
    assert q.shape == (4, 200)
    assert np.isfinite(q).all()
    assert len({tuple(np.round(row[:5], 12)) for row in q}) == 4  # distinct
    q2 = np.asarray(ms.sample_chains(200, 4))  # continuation, no reinit
    assert not np.allclose(q2[:, 0], q[:, 0])
    pooled = np.concatenate([q, q2], axis=1).mean()
    sd = np.concatenate([q, q2], axis=1).std() / np.sqrt(4 * 400 / 4.0)
    assert abs(pooled) < 5 * sd + 1e-3
