"""Headline benchmark: ESS/sec on a 256^3 GMRF with MGMC V(1,0).

Mirrors the reference's benchmark harness semantics
(``/root/reference/examples/benchmark/main.cc``): time-per-sample from a
wall-clocked chain, IACT of a scalar QOI via the emcee-window estimator
(``src/iact.c``), and time-per-independent-sample = max(tau,1) * T / n.
We report ESS/sec = 1 / time-per-independent-sample.

Prints the device line, then ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...}

    python bench.py [--posterior]        # knobs: BENCH_N, BENCH_STEPS,
                                         # BENCH_IACT_STEPS

It needs a GPU; ``JAX_PLATFORMS=cpu`` allows a CPU rehearsal at a small
``BENCH_N`` (its times describe the CPU, not the card).

vs_baseline compares against a 64-rank MPI CPU reference derived from a
MEASURED single-core re-timing of the reference's CSR SOR hot loop
(parmgmc_tpu/native/ref_sor_bench.cpp; reproduce with
examples/baseline_cpu_reference.py) scaled by a perfect-scaling model
that is generous to the reference (BASELINE.md).  The reference itself
publishes no numbers.
"""

import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

N = int(os.environ.get("BENCH_N", "256"))
# the reference benchmark times thousands of samples (benchmarkrc:
# 10000); a few hundred steps amortize the dispatch of one scan
N_TIME = int(os.environ.get("BENCH_STEPS", "512"))
# the emcee-window estimate on 2-4k samples swings by +-8% for tau ~ 1;
# 16k samples bring the estimator's spread down to ~4%
N_IACT = int(os.environ.get("BENCH_IACT_STEPS", "16384"))
DTYPE = jnp.float32

# CPU anchor (BASELINE.md): the reference's CSR red/black SOR sweep
# runs at 49.5 MDOF/s/core at 128^3 (out of cache), i.e. ~5 GB/s/core
# at ~100 B/DOF.  64 ranks, perfect scaling, free RNG, V(1,0) at 2.57
# fine-sweep-equivalents/cycle -> 73.9 cycles/s at 256^3, granted the
# same tau >= 1 clamp this bench applies: 74 ESS/sec.  The
# bandwidth-bound reference scales ~1/N^3 at matched tau.
BASELINE_ESS_PER_SEC = 74.0 * (256 / N) ** 3


def device_info() -> dict:
    """The device the run measures, as JAX reports it."""
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind, "count": len(jax.devices())}


def require_gpu() -> dict:
    """Device info, or SystemExit when no GPU is present (a CPU run is
    allowed only when ``JAX_PLATFORMS=cpu`` asks for a rehearsal)."""
    info = device_info()
    if info["platform"] != "gpu" and os.environ.get("JAX_PLATFORMS") != "cpu":
        raise SystemExit(
            f"bench.py measures a GPU; JAX found {info}. "
            "Set JAX_PLATFORMS=cpu for a CPU rehearsal."
        )
    return info


def posterior_problem(n, k=5, dtype=jnp.float32):
    """256^3-style Bayesian posterior: GMRF prior + k ball-average
    observations (BASELINE.md eval config 4; reference ex4/obs.c)."""
    from parmgmc_tpu.models.obs import make_posterior_operator
    from parmgmc_tpu.models.problems import gmrf_3d

    base = gmrf_3d(n, kappa=1.0, dtype=dtype)
    rng = np.random.default_rng(0)
    coords = 0.15 + 0.7 * rng.random((k, 3))
    op, f = make_posterior_operator(
        base, 0.01, coords, np.full(k, 0.12), obsvals=rng.standard_normal(k)
    )
    return op, f


def build(posterior: bool = False, n: int = N):
    """(op, b, sampler) of the benchmark configuration: plain-aggregation
    hierarchy, V(1,0) cycles, deep coarsening.  ``b=None`` is the zero
    RHS of prior sampling."""
    from parmgmc_tpu.models.problems import gmrf_3d
    from parmgmc_tpu.samplers.mgmc import MGMCSampler

    if posterior:
        op, b = posterior_problem(n, k=5, dtype=DTYPE)
    else:
        op, b = gmrf_3d(n, kappa=1.0, dtype=DTYPE), None
    sampler = MGMCSampler.create(
        op, n_pre=1, n_post=0, coarsest_size=128, coarsening="aggregate"
    )
    return op, b, sampler


def memory_analysis(compiled) -> "dict | None":
    """``compiled.memory_analysis()`` as a dict of byte counts (None
    where the backend reports none)."""
    ma = compiled.memory_analysis()
    if ma is None:
        return None
    fields = (
        "argument_size_in_bytes",
        "output_size_in_bytes",
        "alias_size_in_bytes",
        "temp_size_in_bytes",
        "generated_code_size_in_bytes",
    )
    return {f: int(getattr(ma, f)) for f in fields if hasattr(ma, f)}


def main(
    posterior: bool = False,
    n: int = N,
    steps: int = N_TIME,
    iact_steps: int = N_IACT,
):
    """Run the benchmark, print its JSON line and return
    ``(record, sampler, b)`` so a caller can check the same sampler."""
    from parmgmc_tpu.chain import ChainState, sample_chain
    from parmgmc_tpu.diagnostics.iact import iact

    info = require_gpu()
    print(json.dumps({"device": info}), flush=True)
    t_setup = time.perf_counter()
    op, b, sampler = build(posterior, n)
    jax.block_until_ready(sampler)
    setup_s = time.perf_counter() - t_setup

    # the sampler and b are jit ARGUMENTS: closed over, the operator
    # hierarchy (hundreds of MB at 256^3) would become program constants.
    # The chain state is donated: its buffers are reused for the output.
    run = jax.jit(
        lambda smp, s, bb: sample_chain(smp, s, bb, steps, extract=jnp.mean),
        donate_argnums=(1,),
    )
    st = ChainState(x=jnp.zeros(op.grid_shape, DTYPE), key=jax.random.PRNGKey(0))
    t0 = time.perf_counter()
    run_time = run.lower(sampler, st, b).compile()
    compile_s = time.perf_counter() - t0
    memory = memory_analysis(run_time)

    # warm-up run advances past the transient; then the timed run
    st, _ = run_time(sampler, st, b)
    jax.block_until_ready(st.x)
    t0 = time.perf_counter()
    st, _ = run_time(sampler, st, b)
    jax.block_until_ready(st.x)
    dt = (time.perf_counter() - t0) / steps  # seconds per V(1,0) sample

    # the IACT trace reuses the compiled timing program: no second compile
    qs = []
    for _ in range(-(-iact_steps // steps)):
        st, q = run_time(sampler, st, b)
        qs.append(np.asarray(q))
    q = np.concatenate(qs)[:iact_steps]
    tau, valid = iact(q)
    tau = max(float(tau), 1.0)
    ess_per_sec = 1.0 / (tau * dt)

    baseline = BASELINE_ESS_PER_SEC
    if posterior:
        # posterior-adjusted CPU model: the reference's LRC sweep adds
        # ~120 B/DOF of rank-k vector traffic per fine sweep (k=5 f64:
        # B w RHS axpys + VecMDot + VecMAXPY, mc_sor.c:101-112) on top
        # of the 257 B/DOF prior cycle model -> 257/394 = 0.65x
        baseline *= 0.65

    # the single-window tau estimate swings with the trace section, so
    # report tau over three half-windows too: a real mixing regression
    # moves all of them, estimator noise scatters them around ~1
    m = len(q)
    tau_secs = []
    for lo, hi in ((0, m // 2), (m // 4, 3 * m // 4), (m // 2, m)):
        t_s, _ = iact(q[lo:hi])
        tau_secs.append(max(float(t_s), 1.0))

    stats = jax.devices()[0].memory_stats() or {}
    name = "posterior k=5 ball-obs" if posterior else "GMRF"
    record = {
        "metric": f"ESS/sec, {n}^3 {name}, MGMC agg-V(1,0) chain, f32, 1 device"
        + ("" if valid else " (IACT window short)"),
        "value": ess_per_sec,
        "unit": "ESS/sec",
        "vs_baseline": ess_per_sec / baseline,
        "tau": tau,
        "tau_sections": tau_secs,
        "iact_valid": bool(valid),
        "iact_steps": int(m),
        "ms_per_cycle": dt * 1e3,
        "timed_steps": steps,
        "setup_s": setup_s,
        "compile_s": compile_s,
        "memory_analysis": memory,
        "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
        "device": info,
    }
    print(json.dumps(record), flush=True)
    return record, sampler, b


if __name__ == "__main__":
    from parmgmc_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    main(
        posterior="--posterior" in sys.argv
        or os.environ.get("BENCH_POSTERIOR", "0") == "1"
    )
