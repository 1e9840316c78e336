"""Smoke run of the MGMC sampling path on NVIDIA GPUs.

    python chip_smoke.py                # phases A-G on one card
    python chip_smoke.py --four-cards   # the multi-card paths on four cards

It drives the system through its normal entry points (``MGMCSampler``,
``build_sampler``, ``MaternMeshSampler``, ``chain.sample_chain``,
``bench.main``) at real sizes and checks what comes out against the
repository's references: the exact invariance oracle, dense moments,
and the same step run on the host CPU backend with the same noise.

Phases on one card:

  A  device: JAX must see a GPU (no fallback to the CPU)
  B  the ``gpu``-marked tests, in a child process that has the card
     to itself (the parent touches the card only after it)
  C  exactness on the card in f64: invariance oracle, ex1 moments
  D  the 256^3 GMRF prior benchmark (f32) and its parity with the CPU
  E  the 256^3 posterior benchmark (k=5) and its parity with the CPU
  F  the level-0 stages against a copy measured in the same process
  G  the wrench mesh with 256 chains, the 128^3 squared prior with
     patch-Gibbs, and a 512^3 prior chain with its memory

Each phase prints one JSON line.  The last line,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``,
is printed only when every phase passed; otherwise the exit code is 1.
"""

import argparse
import json
import math
import os
import subprocess
import sys
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))
# f32 parity between card and host: roundoff through ~7 levels stays far
# below this; TF32 contractions (~1e-3) do not
PARITY_TOL = 1e-5
INVARIANCE_TOL = 1e-10
EX1_TOL = 0.02


def emit(record: dict) -> None:
    print(json.dumps(record, default=str), flush=True)


def check(cond: bool, msg: str) -> None:
    """Fail the current phase (asserts vanish under ``python -O``)."""
    if not cond:
        raise RuntimeError(msg)


def nvidia_smi() -> str:
    """``name, power.limit`` of every card, from a child that stays off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
        check=True,
    )
    return out.stdout.strip()


def require_gpu(devices, count: int = 1) -> dict:
    """Device record of the run; raises unless JAX's first device is a
    GPU and at least ``count`` of them are present."""
    d = devices[0]
    if d.platform != "gpu":
        raise RuntimeError(f"JAX's first device is {d.platform!r}, not a GPU")
    if len(devices) < count:
        raise RuntimeError(f"{len(devices)} GPU(s) present, {count} needed")
    return {"platform": d.platform, "kind": d.device_kind, "count": len(devices)}


def result_line(device: dict) -> str:
    """The exact last line of a passing run."""
    return json.dumps(
        {
            "ok": True,
            "device": {
                "platform": device["platform"],
                "kind": device["kind"],
                "count": device["count"],
            },
        }
    )


def run_phases(phases) -> bool:
    """Run ``(name, fn)`` pairs in order, one JSON line each; a failed
    phase is reported and the rest still run.  True iff all passed."""
    ok = True
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            record = {"phase": name, "ok": True, **(fn() or {})}
        except Exception as e:  # noqa: BLE001 — report every phase's failure
            traceback.print_exc()
            ok = False
            record = {"phase": name, "ok": False, "error": f"{type(e).__name__}: {e}"}
        record["seconds"] = time.perf_counter() - t0
        emit(record)
    return ok


# -- helpers shared by the phases ------------------------------------------


def _rel_err(a, b) -> float:
    import numpy as np

    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _host_noises(sampler, dtype, seed, batch=()):
    """Standard-normal draws for one ``step_with_noise``, made on the host
    so both backends read the same bits."""
    import jax
    import numpy as np

    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten(
        sampler.noise_shapes(), is_leaf=lambda s: isinstance(s, tuple)
    )
    draws = [
        rng.standard_normal(tuple(s) + tuple(batch), dtype=np.float32).astype(dtype)
        for s in leaves
    ]
    return jax.tree_util.tree_unflatten(treedef, draws)


def cpu_parity(sampler, b, seed=0, batch=()) -> float:
    """Relative max error of one ``step_with_noise`` on the default device
    against the same step on the host CPU backend, same state and noise."""
    import jax
    import numpy as np

    dtype = np.dtype(sampler.dtype)
    rng = np.random.default_rng(seed + 1)
    x = rng.standard_normal(tuple(sampler.grid_shape) + tuple(batch), np.float32)
    x = x.astype(dtype)
    noises = _host_noises(sampler, dtype, seed, batch)
    step = jax.jit(lambda s, xx, bb, nn: s.step_with_noise(xx, bb, nn))
    dev = jax.devices()[0]
    cpu = jax.devices("cpu")[0]
    on = lambda d, tree: jax.device_put(tree, d)  # noqa: E731
    got = step(on(dev, sampler), on(dev, x), on(dev, b), on(dev, noises))
    want = step(on(cpu, sampler), on(cpu, x), on(cpu, b), on(cpu, noises))
    return _rel_err(got, want)


def _time_calls(fn, args, reps=5):
    """Seconds per call of a jitted ``fn``: one warm-up call, then
    ``reps`` calls queued back to back and one wait for the last."""
    import jax

    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


# -- phases on one card ------------------------------------------------------


def phase_b() -> dict:
    """The ``gpu``-marked tests, in a child that has the card to itself."""
    env = dict(os.environ, JAX_PLATFORMS="cuda,cpu")
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-m", "gpu", "tests/", "-q", "-rs",
         "-p", "no:cacheprovider"],
        cwd=REPO,
        env=env,
        capture_output=True,
        text=True,
        timeout=600,
    )
    tail = proc.stdout.strip().splitlines()[-1:] or [""]
    print(proc.stdout[-4000:], proc.stderr[-2000:], sep="\n", flush=True)
    check(proc.returncode == 0, f"pytest -m gpu exited {proc.returncode}")
    check(" passed" in tail[0] and "skipped" not in tail[0], f"summary: {tail[0]}")
    return {"pytest": tail[0]}


def phase_c(grid=(5, 5), ex1_grid=(9, 9), gibbs_steps=400_000, mgmc_steps=200_000) -> dict:
    """Exactness on the card: the invariance oracle (f64) and the ex1
    sample-mean flow against a dense solve (f32)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from parmgmc_tpu.chain import init_chain, sample_moments
    from parmgmc_tpu.models.obs import make_observation_mats
    from parmgmc_tpu.models.problems import squared_shifted_laplace_fd
    from parmgmc_tpu.operators.lrc import LRCOperator
    from parmgmc_tpu.operators.stencil import shifted_laplace_fd
    from parmgmc_tpu.samplers.gibbs import GibbsSampler
    from parmgmc_tpu.samplers.mgmc import MGMCSampler
    from parmgmc_tpu.samplers.patch_gibbs import PatchGibbsSampler
    from parmgmc_tpu.testing import invariance_error

    out = {}
    with jax.enable_x64(True):
        f64 = jnp.float64
        op = shifted_laplace_fd(grid, 1.5, dtype=f64)
        b = jnp.sin(jnp.arange(math.prod(grid), dtype=f64)).reshape(grid)
        B, sigma_inv, _ = make_observation_mats(
            grid, 0.1, np.array([[0.3, 0.4], [0.7, 0.6]]), np.full(2, 0.3),
            dtype=f64,
        )
        lrc = LRCOperator(base=op, B=B, sigma_inv=sigma_inv)
        sq = squared_shifted_laplace_fd(grid, 3.0, dtype=f64)
        cases = {
            "gibbs_forward": (GibbsSampler.create(op, sweep="forward"), op),
            "gibbs_symmetric": (GibbsSampler.create(op, sweep="symmetric"), op),
            "mgmc_linear": (MGMCSampler.create(op, n_levels=2), op),
            "mgmc_aggregate": (
                MGMCSampler.create(op, n_levels=2, coarsening="aggregate"), op
            ),
            "mgmc_lrc": (MGMCSampler.create(lrc, n_levels=2), lrc),
            "patch_gibbs_squared": (PatchGibbsSampler.create(sq), sq),
        }
        inv = {}
        for name, (smp, o) in cases.items():
            inv[name] = max(float(e) for e in invariance_error(smp, o, b))
        out["invariance"] = inv
        bad = {k: v for k, v in inv.items() if not v < INVARIANCE_TOL}
        check(not bad, f"invariance above {INVARIANCE_TOL}: {bad}")

    # ex1: sample mean of N(A^{-1} 1, A^{-1}) against a dense solve
    op = shifted_laplace_fd(ex1_grid, 10.0, dtype=jnp.float32)
    b = jnp.ones(ex1_grid, jnp.float32)
    A = np.asarray(op.to_dense(), np.float64)
    ex_mean = np.linalg.solve(A, np.ones(op.n)).reshape(ex1_grid)
    ex1 = {}
    for name, smp, n in (
        ("gibbs", GibbsSampler.create(op, omega=1.0, sweep="forward"), gibbs_steps),
        ("mgmc", MGMCSampler.create(op, n_levels=3), mgmc_steps),
    ):
        st = init_chain(smp, jax.random.PRNGKey(1))
        run = jax.jit(lambda s, st, bb, n=n: sample_moments(s, st, bb, n, burnin=2000))
        _, mean, _ = run(smp, st, b)
        mean = np.asarray(mean, np.float64)
        ex1[name] = float(np.linalg.norm(mean - ex_mean) / np.linalg.norm(ex_mean))
    out["ex1_rel_mean_err"] = ex1
    check(all(v < EX1_TOL for v in ex1.values()), f"ex1 above {EX1_TOL}: {ex1}")
    return out


def phase_bench(posterior: bool, n=256, steps=256, iact_steps=4096) -> dict:
    """``bench.main`` in-process, then one step on card and host."""
    import bench

    record, sampler, b = bench.main(
        posterior=posterior, n=n, steps=steps, iact_steps=iact_steps
    )
    err = cpu_parity(sampler, b)
    check(math.isfinite(record["ms_per_cycle"]), "non-finite step time")
    check(err <= PARITY_TOL, f"card vs CPU step rel err {err} > {PARITY_TOL}")
    return {
        "n": n,
        "compile_s": record["compile_s"],
        "ms_per_cycle": record["ms_per_cycle"],
        "tau": record["tau"],
        "ess_per_sec": record["value"],
        "memory_analysis": record["memory_analysis"],
        "peak_bytes_in_use": record["peak_bytes_in_use"],
        "cpu_parity_rel_err": err,
    }


def phase_f(n=256, reps=50) -> dict:
    """Level-0 stages of the 256^3 prior cycle against the copy rate
    measured here.  Byte floors are reckoned from shapes, 4 B per f32
    point, N = n^3 points:

      copy  ``y = x + 1``                 read x, write y       8 N
      Gibbs half-step (keyed noise)       read x, diag, noise
                                          scale; write x        16 N
      residual + restriction (b = 0)      read x, diag;
                                          write N/8 coarse      8.5 N
    """
    import jax
    import jax.numpy as jnp

    from parmgmc_tpu.models.problems import gmrf_3d
    from parmgmc_tpu.samplers.mgmc import MGMCSampler

    op = gmrf_3d(n, kappa=1.0, dtype=jnp.float32)
    smp = MGMCSampler.create(
        op, n_pre=1, n_post=0, coarsest_size=128, coarsening="aggregate"
    )
    npts = n**3
    x = jax.random.normal(jax.random.PRNGKey(0), op.grid_shape, jnp.float32)
    key = jax.random.PRNGKey(1)

    copy = jax.jit(lambda a: a + 1.0)
    gibbs = jax.jit(lambda s, k, a: s.smoothers[0].step(k, a, None))
    resid = jax.jit(lambda s, a: s.transfers[0].restrict(-s.ops[0].apply(a)))

    t_copy = _time_calls(copy, (x,), reps)
    rate = 8 * npts / t_copy  # bytes/s the card reaches on a plain copy
    t_gibbs = _time_calls(gibbs, (smp, key, x), reps)
    t_resid = _time_calls(resid, (smp, x), reps)
    floor = lambda nbytes: nbytes / rate  # noqa: E731
    return {
        "n": n,
        "copy_s": t_copy,
        "copy_bytes_per_s": rate,
        "gibbs_half_step_s": t_gibbs,
        "gibbs_over_floor": t_gibbs / floor(16 * npts),
        "residual_restrict_s": t_resid,
        "residual_restrict_over_floor": t_resid / floor(8.5 * npts),
    }


def phase_g(refine=3, chains=256, patch_n=128, big_n=512, big_steps=8) -> dict:
    """The other deployments, a few steps each."""
    import jax
    import jax.numpy as jnp

    from parmgmc_tpu.chain import ChainState, sample_chain
    from parmgmc_tpu.models.matern import MaternMeshSampler
    from parmgmc_tpu.models.problems import gmrf_3d, squared_shifted_laplace_fd
    from parmgmc_tpu.samplers.mgmc import MGMCSampler
    from parmgmc_tpu.samplers.patch_gibbs import PatchGibbsSampler

    out = {}
    # wrench preset posterior (examples/benchmark/wrench.json), chain-major
    with open(os.path.join(REPO, "examples", "benchmark", "wrench.json")) as f:
        preset = json.load(f)
    ms = MaternMeshSampler(
        mesh_file=preset["mesh"],
        kappa=preset["kappa"],
        refinements=refine,
        dtype=jnp.float32,
        observations=dict(
            sigma2=preset["sigma2"],
            coords=preset["obs_coords"],
            radii=preset["obs_radii"],
            values=preset["obs_values"],
        ),
        coarsest_size=128,
    )
    ms.set_qoi(jnp.mean)
    t0 = time.perf_counter()
    q = jax.block_until_ready(ms.sample_chains(16, chains))
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    q = jax.block_until_ready(ms.sample_chains(16, chains))
    dt = (time.perf_counter() - t0) / 16
    check(bool(jnp.all(jnp.isfinite(q))), "wrench chains produced non-finite QOIs")
    err = cpu_parity(ms.sampler, ms.b, seed=3, batch=(chains,))
    check(err <= PARITY_TOL, f"wrench card vs CPU rel err {err}")
    out["wrench"] = {
        "dofs": ms.n,
        "levels": ms.sampler.n_levels,
        "chains": chains,
        "first_call_s": t_first,
        "s_per_step": dt,
        "cpu_parity_rel_err": err,
    }

    # squared prior with the patch-Gibbs smoother (the ex9 flow)
    sq = squared_shifted_laplace_fd((patch_n,) * 3, 1.0, dtype=jnp.float32)
    psmp = PatchGibbsSampler.create(sq)
    sweep = jax.jit(lambda s, k, a: s.step(k, a, None))
    xp = jnp.zeros(sq.grid_shape, jnp.float32)
    t0 = time.perf_counter()
    jax.block_until_ready(sweep(psmp, jax.random.PRNGKey(0), xp))
    t_first = time.perf_counter() - t0
    t_sweep = _time_calls(sweep, (psmp, jax.random.PRNGKey(1), xp), 3)
    out["patch_gibbs"] = {"n": patch_n, "first_call_s": t_first, "s_per_sweep": t_sweep}

    # a short chain at the next structured size, with its memory
    op = gmrf_3d(big_n, kappa=1.0, dtype=jnp.float32)
    smp = MGMCSampler.create(
        op, n_pre=1, n_post=0, coarsest_size=128, coarsening="aggregate"
    )
    run = jax.jit(
        lambda s, st: sample_chain(s, st, None, big_steps, extract=jnp.mean),
        donate_argnums=(1,),
    )
    st = ChainState(x=jnp.zeros(op.grid_shape, jnp.float32), key=jax.random.PRNGKey(0))
    t0 = time.perf_counter()
    compiled = run.lower(smp, st).compile()
    t_compile = time.perf_counter() - t0
    st, q = compiled(smp, st)
    jax.block_until_ready(q)
    t0 = time.perf_counter()
    st, q = compiled(smp, st)
    jax.block_until_ready(q)
    t_chain = (time.perf_counter() - t0) / big_steps
    check(bool(jnp.all(jnp.isfinite(q))), "512^3 chain produced non-finite QOIs")
    # the same cycle as one jitted step outside a scan, for comparison
    step = jax.jit(lambda s, k, a: s.step(k, a, None)[1])
    t_step = _time_calls(step, (smp, jax.random.PRNGKey(1), st.x))
    import bench

    out["prior_big"] = {
        "n": big_n,
        "compile_s": t_compile,
        "ms_per_cycle": t_chain * 1e3,
        "ms_per_step_outside_scan": t_step * 1e3,
        "memory_analysis": bench.memory_analysis(compiled),
        "peak_bytes_in_use": (jax.devices()[0].memory_stats() or {}).get(
            "peak_bytes_in_use"
        ),
    }
    return out


# -- phases on four cards ------------------------------------------------------


def phase_sharded_mgmc(n=512, n_dev=4) -> dict:
    """Lax sharded MGMC step on a (4,) mesh against the one-card step,
    with the same explicit noise."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh

    from parmgmc_tpu.models.problems import gmrf_3d
    from parmgmc_tpu.parallel.mesh import shard_sampler
    from parmgmc_tpu.samplers.mgmc import MGMCSampler
    from parmgmc_tpu.testing import sharded_step_error

    op = gmrf_3d(n, kappa=1.0, dtype=jnp.float32)
    smp = MGMCSampler.create(
        op, n_pre=1, n_post=0, coarsest_size=128, coarsening="aggregate"
    )
    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("x",))
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal(op.grid_shape, np.float32))
    noises = jax.tree_util.tree_map(jnp.asarray, _host_noises(smp, np.float32, 1))
    axes = ("x", None, None)
    err, out = sharded_step_error(smp, mesh, x, None, noises, grid_axes=axes)
    check(len(out.sharding.device_set) == n_dev, "output does not span the mesh")
    check(err <= PARITY_TOL, f"sharded vs one-card rel err {err}")

    step = jax.jit(lambda s, k, xx: s.step(k, xx, None))
    key = jax.random.PRNGKey(2)
    t_one = _time_calls(step, (smp, key, x))
    smp_sh, xsh = shard_sampler(smp, mesh, 4, axes)
    t_four = _time_calls(step, (smp_sh, key, jax.device_put(x, xsh)))
    return {"n": n, "rel_err": err, "step_s_1card": t_one, "step_s_4cards": t_four}


def phase_chain_mesh(n_dev=4, chains=256, refine_n=2) -> dict:
    """Chain-parallel mesh path: vmapped mesh chains with keys and states
    sharded over the cards against the same chains on one card."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from parmgmc_tpu.models.mesh import matern_precision_mesh, read_gmsh, mesh_path, refine
    from parmgmc_tpu.operators.graph import from_csr
    from parmgmc_tpu.samplers.mgmc import MGMCSampler

    pts, cells = read_gmsh(mesh_path("wrench"))
    for _ in range(refine_n):
        pts, cells = refine(pts, cells)
    op = from_csr(matern_precision_mesh(pts, cells, 5.0), dtype=jnp.float32)
    smp = MGMCSampler.create(op, coarsest_size=128)
    b = jnp.zeros((op.n,), jnp.float32)
    keys = jax.random.split(jax.random.PRNGKey(3), chains)
    x0 = jnp.zeros((chains, op.n), jnp.float32)

    def chain_step(s, key, x, bb):
        return s.step(key, x, bb)

    step = jax.jit(jax.vmap(chain_step, in_axes=(None, 0, 0, None)))
    _, x_ref = step(smp, keys, x0, b)
    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("chain",))
    csh = NamedSharding(mesh, P("chain"))
    rep = NamedSharding(mesh, P())
    args_sh = (
        jax.device_put(smp, rep),
        jax.device_put(keys, csh),
        jax.device_put(x0, csh),
        jax.device_put(b, rep),
    )
    _, x_sh = step(*args_sh)
    check(len(x_sh.sharding.device_set) == n_dev, "chains do not span the mesh")
    err = _rel_err(x_sh, x_ref)
    check(err <= PARITY_TOL, f"sharded chains vs one card rel err {err}")
    t_one = _time_calls(step, (smp, keys, x0, b))
    t_four = _time_calls(step, args_sh)
    return {
        "dofs": op.n,
        "chains": chains,
        "rel_err": err,
        "step_s_1card": t_one,
        "step_s_4cards": t_four,
    }


def phase_graph_sharded(n_dev=4, refine_n=3) -> dict:
    """Row-partitioned mesh MGMC (parallel.graph_sharded) on the wrench
    mesh against the one-card step, noise off (deterministic parity)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh

    from parmgmc_tpu.models.mesh import matern_precision_mesh, mesh_path, read_gmsh, refine
    from parmgmc_tpu.operators.graph import from_csr
    from parmgmc_tpu.parallel.graph_sharded import (
        make_sharded_graph_mgmc_step,
        to_global,
        to_local,
    )
    from parmgmc_tpu.samplers.mgmc import MGMCSampler

    pts, cells = read_gmsh(mesh_path("wrench"))
    for _ in range(refine_n):
        pts, cells = refine(pts, cells)
    op = from_csr(matern_precision_mesh(pts, cells, 5.0), dtype=jnp.float32)
    smp = MGMCSampler.create(op, coarsest_size=128)
    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("x",))
    step_sh, spec, shard = make_sharded_graph_mgmc_step(
        smp, mesh, coords=pts, with_noise=False
    )
    rng = np.random.default_rng(4)
    x = jnp.asarray(rng.standard_normal(op.n, np.float32))
    b = jnp.ones((op.n,), jnp.float32)
    args = (
        jax.random.PRNGKey(11),
        jax.device_put(to_local(spec, x), shard),
        jax.device_put(to_local(spec, b), shard),
    )
    _, out = step_sh(*args)
    check(len(out.sharding.device_set) == n_dev, "output does not span the mesh")
    got = to_global(spec, out, op.n)
    zeros = jax.tree_util.tree_map(
        lambda s: jnp.zeros(s, jnp.float32),
        smp.noise_shapes(),
        is_leaf=lambda s: isinstance(s, tuple),
    )
    one = jax.jit(lambda s, xx, bb, nn: s.step_with_noise(xx, bb, nn))
    ref = one(smp, x, b, zeros)
    err = _rel_err(got, ref)
    check(err <= 5e-5, f"row-partitioned vs one-card rel err {err}")
    t_four = _time_calls(lambda *a: step_sh(*a)[1], args)
    t_one = _time_calls(one, (smp, x, b, zeros))
    return {"dofs": op.n, "rel_err": err, "step_s_1card": t_one, "step_s_4cards": t_four}


# -- driver ------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "--four-cards",
        action="store_true",
        help="run only the multi-card paths and what they are compared with",
    )
    args = ap.parse_args(argv)

    try:
        smi = nvidia_smi()
    except (OSError, subprocess.SubprocessError) as e:
        print(f"chip_smoke: no NVIDIA GPU ({e})", file=sys.stderr)
        return 1
    print(smi, flush=True)

    ok = True
    if not args.four_cards:
        # before the parent touches the card: a second JAX process on it
        # would find three quarters of its memory taken
        ok = run_phases([("B", phase_b)])

    import jax

    platforms = os.environ.get("JAX_PLATFORMS", "")
    if platforms and "cpu" not in platforms.split(","):
        # the parity checks also need the host CPU backend
        jax.config.update("jax_platforms", platforms + ",cpu")
    from parmgmc_tpu.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    need = 4 if args.four_cards else 1
    try:
        device = require_gpu(jax.devices(), need)
    except RuntimeError as e:
        emit({"phase": "A", "ok": False, "error": str(e)})
        return 1
    emit(
        {
            "phase": "A",
            "ok": True,
            "device": device,
            "jax": jax.__version__,
            "nvidia_smi": smi,
            "compile_cache": cache,
        }
    )

    if args.four_cards:
        phases = [
            ("sharded_mgmc_512", phase_sharded_mgmc),
            ("chain_mesh", phase_chain_mesh),
            ("graph_sharded_wrench", phase_graph_sharded),
        ]
    else:
        phases = [
            ("C", phase_c),
            ("D", lambda: phase_bench(posterior=False)),
            ("E", lambda: phase_bench(posterior=True)),
            ("F", phase_f),
            ("G", phase_g),
        ]
    ok = run_phases(phases) and ok
    if not ok:
        return 1
    print(result_line(device), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
