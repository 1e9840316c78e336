"""Configurable Matérn benchmark driver (the benchmark/ harness analogue).

Reference: /root/reference/examples/benchmark/main.cc + benchmarkrc /
wrench.opts: burn-in + sampling phases over a Gmsh-mesh Matérn problem
(optionally with low-rank observations), Welford mean/var, and the three
headline prints — time per sample, IACT of a QOI, time per independent
sample (max(tau,1) * T / n).

Presets mirroring the reference's .opts files (mesh + observations +
QOI region) are checked in under examples/benchmark/:

    python examples/benchmark_matern.py --preset examples/benchmark/wrench.json \
        --refine 1 --samples 10000 --anchor-ranks 64

``--anchor-ranks N`` additionally times the reference's multicolour CSR
SOR hot loop on THIS problem's assembled matrix (one host core, native
code: parmgmc_tpu/native/ref_sor_bench.cpp pmg_ref_sor_bench_csr) and
reports this run's throughput against an N-rank perfect-scaling model
of the reference — the same generous anchor methodology as bench.py's
structured vs_baseline (BASELINE.md).
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from parmgmc_tpu.chain import sample_chain, sample_moments
from parmgmc_tpu.diagnostics.iact import iact
from parmgmc_tpu.models.matern import MaternMeshSampler


def region_qoi(points, preset):
    """Mean of the field over the preset's QOI region (main.cc qoi_type
    rect/sphere), as a weight vector over ORIGINAL node ordering."""
    if preset.get("qoi_type") == "rect":
        lo = np.asarray(preset["qoi_start"], float)
        hi = np.asarray(preset["qoi_end"], float)
        d = points.shape[1]
        m = np.all(
            (points >= lo[:d]) & (points <= hi[:d]), axis=1
        )
    elif preset.get("qoi_type") == "sphere":
        c = np.asarray(preset["qoi_centre"], float)
        d = points.shape[1]
        m = ((points - c[:d]) ** 2).sum(axis=1) <= preset["qoi_radius"] ** 2
    else:
        return None
    w = m.astype(float)
    if w.sum() == 0:
        return None
    return jnp.asarray(w / w.sum())


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default=None,
                    help="JSON preset (examples/benchmark/*.json), the "
                    "analogue of the reference's .opts files")
    ap.add_argument("--mesh", default=None,
                    help="mesh asset name or path (models.mesh.mesh_path: "
                    "repo data/ first, reference mount as fallback)")
    ap.add_argument("--refine", type=int, default=0)
    ap.add_argument("--kappa", type=float, default=5.0)
    ap.add_argument("--burnin", type=int, default=1000)
    ap.add_argument("--samples", type=int, default=10000)
    ap.add_argument("--posterior", action="store_true")
    ap.add_argument("--sigma2", type=float, default=2.5e-3)
    ap.add_argument("--dtype", default="f64", choices=["f32", "f64"])
    ap.add_argument("--order", type=int, default=1, choices=[1, 2],
                    help="FE order (2 = CG2, the reference ex13 space)")
    ap.add_argument("--hierarchy", default="algebraic",
                    choices=["algebraic", "geometric"],
                    help="geometric needs --refine >= 1 and order 1")
    ap.add_argument("--anchor-ranks", type=int, default=0,
                    help="if > 0, measure the reference CSR SOR hot loop "
                    "on this matrix and report vs an N-rank model; pick "
                    "ranks ~ DOFs/4k (the reference's ex13 weak-scaling "
                    "grain), not 64 for tiny meshes")
    ap.add_argument("--chains", type=int, default=1,
                    help="vmapped independent chains (the production "
                    "configuration for launch-bound mesh problems: total "
                    "throughput = chains x per-chain rate)")
    args = ap.parse_args()

    preset = {}
    if not args.preset and args.mesh is None:
        args.mesh = "wrench"
    if args.preset:
        with open(args.preset) as f:
            preset = json.load(f)
        if args.mesh is None:  # explicit --mesh wins over the preset
            args.mesh = preset.get("mesh")
        args.kappa = float(preset.get("kappa", args.kappa))
        args.sigma2 = float(preset.get("sigma2", args.sigma2))
        if preset.get("posterior"):
            args.posterior = True

    obs = None
    if args.posterior:
        obs = dict(
            sigma2=args.sigma2,
            coords=preset.get(
                "obs_coords", [[0, 125, 0], [30, 35, 0], [-15, 100, 0]]
            ),
            radii=preset.get("obs_radii", [10.0, 10.0, 10.0]),
            values=preset.get("obs_values", [1.0, -1.0, 2.0]),
        )
    dtype = jnp.float64 if args.dtype == "f64" else jnp.float32
    ms = MaternMeshSampler(
        mesh_file=args.mesh,
        kappa=args.kappa,
        refinements=args.refine,
        dtype=dtype,
        observations=obs,
        coarsest_size=128,
        order=args.order,
        hierarchy=args.hierarchy,
    )
    print(f"DOFs: {ms.n}   levels: {ms.sampler.n_levels}")
    w = region_qoi(ms.points, preset) if preset else None
    if w is not None and w.shape[0] != ms.n:  # e.g. CG2 dof space
        w = None
    if w is not None:
        wd = w.astype(dtype)
        ms.set_qoi(lambda x, wd=wd: x @ wd)
        print(f"QOI: {preset['qoi_type']} region mean "
              f"({int((np.asarray(w) > 0).sum())} nodes)")
    else:
        ms.set_qoi(lambda x: jnp.mean(x))

    if args.chains > 1:
        # many chains: graph samplers run CHAIN-MAJOR (one (n, C) state,
        # every gather amortized over the chain axis); everything else
        # vmaps.
        t00 = time.perf_counter()

        def note(msg):
            print(f"[{time.perf_counter() - t00:7.1f}s] {msg}", flush=True)

        note("setup done; compiling burn-in program")
        ms.sample_chains(args.burnin, args.chains)  # burn-in + compile
        note("burn-in done")
        t0 = time.perf_counter()
        q = np.asarray(ms.sample_chains(args.samples, args.chains))
        wall = time.perf_counter() - t0
        note("sampling done")
        taus, valids = iact(q)
        tau = float(np.maximum(taus, 1.0).mean())
        valid = bool(np.all(valids))
        nrec = q.shape[1]
        tps = wall / (nrec * args.chains) * 1000
        print(f"chains: {args.chains} (chain-major)")
        print(f"Time per sample [ms, aggregate]: {tps:.4f}")
        print(f"IACT (mean over chains): {tau:.3f}"
              f"{'' if valid else ' (window short)'}")
        # tau transparency (bench.py's tau_sections analogue): the
        # chain-mean tau over three half-windows of the trace — the
        # single-window IACT estimate swings with the section at short
        # windows (docs/samplers.md), so a headline number is
        # only trustworthy when the sections agree
        m = q.shape[1]
        secs = []
        for lo, hi in ((0, m // 2), (m // 4, 3 * m // 4), (m // 2, m)):
            t_s, _ = iact(q[:, lo:hi])
            secs.append(round(float(np.maximum(t_s, 1.0).mean()), 3))
        print(f"tau_sections (half-windows, chain mean): {secs}")
        print(f"Time per independent sample [ms]: {tau * tps:.4f}")
    else:
        # burn-in
        ms.sample(args.burnin)

        t0 = time.perf_counter()
        q = np.asarray(ms.sample(args.samples))
        wall = time.perf_counter() - t0

        tau, valid = iact(q)
        tau = max(float(tau), 1.0)
        tps = wall / args.samples * 1000
        print(f"Time per sample [ms]: {tps:.4f}")
        print(f"IACT: {tau:.3f}{'' if valid else ' (window short)'}")
        m = q.shape[0]
        secs = []
        for lo, hi in ((0, m // 2), (m // 4, 3 * m // 4), (m // 2, m)):
            t_s, _ = iact(q[lo:hi])
            secs.append(round(max(float(t_s), 1.0), 3))
        print(f"tau_sections (half-windows): {secs}")
        print(f"Time per independent sample [ms]: {tau * tps:.4f}")

    if args.anchor_ranks > 0:
        from parmgmc_tpu.native import ref_sor_bench_csr

        base_op = ms.op  # GraphOperator (colour-blocked internal order)
        res = ref_sor_bench_csr(base_op.to_csr(), nsweeps=4)
        if res is None:
            print("anchor: no host toolchain available")
            return
        n, s_sweep, s_fill = res
        # Perfect-scaling model, generous to the reference (same
        # methodology as the structured anchor, BASELINE.md):
        # V(1,0)-equivalent cycle = (1 sweep + 1 residual + 0.25
        # transfer) per level, summed over the MEASURED level-size
        # ratios of this hierarchy; noise fill granted free (MKL);
        # coarse exact solve granted free; zero halo cost; matched IACT
        # (the tau term cancels in the ratio).
        import math

        sizes = [math.prod(o.grid_shape) for o in ms.sampler.ops]
        recursion = sum(s / sizes[0] for s in sizes[:-1])
        sec_cycle_1core = 2.25 * recursion * s_sweep
        anchor_sps = args.anchor_ranks / sec_cycle_1core
        ours_sps = 1000.0 / tps
        print(
            f"anchor: CSR SOR {n} DOFs, {s_sweep * 1e3:.2f} ms/sweep/core "
            f"({n / s_sweep / 1e6:.1f} MDOF/s), fill {s_fill * 1e3:.2f} ms"
        )
        print(
            f"anchor model ({args.anchor_ranks} ranks, perfect scaling): "
            f"{anchor_sps:.1f} samples/s; this run: {ours_sps:.1f} "
            f"samples/s -> vs_anchor {ours_sps / anchor_sps:.2f}x "
            f"(matched IACT)"
        )


if __name__ == "__main__":
    from parmgmc_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()
