"""Measure the CPU reference baseline that anchors bench.py's vs_baseline.

Runs the faithful single-core re-implementation of the reference's CSR
red/black SOR hot loop (parmgmc_tpu/native/ref_sor_bench.cpp; semantics
of /root/reference/src/mc_sor.c:241-296) plus the std-normal fill
(src/parmgmc.c:70-116 fallback path), then derives the 64-rank MPI
baseline ESS/sec under a perfect-scaling model that is deliberately
generous to the reference:

  * 64 ranks x measured per-core sweep rate, zero halo/latency cost,
  * RNG fill free (the reference's MKL ICDF path is much faster than
    the Box-Muller fallback timed here),
  * V(1,0) MGMC cycle = 2.57 fine-sweep-equivalents of traffic
    (sweep 1.0 + residual matvec 1.0 + transfers 0.25, x 1.143 for the
    coarser-level recursion sum(1/8^l)),
  * matched IACT tau = 1.07 (the rebuild's own measured tau).

Usage: python examples/baseline_cpu_reference.py [edge=128]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from parmgmc_tpu.native import ref_sor_bench

N_FINE = 256  # the flagship grid the baseline is quoted for
CYCLE_SWEEP_EQUIV = 2.57
TAU = 1.07
RANKS = 64


def main():
    edge = int(sys.argv[1]) if len(sys.argv) > 1 else 128
    res = ref_sor_bench(edge, nsweeps=6)
    if res is None:
        print("no C++ toolchain available; cannot measure")
        return
    ndof, sec_sweep, sec_fill = res
    rate = ndof / sec_sweep
    print(f"grid {edge}^3 = {ndof} DOF (f64 CSR, one core)")
    print(f"  SOR sweep : {sec_sweep * 1e3:8.2f} ms  ({rate / 1e6:6.1f} MDOF/s,"
          f" ~{rate * 100 / 1e9:.1f} GB/s at ~100 B/DOF)")
    print(f"  N(0,1) fill: {sec_fill * 1e3:8.2f} ms  "
          f"({ndof / sec_fill / 1e6:6.1f} MDOF/s, Box-Muller fallback)")

    n_flag = N_FINE**3
    cycles_per_sec = RANKS * rate / (n_flag * CYCLE_SWEEP_EQUIV)
    ess = cycles_per_sec / TAU
    print(f"\n64-rank perfect-scaling model on {N_FINE}^3:")
    print(f"  {cycles_per_sec:6.1f} V(1,0)-cycles/s  ->  {ess:6.1f} ESS/sec "
          f"(tau={TAU})")
    print("bench.py BASELINE_ESS_PER_SEC rounds this up in the reference's "
          "favour (see BASELINE.md).")


if __name__ == "__main__":
    main()
