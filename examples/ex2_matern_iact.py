"""ex2 analogue: Matérn field sampling with QOI stream, IACT, VTK dump.

Reference: /root/reference/examples/ex2.c — MS end-to-end with a
normalized domain-integral QOI, IACT print, mean ~ 0 check and VTK
output of samples/mean/var.

    python examples/ex2_matern_iact.py [--mesh wrench]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp
import numpy as np

from parmgmc_tpu.diagnostics.iact import iact
from parmgmc_tpu.io import write_vtk_structured, write_vtk_unstructured
from parmgmc_tpu.models.matern import MaternMeshSampler, MaternSampler


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default=None, help="Gmsh file (else 33x33 grid)")
    ap.add_argument("--samples", type=int, default=20_000)
    ap.add_argument("--kappa", type=float, default=1.0)
    ap.add_argument("--vtk", default=None, help="output .vtk path")
    args = ap.parse_args()

    if args.mesh:
        ms = MaternMeshSampler(mesh_file=args.mesh, kappa=args.kappa)
    else:
        ms = MaternSampler((33, 33), kappa=args.kappa, dtype=jnp.float64)
    ms.set_qoi(lambda x: jnp.mean(x))

    q = np.asarray(ms.sample(args.samples, burnin=200))
    tau, valid = iact(q)
    print(f"QOI mean: {q.mean():+.5f} (expect ~0)")
    print(f"IACT: {tau:.3f} (valid: {valid})")
    assert abs(q.mean()) < 0.05

    mean, var = ms.sample_mean_and_var(5_000)
    if args.vtk:
        if args.mesh:
            write_vtk_unstructured(
                args.vtk, ms.points, ms.cells, {"mean": mean, "var": var}
            )
        else:
            write_vtk_structured(args.vtk, {"mean": mean, "var": var})
        print(f"wrote {args.vtk}")


if __name__ == "__main__":
    from parmgmc_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()
