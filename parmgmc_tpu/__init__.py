"""parmgmc_tpu — Multigrid Monte Carlo sampling of Gaussians in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of ParMGMC
(https://github.com/nilsfriess/ParMGMC): samplers for high-dimensional
Gaussian distributions N(A^{-1} f, A^{-1}) with sparse SPD precision
operators, including Gibbs/SOR samplers, exact Cholesky samplers,
Multigrid Monte Carlo, and low-rank-updated posteriors for Bayesian
linear inverse problems — designed for GPU device meshes via
``shard_map``/``jit`` sharding rather than MPI domain decomposition.
"""

__version__ = "0.1.0"

from parmgmc_tpu import chain, diagnostics, io, models, operators, parallel, profiling, samplers, solvers, testing  # noqa: E402,F401
from parmgmc_tpu.chain import ChainState, init_chain, sample_chain, sample_moments  # noqa: E402,F401
from parmgmc_tpu.operators.lrc import LRCOperator  # noqa: E402,F401
from parmgmc_tpu.operators.stencil import StencilOperator, shifted_laplace_fd  # noqa: E402,F401
from parmgmc_tpu.operators.graph import GraphOperator, from_csr  # noqa: E402,F401
from parmgmc_tpu.samplers.cholesky import (  # noqa: E402,F401
    CholeskySampler,
    SparseCholeskySampler,
    exact_sampler,
)
from parmgmc_tpu.samplers.gibbs import GibbsSampler  # noqa: E402,F401
from parmgmc_tpu.samplers.mgmc import MGMCSampler  # noqa: E402,F401
from parmgmc_tpu.samplers.woodbury import WoodburySampler  # noqa: E402,F401
from parmgmc_tpu.samplers.patch_gibbs import (  # noqa: E402,F401
    GraphPatchGibbsSampler,
    PatchGibbsSampler,
)
from parmgmc_tpu.samplers.sor import NaturalGibbsSampler  # noqa: E402,F401
from parmgmc_tpu.samplers.registry import build_sampler  # noqa: E402,F401
from parmgmc_tpu.describe import describe  # noqa: E402,F401
