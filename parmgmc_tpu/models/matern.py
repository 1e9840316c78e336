"""Matérn random-field sampler façade.

High-level driver mirroring the reference's MS object
(``/root/reference/src/ms.c``): given kappa and a grid, assemble the
Whittle-Matérn precision (kappa^2 - Laplace), set up an MGMC chain, and
expose sample / mean-variance recording / QOI streaming — the analogue
of MSSample / MSBeginSaveSamples / MSGetMeanAndVar / MSSetQOI
(ms.c:176-265, 361-378).  The reference discretises with P1 FEM on
DMPlex meshes; here the structured-grid FD discretisation plays that
role (unstructured meshes go through the algebraic-hierarchy path,
see parmgmc_tpu.operators).

Stateful by design (it is a user-facing convenience, not a pytree); all
device work still happens inside jitted scans.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp

from parmgmc_tpu.chain import init_chain, sample_chain, sample_moments
from parmgmc_tpu.operators.stencil import shifted_laplace_fd
from parmgmc_tpu.samplers.mgmc import MGMCSampler

__all__ = ["MaternSampler"]


class MaternSampler:
    """Sample Gaussian random fields with Matérn-type precision kappa^2 - Lap."""

    def __init__(
        self,
        grid_shape,
        kappa: float = 1.0,
        dtype=jnp.float32,
        seed: int = 0,
        sampler: Optional[object] = None,
        **mgmc_kwargs,
    ):
        self.grid_shape = tuple(grid_shape)
        self.kappa = float(kappa)
        self.op = shifted_laplace_fd(self.grid_shape, kappa, dtype=dtype)
        self.sampler = sampler or MGMCSampler.create(self.op, **mgmc_kwargs)
        self.state = init_chain(self.sampler, jax.random.PRNGKey(seed))
        self.b = jnp.zeros(self.grid_shape, dtype=dtype)  # zero-mean field
        self._qoi: Optional[Callable] = None
        self._runners = {}

    def set_qoi(self, fn: Callable):
        """QOI extractor applied to each sample (MSSetQOI, ms.c:361-378)."""
        self._qoi = fn
        self._runners = {}  # the extractor is baked into cached runners

    def _runner(self, kind: str, n: int, burnin: int):
        """Cached jitted chain runner.  Sampler/state/b are passed as jit
        ARGUMENTS: closing over them would embed the operator hierarchy
        (gigabytes at flagship sizes) in the program as constants."""
        key = (kind, n, burnin)
        if key not in self._runners:
            if kind == "chain":
                extract = self._qoi or (lambda x: x)
                self._runners[key] = jax.jit(
                    lambda smp, st, bb: sample_chain(
                        smp, st, bb, n, extract=extract, burnin=burnin
                    )
                )
            else:
                self._runners[key] = jax.jit(
                    lambda smp, st, bb: sample_moments(
                        smp, st, bb, n, burnin=burnin
                    )
                )
        return self._runners[key]

    def sample(self, n: int = 1, burnin: int = 0):
        """Advance the chain n steps; returns stacked QOI values (or samples)."""
        run = self._runner("chain", n, burnin)
        self.state, out = run(self.sampler, self.state, self.b)
        return out

    def sample_mean_and_var(self, n: int, burnin: int = 0):
        """Run n recording steps, returning (mean, var) fields
        (MSBeginSaveSamples/MSGetMeanAndVar semantics, ms.c:221-265)."""
        run = self._runner("moments", n, burnin)
        self.state, mean, var = run(self.sampler, self.state, self.b)
        return mean, var

    def sample_chains(self, n: int, n_chains: int, burnin: int = 0):
        """(n_chains, n, ...) QOI traces from vmapped independent chains.

        The reference runs chains serially (ex6/ex7); here a vmapped
        chain axis is nearly free whenever cycles are launch-bound.
        Chain states persist across calls per n_chains.
        """
        return _sample_chains(self, None, n, n_chains, burnin)


class MaternMeshSampler:
    """Matérn sampling on an unstructured mesh via the algebraic hierarchy.

    The full MS-on-DMPlex analogue (ms.c + ex13): Gmsh mesh (or given
    points/cells), optional uniform refinements, P1 assembly of
    kappa^2 M + K, smoothed-aggregation MGMC chain; optional
    ball-average observations turn it into a posterior sampler
    (LRC operator + per-level projected factors).

    All vectors exposed to the user are in the mesh's original node
    ordering; the colour-blocked internal ordering stays inside.
    """

    def __init__(
        self,
        mesh_file=None,
        points=None,
        cells=None,
        kappa: float = 1.0,
        refinements: int = 0,
        dtype=jnp.float64,
        seed: int = 0,
        observations=None,  # dict(sigma2=..., coords=..., radii=..., values=...)
        hierarchy: str = "algebraic",  # or "geometric" (needs refinements>0)
        order: int = 1,  # FE order: 1 = P1, 2 = CG2 (ex13's space)
        **mgmc_kwargs,
    ):
        from parmgmc_tpu.models import mesh as _mesh
        from parmgmc_tpu.operators.graph import from_csr
        from parmgmc_tpu.operators.lrc import LRCOperator

        if mesh_file is not None:
            points, cells = _mesh.read_gmsh(_mesh.mesh_path(mesh_file))
        Ps = []
        for _ in range(refinements):
            if hierarchy == "geometric":
                points, cells, P = _mesh.refine(points, cells, True)
                Ps.append(P)
            else:
                points, cells = _mesh.refine(points, cells)
        self.points, self.cells = points, cells
        if order == 2:
            if hierarchy == "geometric":
                raise ValueError(
                    "geometric hierarchy is P1-only; use algebraic for CG2"
                )
            A, self.dof_points = _mesh.matern_precision_mesh_p2(
                points, cells, kappa
            )
        else:
            A = _mesh.matern_precision_mesh(points, cells, kappa)
            self.dof_points = points
        self.op = from_csr(A, dtype=dtype)
        self.n = self.op.n

        f_int = jnp.zeros((self.n,), dtype=dtype)
        op = self.op
        if observations is not None:
            B, sigma_inv, f = _mesh.mesh_observation_mats(
                points,
                cells,
                observations["sigma2"],
                observations["coords"],
                observations["radii"],
                observations.get("values"),
                order=order,
            )
            B_int = jnp.asarray(B, dtype=dtype)[self.op.perm]
            op = LRCOperator(
                base=self.op,
                B=B_int,
                sigma_inv=jnp.asarray(sigma_inv, dtype=dtype),
            )
            if f is not None:
                f_int = jnp.asarray(f, dtype=dtype)[self.op.perm]
        self.operator = op
        self.b = f_int

        if hierarchy == "geometric":
            # the reference's geometric-MG-on-mesh configuration (ex9 /
            # assembled_transfer.py): exact Galerkin on the P1 refinement
            # chain; coarsest level = the unrefined input mesh
            if not Ps:
                raise ValueError("hierarchy='geometric' needs refinements>0")
            from parmgmc_tpu.samplers.cholesky import CholeskySampler
            from parmgmc_tpu.samplers.gibbs import GibbsSampler

            n_levels = mgmc_kwargs.pop("n_levels", None)
            if n_levels is not None:
                Ps = Ps[-(n_levels - 1) :] if n_levels > 1 else []
            mgmc_kwargs.pop("coarsest_size", None)
            omega = mgmc_kwargs.pop("omega", 1.0)
            sweep = mgmc_kwargs.pop("sweep", "forward")
            ops, transfers = _mesh.geometric_mgmc_hierarchy(
                op, Ps, dtype=dtype
            )
            self.sampler = MGMCSampler(
                ops=tuple(ops),
                transfers=transfers,
                smoothers=tuple(
                    GibbsSampler.create(o, omega=omega, sweep=sweep)
                    for o in ops[:-1]
                ),
                coarse=CholeskySampler.create(ops[-1]),
                n_pre=mgmc_kwargs.pop("n_pre", 1),
                n_post=mgmc_kwargs.pop("n_post", 1),
                n_levels=len(ops),
                n_coarse=mgmc_kwargs.pop("n_coarse", 1),
                gamma=mgmc_kwargs.pop("gamma", 1),
            )
        else:
            self.sampler = MGMCSampler.create(op, **mgmc_kwargs)
        self.state = init_chain(self.sampler, jax.random.PRNGKey(seed))
        self._qoi: Optional[Callable] = None
        self._runners = {}

    def set_qoi(self, fn: Callable):
        """QOI applied to samples in ORIGINAL node ordering."""
        self._qoi = fn
        self._runners = {}

    def _runner(self, kind: str, n: int, burnin: int):
        """Cached jitted runner with sampler/state/b as jit arguments
        (see MaternSampler._runner for why)."""
        key = (kind, n, burnin)
        if key not in self._runners:
            if kind == "chain":
                iperm = self.op.iperm
                user = self._qoi or (lambda x: x)
                extract = lambda x: user(x[iperm])
                self._runners[key] = jax.jit(
                    lambda smp, st, bb: sample_chain(
                        smp, st, bb, n, extract=extract, burnin=burnin
                    )
                )
            else:
                self._runners[key] = jax.jit(
                    lambda smp, st, bb: sample_moments(
                        smp, st, bb, n, burnin=burnin
                    )
                )
        return self._runners[key]

    def sample(self, n: int = 1, burnin: int = 0):
        run = self._runner("chain", n, burnin)
        self.state, out = run(self.sampler, self.state, self.b)
        return out

    def sample_mean_and_var(self, n: int, burnin: int = 0):
        run = self._runner("moments", n, burnin)
        self.state, mean, var = run(self.sampler, self.state, self.b)
        return mean[self.op.iperm], var[self.op.iperm]

    def sample_chains(self, n: int, n_chains: int, burnin: int = 0):
        """(n_chains, n, ...) QOI traces (original node ordering) from
        vmapped independent chains — see MaternSampler.sample_chains."""
        return _sample_chains(self, self.op.iperm, n, n_chains, burnin)


def _batched_chains_supported(sampler) -> bool:
    """Does the sampler accept the chain-major multichain layout (x of
    shape (n, C), one keyed step advances C independent chains)?

    True for Gibbs/MGMC stacks over GraphOperator (possibly LRC)
    bases — the unstructured-mesh configuration, where chain-major row
    gathers move contiguous C-wide rows (operators.graph)."""
    from parmgmc_tpu.operators.graph import GraphOperator
    from parmgmc_tpu.operators.lrc import LRCOperator
    from parmgmc_tpu.samplers.cholesky import CholeskySampler
    from parmgmc_tpu.samplers.gibbs import GibbsSampler
    from parmgmc_tpu.samplers.mgmc import MGMCSampler

    def graph_gibbs(s):
        return isinstance(s, GibbsSampler) and isinstance(
            s.base, GraphOperator
        )

    if isinstance(sampler, GibbsSampler):
        return graph_gibbs(sampler)
    if isinstance(sampler, MGMCSampler):
        op0 = sampler.fine_op
        base0 = op0.base if isinstance(op0, LRCOperator) else op0
        return (
            isinstance(base0, GraphOperator)
            and all(graph_gibbs(s) for s in sampler.smoothers)
            and isinstance(sampler.coarse, CholeskySampler)
        )
    return False


def _sample_chains(ms, iperm, n, n_chains, burnin):
    """Shared many-chains driver for the Matérn façades.  Chain states
    are created once per n_chains (keys forked from the main chain's
    key) and persist on the façade for continuation; the jitted runner
    takes sampler/states/b as ARGUMENTS (no closure constants).

    Two layouts: unstructured (GraphOperator) samplers run CHAIN-MAJOR
    — one state x of shape (n, n_chains), one key, every gather
    amortized over the chain axis — and everything else vmaps a leading chain axis (the reference runs
    chains serially, ex6/ex7)."""
    user = ms._qoi or (lambda x: x)
    per = user if iperm is None else (lambda x: user(x[iperm]))
    batched = _batched_chains_supported(ms.sampler)
    rkey = ("mchains" if batched else "chains", n, n_chains, burnin)
    if not hasattr(ms, "_chain_states"):
        ms._chain_states = {}
    skey = ("m", n_chains) if batched else n_chains
    if rkey not in ms._runners:
        if batched:
            # permute ONCE chain-major (one contiguous row gather),
            # then vmap only the user's QOI over the chain axis, not a
            # per-column x[iperm]
            if iperm is None:
                extract = lambda x: jax.vmap(user, in_axes=-1)(x)
            else:
                extract = lambda x: jax.vmap(user, in_axes=-1)(x[iperm])
            ms._runners[rkey] = jax.jit(
                lambda smp, st, bb: sample_chain(
                    smp, st, bb, n, extract=extract, burnin=burnin
                )
            )
        else:
            ms._runners[rkey] = jax.jit(
                lambda smp, sts, bb: jax.vmap(
                    lambda st: sample_chain(
                        smp, st, bb, n, extract=per, burnin=burnin
                    )
                )(sts)
            )
    if skey not in ms._chain_states:
        if batched:
            ms._chain_states[skey] = init_chain(
                ms.sampler,
                jax.random.fold_in(ms.state.key, n_chains),
                batch=(n_chains,),
            )
        else:
            keys = jax.random.split(
                jax.random.fold_in(ms.state.key, n_chains), n_chains
            )
            ms._chain_states[skey] = jax.vmap(
                lambda k: init_chain(ms.sampler, k)
            )(keys)
    sts, out = ms._runners[rkey](ms.sampler, ms._chain_states[skey], ms.b)
    ms._chain_states[skey] = sts
    if batched:
        # (n_steps, C, ...) -> (C, n_steps, ...): match the vmap layout
        out = jax.tree_util.tree_map(lambda a: jnp.swapaxes(a, 0, 1), out)
    return out
