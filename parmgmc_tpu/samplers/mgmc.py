"""Multigrid Monte Carlo (MGMC) sampler.

Rebuild of the reference's ``gamgmc`` PC (``/root/reference/src/
pc_gamgmc.c``): a stochastic V-cycle whose level "smoothers" are Gibbs
samplers and whose coarsest solve is an exact Cholesky sampler, driven
as a state-carrying chain

    y <- y + M_mg(b - A y)

(pc_gamgmc.c:242-259, including the zero-guess shortcut and the
"don't re-apply the cycle to raw b" bias note at :248-253).

Differences from the reference, by design choice:

* The hierarchy is geometric-on-structured-grids with the Galerkin
  triple product computed in closed form as a strided convolution
  (stencil.galerkin_coarse_operator) — replacing PETSc PCMG/PCGAMG +
  sparse MatPtAP.  Coarse grids shrink by 2 per dim until
  ``coarsest_size`` DOFs remain.
* Low-rank-corrected operators get per-level projected factors
  B_c = P^T B_f (reference: MatTransposeMatMult(Ip, Bf) at
  pc_gamgmc.c:157-176) so every level samples the consistent
  A_c + B_c Sigma^{-1} B_c^T, and the residual operators use the LRC
  matrices too (the bias fix documented at pc_gamgmc.c:186-194).
* The whole V-cycle is one fused jitted program; the recursion over
  levels is unrolled at trace time (static level count).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from parmgmc_tpu._pytree import bcast_trailing as _bc
from parmgmc_tpu._pytree import pytree_dataclass
from parmgmc_tpu.operators.lrc import LRCOperator
from parmgmc_tpu.operators.stencil import (
    StencilOperator,
    coarse_shape,
    compress_stencil,
    detect_fd_params,
    fd_stencil,
    galerkin_coarse_operator,
)
from parmgmc_tpu.operators.transfer import AggregateTransfer, GeometricTransfer
from parmgmc_tpu.samplers.cholesky import CholeskySampler
from parmgmc_tpu.samplers.gibbs import GibbsSampler, _draw

__all__ = ["MGMCSampler", "build_hierarchy"]


def build_hierarchy(op, n_levels=None, coarsest_size=128, coarsening="linear"):
    """(ops, transfers): per-level operators via Galerkin coarsening.

    For LRC operators the base stencil is coarsened by the triple product
    and the low-rank factor by column-wise restriction (B_c = P^T B_f).
    Unstructured operators (GraphOperator) get an algebraic hierarchy via
    smoothed aggregation (operators.aggregation).
    """
    is_lrc = isinstance(op, LRCOperator)
    base0 = op.base if is_lrc else op
    if not isinstance(base0, StencilOperator):
        from parmgmc_tpu.operators.aggregation import aggregation_hierarchy

        return aggregation_hierarchy(
            op, n_levels=n_levels, coarsest_size=coarsest_size
        )

    ops = [op]
    transfers = []
    while True:
        cur = ops[-1]
        base = cur.base if is_lrc else cur
        gshape = base.grid_shape
        if n_levels is not None and len(ops) >= n_levels:
            break
        if n_levels is None and math.prod(coarse_shape(gshape)) < coarsest_size:
            break
        if any(s <= 2 for s in gshape):
            break
        if coarsening == "aggregate":
            tr = AggregateTransfer(fine_shape=tuple(gshape))
        else:
            tr = GeometricTransfer(fine_shape=tuple(gshape))
        fd = (
            detect_fd_params(base)
            if coarsening == "aggregate"
            and all(s % 2 == 0 for s in gshape)
            else None
        )
        if fd is not None:
            # Closed-form aggregate Galerkin: P^T A P of a link-count FD
            # operator under 2^d block-sum aggregation is again link-count
            # FD with kappa2' = 2^d kappa2, hinv2' = 2^(d-1) hinv2 (the
            # 2^d block absorbs its internal edges into the mass term and
            # each coarse face carries 2^(d-1) fine edges).  Equal to the
            # comb-probed P^T A P exactly (tests), but O(1) setup — the
            # probe path materialises 4^d comb responses plus gather
            # indices, gigabytes at the 384^3 level.
            d = base.ndim
            k2, h2 = float(fd[0]), float(fd[1])
            from parmgmc_tpu.operators.stencil import FDStencilOperator

            coarse_base = fd_stencil(
                coarse_shape(gshape),
                (2**d) * k2,
                (2 ** (d - 1)) * h2,
                dtype=base.dtype,
                # a lazy fine level keeps its whole hierarchy lazy (the
                # 512^3 level under a 1024^3 run is another 1.1 GB of
                # dead diag+noise_scale otherwise)
                lazy=True if isinstance(base, FDStencilOperator) else "auto",
            )
        else:
            coarse_base = compress_stencil(galerkin_coarse_operator(base, tr))
        transfers.append(tr)
        if is_lrc:
            from parmgmc_tpu.operators.lrc import with_patches

            ndim = base.ndim
            cols = jnp.moveaxis(cur.B, -1, 0)
            Bc = jnp.moveaxis(jax.vmap(tr.restrict)(cols), 0, ndim)
            # restricted ball columns stay localized: keep the sparse
            # patch view so coarse-level rank-k products stay cheap
            ops.append(
                with_patches(
                    LRCOperator(base=coarse_base, B=Bc, sigma_inv=cur.sigma_inv)
                )
            )
        else:
            ops.append(coarse_base)
    return ops, tuple(transfers)


@pytree_dataclass(meta=("n_pre", "n_post", "n_levels", "n_coarse", "gamma"))
class MGMCSampler:
    """Stochastic V/W(n_pre, n_post)-cycle chain sampler for N(A^{-1}b, A^{-1}).

    gamma=1 gives V-cycles; gamma=2 W-cycles (the coarse correction is a
    gamma-step chain of the coarse-level sampler, which preserves the
    coarse target exactly, so invariance carries over for any gamma).
    """

    ops: tuple  # per-level operators, fine -> coarse
    transfers: tuple  # transfer (P / P^T) per non-coarsest level
    smoothers: tuple  # GibbsSampler per non-coarsest level
    coarse: object  # coarsest-level sampler (Cholesky exact, or iterated Gibbs)
    n_pre: int
    n_post: int
    n_levels: int
    n_coarse: int = 1  # iterations of the coarse sampler per cycle
    gamma: int = 1  # cycle index: 1 = V, 2 = W

    @staticmethod
    def create(
        op,
        n_levels=None,
        coarsest_size: int = 128,
        omega: float = 1.0,
        sweep: str = "forward",
        n_pre: int = 1,
        n_post: int = 1,
        coarse_sampler=None,
        n_coarse: int = 1,
        coarsening: str = "linear",
        gamma: int = 1,
    ) -> "MGMCSampler":
        ops, transfers = build_hierarchy(
            op,
            n_levels=n_levels,
            coarsest_size=coarsest_size,
            coarsening=coarsening,
        )
        smoothers = tuple(
            GibbsSampler.create(o, omega=omega, sweep=sweep)
            for o in ops[:-1]
        )
        if coarse_sampler is None:
            coarse_sampler = CholeskySampler.create(ops[-1])
        return MGMCSampler(
            ops=tuple(ops),
            transfers=transfers,
            smoothers=smoothers,
            coarse=coarse_sampler,
            n_pre=n_pre,
            n_post=n_post,
            n_levels=len(ops),
            n_coarse=n_coarse,
            gamma=gamma,
        )

    # -- properties ---------------------------------------------------------
    @property
    def fine_op(self):
        return self.ops[0]

    @property
    def grid_shape(self):
        return self.fine_op.grid_shape

    @property
    def base(self):
        # dtype/shape carrier for chain init
        o = self.fine_op
        return o.base if isinstance(o, LRCOperator) else o

    @property
    def dtype(self):
        return self.base.dtype

    # -- noise bookkeeping ----------------------------------------------------
    def noise_shapes(self):
        def level(l):
            if l == self.n_levels - 1:
                return [self.coarse.noise_shapes() for _ in range(self.n_coarse)]
            s = self.smoothers[l]
            return {
                "pre": [s.noise_shapes() for _ in range(self.n_pre)],
                "sub": [level(l + 1) for _ in range(self.gamma)],
                "post": [s.noise_shapes() for _ in range(self.n_post)],
            }

        return level(0)

    # -- transition -----------------------------------------------------------
    def _cycle(self, l: int, bl, noises):
        """One stochastic V-cycle at level l from zero initial guess."""
        if l == self.n_levels - 1:
            x = jnp.zeros_like(bl)
            for i in range(self.n_coarse):
                x = self.coarse.step_with_noise(x, bl, noises[i])
            return x
        op = self.ops[l]
        smoother = self.smoothers[l]
        x = jnp.zeros_like(bl)
        for i in range(self.n_pre):
            x = smoother.step_with_noise(x, bl, noises["pre"][i])
        r = self.transfers[l].restrict(bl - op.apply(x))
        xc = self._cycle(l + 1, r, noises["sub"][0])
        for g in range(1, self.gamma):  # W-cycle: iterate the coarse chain
            rc = r - self.ops[l + 1].apply(xc)
            xc = xc + self._cycle(l + 1, rc, noises["sub"][g])
        x = x + self.transfers[l].prolong(xc)
        for i in range(self.n_post):
            x = smoother.step_with_noise(x, bl, noises["post"][i])
        return x

    def step_with_noise(self, x, b, noises):
        """y <- y + M_mg(b - A y) — the state-carrying Richardson update.

        ``b=None`` means a zero RHS (prior sampling): equivalent to
        passing explicit zeros.  ``x`` may carry trailing chain dims
        (the chain-major multichain layout; the noises must then carry
        them too — :func:`gibbs._draw` with ``batch``)."""
        if b is None:
            b = jnp.zeros_like(x)
        r = _bc(b, x) - self.fine_op.apply(x)
        return x + self._cycle(0, r, noises)

    # -- keyed cycle (FMG cold start) ---------------------------------------
    def _cycle_keyed(self, l: int, bl, key):
        if l == self.n_levels - 1:
            x = jnp.zeros_like(bl)
            for i in range(self.n_coarse):
                key, x = self.coarse.step(key, x, bl)
            return x
        op = self.ops[l]
        smoother = self.smoothers[l]
        x = jnp.zeros_like(bl)
        for i in range(self.n_pre):
            key, x = smoother.step(key, x, bl)
        key, sub = jax.random.split(key)
        r = self.transfers[l].restrict(bl - op.apply(x))
        xc = self._cycle_keyed(l + 1, r, sub)
        for g in range(1, self.gamma):
            key, sub = jax.random.split(key)
            rc = r - self.ops[l + 1].apply(xc)
            xc = xc + self._cycle_keyed(l + 1, rc, sub)
        x = x + self.transfers[l].prolong(xc)
        for i in range(self.n_post):
            key, x = smoother.step(key, x, bl)
        return x

    def fmg_init(self, key, b, n_cycles: int = 1):
        """(key, x0): full-multigrid (FMG) cold start.

        The classic FMG schedule applied to sampling: draw the COARSEST
        level from its exact stationary distribution, then prolong and
        run ``n_cycles`` stochastic cycle-chain steps at each finer
        level against the restricted RHS.  Because each level's chain
        starts from (an interpolant of) its coarse stationary draw, the
        returned fine-level state is approximately stationary already —
        chains started from it need essentially no burn-in (tested
        statistically).  Completes the cycle-type family (V via
        gamma=1, W via gamma=2, FMG here); the reference exposes PCMG's
        cycle options but no FMG *start* (pc_gamgmc.c settles for
        ``-pc_mg_cycle_type``), so this exceeds parity.
        """
        bs = [jnp.zeros(self.grid_shape, self.dtype) if b is None else b]
        for l in range(self.n_levels - 1):
            bs.append(self.transfers[l].restrict(bs[-1]))
        x = jnp.zeros_like(bs[-1])
        for _ in range(max(self.n_coarse, 1)):
            key, x = self.coarse.step(key, x, bs[-1])
        for l in reversed(range(self.n_levels - 1)):
            x = self.transfers[l].prolong(x)
            for _ in range(n_cycles):
                key, sub = jax.random.split(key)
                r = bs[l] - self.ops[l].apply(x)
                x = x + self._cycle_keyed(l, r, sub)
        return key, x

    def prepare(self, b):
        return None

    def step(self, key, x, b, aux=None):
        """One chain step.  ``b=None`` declares a zero RHS (prior
        sampling), the same as passing ``jnp.zeros_like(x)``."""
        key, sub = jax.random.split(key)
        batch = x.shape[len(self.grid_shape) :]
        noises = _draw(sub, self.noise_shapes(), x.dtype, batch)
        return key, self.step_with_noise(x, b, noises)
