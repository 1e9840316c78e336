"""Stochastic SOR / Gibbs sampler on stencil operators.

Rebuild of the reference's ``mcgibbs``/``sorgibbs`` preconditioner-samplers
(``/root/reference/src/pc_mcgibbs.c``, ``src/pc_sorgibbs.c``): one Gibbs
sweep targeting N(A^{-1}b, A^{-1}) is one SOR sweep applied to the
stochastic right-hand side

    b~ = b + sqrt((2-omega)/omega) * D^{1/2} eta,      eta ~ N(0, I)

(pc_mcgibbs.c:119-128, 142-153).  For low-rank-corrected operators
A_post = A + B Sigma^{-1} B^T the sweep runs on the *base* A with extra
RHS noise ``+ B sqrt(Sigma^{-1}) eta2`` (pc_mcgibbs.c:130-140) followed by
the Woodbury post-correction ``y <- y - Bb (B^T y)`` with
``Bb = M^{-1} B (Sigma + B^T M^{-1} B)^{-1}`` built from the sweep's own
deterministic iteration operator M (mc_sor.c:456-544, applied at
mc_sor.c:101-112).

Samplers are frozen pytrees.  ``step_with_noise(x, b, noises)`` is the
deterministic affine transition given explicit standard-normal draws —
this is what the exact distribution-invariance tests probe.  ``step``
threads a JAX PRNG key (the per-device threefry analogue of the
reference's seed^rank MKL streams, parmgmc.c:80-97).
"""

from __future__ import annotations

import functools
from typing import Union

import jax
import jax.numpy as jnp

from parmgmc_tpu._pytree import bcast_trailing as _bc
from parmgmc_tpu._pytree import pytree_dataclass
from parmgmc_tpu.operators.lrc import HIGHEST, LRCOperator
from parmgmc_tpu.operators.stencil import StencilOperator
from parmgmc_tpu.samplers.sor import sor_sweep

__all__ = ["GibbsSampler", "build_lrc_correction"]


def build_lrc_correction(
    base: StencilOperator, B: jax.Array, sigma_inv: jax.Array, omega: float, sweep: str
) -> jax.Array:
    """Bb = M^{-1} B (Sigma + B^T M^{-1} B)^{-1} for the given sweep direction.

    M^{-1} columns are computed by running the deterministic sweep from a
    zero initial guess on each column of B — batched with vmap instead of
    the reference's column-by-column loop (mc_sor.c:493-511).  The whole
    computation runs as ONE jitted program: callers are eager (sampler
    setup), and op-by-op dispatch compiles every small op of the colour
    sub-sweeps on its own (minutes per sweep on graph operators).
    """
    return _build_lrc_correction_jit(sweep)(base, B, sigma_inv, omega)


@functools.lru_cache(maxsize=None)
def _build_lrc_correction_jit(sweep: str):
    def run(base, B, sigma_inv, omega):
        d = len(B.shape) - 1
        k = B.shape[-1]

        def det_sor(col):  # one deterministic sweep from zero: M^{-1} col
            return _op_sweep(base, col, jnp.zeros_like(col), omega, sweep)

        cols = jnp.moveaxis(B, -1, 0)  # (k, *grid)
        C = jax.vmap(det_sor)(cols)  # (k, *grid) = columns of M^{-1} B
        axes = tuple(range(1, d + 1))
        BtC = jnp.tensordot(
            jnp.moveaxis(B, -1, 0), C, axes=(axes, axes), precision=HIGHEST
        )
        small = jnp.diag(1.0 / sigma_inv) + BtC  # Sigma + B^T M^{-1} B
        Sb = jnp.linalg.solve(small, jnp.eye(k, dtype=B.dtype))
        return jnp.tensordot(
            C, Sb, axes=((0,), (0,)), precision=HIGHEST
        )  # (*grid, k)

    return jax.jit(run)


def _op_sweep(base, b, x, omega, sweep):
    """Dispatch the multicolour SOR sweep to the operator's implementation
    (GraphOperator carries its own colour-blocked sweep; stencils use the
    parity-mask sweep)."""
    if hasattr(base, "sor_sweep"):
        return base.sor_sweep(b, x, omega, sweep)
    return sor_sweep(base, b, x, omega, sweep)


@pytree_dataclass(meta=("sweep",))
class GibbsSampler:
    """Multicolor SOR-Gibbs sampler for N(A^{-1}b, A^{-1}).

    Operates on ``StencilOperator``, ``GraphOperator`` or
    ``LRCOperator``.  The LRC fields (B, sigma_inv, Bb_fw, Bb_bw) are
    None for plain operators.
    """

    base: StencilOperator
    omega: jax.Array  # scalar
    sweep: str  # forward | backward | symmetric
    noise_scale: jax.Array  # sqrt((2-omega)/omega) * sqrt(diag A)
    B: Union[jax.Array, None]
    sqrt_sigma_inv: Union[jax.Array, None]
    Bb_fw: Union[jax.Array, None]
    Bb_bw: Union[jax.Array, None]
    # sparse views of the Woodbury factors Bb_fw/Bb_bw themselves: for
    # multicolour sweeps M^{-1} widens a ball by <= ncolors-1 stencil
    # rings, so the columns have EXACT compact support and the per-sweep
    # correction x -= Bb (B^T x) scatters into k small windows instead
    # of k full-grid passes (round 4; mc_sor.c:101-112 analogue)
    Bb_fw_pv: Union[jax.Array, None] = None
    Bb_fw_ps: Union[jax.Array, None] = None
    Bb_bw_pv: Union[jax.Array, None] = None
    Bb_bw_ps: Union[jax.Array, None] = None

    # -- construction ------------------------------------------------------
    @staticmethod
    def create(
        op, omega: float = 1.0, sweep: str = "forward"
    ) -> "GibbsSampler":
        assert sweep in ("forward", "backward", "symmetric")
        Bb_patches = {"fw": None, "bw": None}
        if isinstance(op, LRCOperator):
            from parmgmc_tpu.operators.lrc import column_patches

            base = op.base
            B, sigma_inv = op.B, op.sigma_inv
            # only build the factor(s) the sweep actually uses: each is
            # a dense (*grid, k) stack (2.7 GB at 512^3 k=5), and the
            # unused direction OOMed the 512^3 posterior setup (r5)
            Bb_fw = Bb_bw = None
            if sweep in ("forward", "symmetric"):
                Bb_fw = build_lrc_correction(
                    base, B, sigma_inv, omega, "forward"
                )
            if sweep in ("backward", "symmetric"):
                Bb_bw = build_lrc_correction(
                    base, B, sigma_inv, omega, "backward"
                )
            sqrt_sigma_inv = jnp.sqrt(sigma_inv)
            if op.patch_vals is not None and getattr(base, "ndim", 0) >= 2:
                # localized observations on a structured grid: the
                # Woodbury factors are exactly window-supported too
                if Bb_fw is not None:
                    Bb_patches["fw"] = column_patches(Bb_fw)
                if Bb_bw is not None:
                    Bb_patches["bw"] = column_patches(Bb_bw)
        else:
            base = op
            B = sqrt_sigma_inv = Bb_fw = Bb_bw = None
        om = jnp.asarray(omega, dtype=base.dtype)
        from parmgmc_tpu.operators.stencil import FDStencilOperator

        if isinstance(base, FDStencilOperator):
            # lazy FD operator: materializing sqrt(diag) here would
            # allocate the full grid (4.3 GB at 1024^3); the sweep
            # synthesizes it in-trace instead (see _half_step)
            noise_scale = None
        else:
            noise_scale = jnp.sqrt((2.0 - om) / om) * jnp.sqrt(base.diag)
        return GibbsSampler(
            base=base,
            omega=om,
            sweep=sweep,
            noise_scale=noise_scale,
            B=B,
            sqrt_sigma_inv=sqrt_sigma_inv,
            Bb_fw=Bb_fw,
            Bb_bw=Bb_bw,
            Bb_fw_pv=None if Bb_patches["fw"] is None else Bb_patches["fw"][0],
            Bb_fw_ps=None if Bb_patches["fw"] is None else Bb_patches["fw"][1],
            Bb_bw_pv=None if Bb_patches["bw"] is None else Bb_patches["bw"][0],
            Bb_bw_ps=None if Bb_patches["bw"] is None else Bb_patches["bw"][1],
        )

    def _bb_apply_sub(self, direction, x, c):
        """x - Bb_dir c — windowed when the factor's exact-support patch
        view exists (k small boxes), dense tensordot otherwise."""
        from parmgmc_tpu.operators.lrc import patch_apply_add

        pv, ps = (
            (self.Bb_fw_pv, self.Bb_fw_ps)
            if direction == "forward"
            else (self.Bb_bw_pv, self.Bb_bw_ps)
        )
        if pv is not None:
            return patch_apply_add(pv, ps, -c, x)
        Bb = self.Bb_fw if direction == "forward" else self.Bb_bw
        ndim = self.base.ndim
        return x - jnp.tensordot(
            Bb, c, axes=((ndim,), (0,)), precision=HIGHEST
        )

    @property
    def grid_shape(self):
        return self.base.grid_shape

    @property
    def dtype(self):
        return self.base.dtype

    @property
    def is_lrc(self) -> bool:
        return self.B is not None

    # -- noise bookkeeping ---------------------------------------------------
    def noise_shapes(self):
        """Pytree of standard-normal shapes consumed by one step."""
        halves = 2 if self.sweep == "symmetric" else 1
        per_half = {"eta": self.grid_shape}
        if self.is_lrc:
            per_half["eta_lr"] = (self.B.shape[-1],)
        return [dict(per_half) for _ in range(halves)]

    # -- transitions ---------------------------------------------------------
    def _half_step(self, x, b, noise, direction):
        # x (and the noises) may carry trailing chain dims beyond
        # grid_shape — the chain-major multichain layout; per-grid
        # constants broadcast via _bc.
        if b is None:  # zero-RHS (prior) convention
            b = jnp.zeros_like(x)
        eta = noise["eta"]
        ns = self.noise_scale
        if ns is None:  # lazy FD base: synthesize in-trace (fused away)
            ns = jnp.sqrt((2.0 - self.omega) / self.omega) * jnp.sqrt(
                self.base.diag
            )
        btilde = _bc(b, eta) + _bc(ns, eta) * eta
        if self.is_lrc:
            w = _bc(self.sqrt_sigma_inv, noise["eta_lr"]) * noise["eta_lr"]
            ndim = self.base.ndim
            btilde = btilde + jnp.tensordot(
                self.B, w, axes=((ndim,), (0,)), precision=HIGHEST
            )
        x = _op_sweep(self.base, btilde, x, self.omega, direction)
        if self.is_lrc:
            ndim = self.base.ndim
            axes = tuple(range(ndim))
            bty = jnp.tensordot(self.B, x, axes=(axes, axes), precision=HIGHEST)
            x = self._bb_apply_sub(direction, x, bty)
        return x

    def step_with_noise(self, x, b, noises):
        """One Gibbs iteration with explicit N(0,1) draws (deterministic)."""
        if self.sweep == "symmetric":
            x = self._half_step(x, b, noises[0], "forward")
            x = self._half_step(x, b, noises[1], "backward")
        else:
            x = self._half_step(x, b, noises[0], self.sweep)
        return x

    def prepare(self, b):
        return None

    def step(self, key, x, b, aux=None):
        key, sub = jax.random.split(key)
        batch = x.shape[len(self.grid_shape) :]
        noises = _draw(sub, self.noise_shapes(), x.dtype, batch)
        return key, self.step_with_noise(x, b, noises)


def _draw(key, shapes, dtype, batch=()):
    """Draw N(0,1) pytrees for the given shapes; ``batch`` appends the
    trailing chain dims of the multichain layout to every leaf (each
    chain column gets its own iid slice of a single keyed draw)."""
    leaves, treedef = jax.tree_util.tree_flatten(shapes, is_leaf=lambda s: isinstance(s, tuple))
    keys = jax.random.split(key, len(leaves))
    draws = [
        jax.random.normal(k, tuple(s) + tuple(batch), dtype=dtype)
        for k, s in zip(keys, leaves)
    ]
    return jax.tree_util.tree_unflatten(treedef, draws)
