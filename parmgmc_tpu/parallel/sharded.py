"""Explicit shard_map sweeps with manual halo exchange.

Two sharded sweep formulations over a device mesh, complementing the
GSPMD-automatic path (parallel.mesh):

* ``halo_mode="exact"`` — halos are re-exchanged before every colour
  sub-sweep (one ppermute pair per sharded axis per colour), giving the
  *same* multicolour Gauss-Seidel operator as a single device: the
  hand-written analogue of the reference's per-colour VecScatter ghost
  gathers (mc_sor.c:316-341).
* ``halo_mode="frozen"`` — halos are exchanged ONCE per sweep and held
  fixed; each shard runs its full local sweep against stale neighbour
  values.  This is the reference's intentionally-inexact "Hogwild"
  local-forward mode (``-pc_sorgibbs_local_forward``,
  pc_sorgibbs.c:264-278): block Gauss-Seidel within a shard, Jacobi
  across shards.  Cheaper per sweep (one exchange instead of one per
  colour) at the price of a slightly different iteration operator —
  the stationary distribution is exact on one device and approximate
  across shards, exactly like the reference's variant.

Restricted to radius-1 star stencils with scalar off-diagonal
coefficients (the FD family), sharded along the first grid axis.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from parmgmc_tpu.operators.stencil import StencilOperator

__all__ = ["sharded_gibbs_sweep", "make_sharded_gibbs_step"]


def _exchange_halos(x_loc, axis_name):
    """(lo_plane, hi_plane) received from the neighbours along axis 0 of
    the local block; devices at the chain ends receive zeros (the global
    zero-padding boundary condition)."""
    n_dev = jax.lax.axis_size(axis_name)
    fwd = [(i, i + 1) for i in range(n_dev - 1)]
    bwd = [(i + 1, i) for i in range(n_dev - 1)]
    # plane sent forward becomes my lo halo; plane sent backward my hi halo
    lo = jax.lax.ppermute(x_loc[-1:], axis_name, fwd)
    hi = jax.lax.ppermute(x_loc[:1], axis_name, bwd)
    return lo, hi


def _local_color_update(x_loc, lo, hi, b_loc, d_loc, coeffs, omega, mask):
    """Masked SOR update of one colour on the local block (+frozen halos)."""
    xp = jnp.concatenate([lo, x_loc, hi], axis=0)
    n0 = x_loc.shape[0]
    up = xp[0:n0]
    dn = xp[2 : 2 + n0]

    def shift(a, axis, by):
        pads = [(0, 0)] * a.ndim
        pads[axis] = (max(0, -by), max(0, by))
        ap = jnp.pad(a, pads)
        sl = [slice(None)] * a.ndim
        sl[axis] = slice(max(0, by), max(0, by) + a.shape[axis])
        return ap[tuple(sl)]

    sumn = coeffs[0] * up + coeffs[1] * dn
    for ax in range(1, x_loc.ndim):
        sumn = sumn + coeffs[2 * ax] * shift(x_loc, ax, -1)
        sumn = sumn + coeffs[2 * ax + 1] * shift(x_loc, ax, 1)
    upd = (1.0 - omega) * x_loc + (omega / d_loc) * (b_loc - sumn)
    return jnp.where(mask, upd, x_loc)


def sharded_gibbs_sweep(
    x_loc,
    b_loc,
    d_loc,
    coeffs,
    omega,
    axis_name: str,
    sweep: str = "forward",
    halo_mode: str = "exact",
):
    """One sweep on the local block inside shard_map (see module doc)."""
    assert sweep in ("forward", "backward"), sweep
    n0 = x_loc.shape[0]
    dev = jax.lax.axis_index(axis_name)
    row0 = dev * n0  # global index of the local first row
    idx = row0 + jax.lax.broadcasted_iota(jnp.int32, x_loc.shape, 0)
    for ax in range(1, x_loc.ndim):
        idx = idx + jax.lax.broadcasted_iota(jnp.int32, x_loc.shape, ax)
    parity = idx % 2

    colors = (0, 1) if sweep == "forward" else (1, 0)
    if halo_mode == "frozen":
        lo, hi = _exchange_halos(x_loc, axis_name)
        for c in colors:
            x_loc = _local_color_update(
                x_loc, lo, hi, b_loc, d_loc, coeffs, omega, parity == c
            )
    else:
        for c in colors:
            lo, hi = _exchange_halos(x_loc, axis_name)
            x_loc = _local_color_update(
                x_loc, lo, hi, b_loc, d_loc, coeffs, omega, parity == c
            )
    return x_loc


def make_sharded_gibbs_step(
    op: StencilOperator,
    mesh: Mesh,
    omega: float = 1.0,
    sweep: str = "forward",
    halo_mode: str = "exact",
    axis_name: str = "x",
):
    """(step_fn, sharding) — a jitted Gibbs chain step over the mesh.

    step_fn(key, x, b) -> (key, x'), with x/b sharded along grid axis 0.
    The stochastic RHS noise is drawn outside shard_map (sharded by the
    same spec) so both halo modes target the documented distributions.
    """
    assert op.is_star() and op.radius == 1
    assert all(getattr(c, "ndim", 1) == 0 for c in op.coeffs)
    d = op.ndim
    order = [(-1, 0, 0)[:d], (1, 0, 0)[:d]]
    for ax in range(1, d):
        for s in (-1, 1):
            off = [0] * d
            off[ax] = s
            order.append(tuple(off))
    cmap = dict(zip(op.offsets, op.coeffs))
    coeffs = jnp.stack([cmap[tuple(o)] for o in order]).astype(op.dtype)

    assert sweep in ("forward", "backward", "symmetric")
    spec = P(axis_name, *([None] * (d - 1)))
    sharding = NamedSharding(mesh, spec)
    noise_scale = jnp.sqrt((2.0 - omega) / omega) * jnp.sqrt(op.diag)

    halves = ("forward", "backward") if sweep == "symmetric" else (sweep,)
    sweeps_sharded = tuple(
        jax.shard_map(
            functools.partial(
                sharded_gibbs_sweep,
                omega=omega,
                axis_name=axis_name,
                sweep=h,
                halo_mode=halo_mode,
            ),
            mesh=mesh,
            in_specs=(spec, spec, spec, P()),
            out_specs=spec,
        )
        for h in halves
    )

    # Grid-shaped operator fields (diag, noise scale) enter the jitted
    # step as ARGUMENTS — closed-over they would be embedded in the
    # program as constants.
    @jax.jit
    def _step(key, x, b, diag, nscale):
        for sw in sweeps_sharded:  # fresh noise per half-sweep
            key, sub = jax.random.split(key)
            eta = jax.random.normal(sub, x.shape, dtype=x.dtype)
            x = sw(x, b + nscale * eta, diag, coeffs)
        return key, x

    def step(key, x, b):
        return _step(key, x, b, op.diag, noise_scale)

    return step, sharding
