"""Observation operators for Bayesian linear inverse problems.

Rebuild of ``/root/reference/src/obs.c`` (MakeObservationMats) on
structured grids: observation i is the local average of the field over a
ball of radius r_i around centre c_i,

    column B[:, i] = M * (1_{ball_i} / vol(ball_i))         (obs.c:37-49)

with M the mass matrix.  On a uniform structured grid we use the lumped
mass h^d (trapezoid-consistent boundary weights h^d / 2^{#boundary
axes}), evaluated at grid nodes in [0, 1]^d.  Returns the pieces the
samplers consume:

    B (n x nobs, grid-shaped), S = Sigma^{-1} = (1/sigma2) * ones,
    f = B @ (S * y_obs)                                      (obs.c:150-170)

so that an LRCOperator(base, B, S) + RHS f targets the posterior.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from parmgmc_tpu.operators.lrc import LRCOperator

__all__ = ["make_observation_mats", "grid_coordinates", "lumped_mass"]


def grid_coordinates(grid_shape) -> np.ndarray:
    """Node coordinates in [0,1]^d, shape (*grid, d)."""
    axes = [np.linspace(0.0, 1.0, s) for s in grid_shape]
    mesh = np.meshgrid(*axes, indexing="ij")
    return np.stack(mesh, axis=-1)


def lumped_mass(grid_shape) -> np.ndarray:
    """Diagonal (lumped) mass weights of the uniform grid, shape (*grid,)."""
    d = len(grid_shape)
    w = np.ones(grid_shape)
    for axis, s in enumerate(grid_shape):
        h = 1.0 / (s - 1)
        axis_w = np.full(s, h)
        axis_w[0] = axis_w[-1] = h / 2
        shape = [1] * d
        shape[axis] = s
        w = w * axis_w.reshape(shape)
    return w


def _ball_volume(d: int, r: float) -> float:
    if d == 2:
        return math.pi * r * r
    if d == 3:
        return 4.0 * math.pi / 3.0 * r**3
    raise ValueError("only d=2,3 supported (obs.c:VolumeOfSphere)")


def make_observation_mats(
    grid_shape,
    sigma2: float,
    coords,
    radii,
    obsvals=None,
    dtype=jnp.float64,
):
    """Build (B, sigma_inv, f) for ball-average observations.

    Parameters mirror MakeObservationMats (obs.c:135-173): coords is
    (nobs, d) ball centres, radii length nobs, obsvals the observed
    values y (optional; needed for f).
    """
    coords = np.asarray(coords, dtype=float)
    radii = np.asarray(radii, dtype=float)
    nobs = coords.shape[0]
    d = len(grid_shape)
    X = grid_coordinates(grid_shape)  # (*grid, d)
    mass = lumped_mass(grid_shape)

    cols = []
    for i in range(nobs):
        dist2 = ((X - coords[i].reshape((1,) * d + (d,))) ** 2).sum(axis=-1)
        ind = (dist2 < radii[i] ** 2).astype(float) / _ball_volume(d, radii[i])
        cols.append(mass * ind)
    B = jnp.asarray(np.stack(cols, axis=-1), dtype=dtype)  # (*grid, nobs)

    sigma_inv = jnp.full((nobs,), 1.0 / sigma2, dtype=dtype)

    f = None
    if obsvals is not None:
        y = jnp.asarray(np.asarray(obsvals, dtype=float), dtype=dtype)
        f = jnp.tensordot(
            B, sigma_inv * y, axes=((d,), (0,)),
            precision=jax.lax.Precision.HIGHEST,
        )
    return B, sigma_inv, f


def make_posterior_operator(base, sigma2, coords, radii, obsvals=None):
    """Convenience: LRCOperator + rhs f for a Bayesian inverse problem.

    Ball-average columns are localized, so the returned operator
    carries the sparse patch view (operators.lrc.with_patches) that
    keeps the posterior chain's rank-k products to k small windows."""
    from parmgmc_tpu.operators.lrc import with_patches

    B, sigma_inv, f = make_observation_mats(
        base.grid_shape, sigma2, coords, radii, obsvals, dtype=base.dtype
    )
    return with_patches(LRCOperator(base=base, B=B, sigma_inv=sigma_inv)), f
