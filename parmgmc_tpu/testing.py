"""Exact sampler verification utilities.

Every sampler step here is an *affine* map of the current state, the RHS
and a pytree of standard-normal draws:

    x' = G x + H b + K eta,       eta ~ N(0, I).

A sampler targets N(A^{-1} b, A^{-1}) exactly iff

    mean fixed point:        G A^{-1}b + H b = A^{-1} b
    covariance fixed point:  G A^{-1} G^T + K K^T = A^{-1}.

Because the maps are affine, ``jax.jacfwd`` recovers G and K *exactly*
(one forward pass per column), so sampler correctness becomes a
machine-precision algebraic identity on small grids — a much stronger
oracle than the reference's statistical acceptance tests
(examples/ex1.c:135, ex4.c:247-251), which we keep as well for
end-to-end coverage.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

__all__ = ["transition_matrices", "invariance_error", "sharded_step_error"]


def _flatten_shapes(shapes):
    leaves, treedef = jax.tree_util.tree_flatten(
        shapes, is_leaf=lambda s: isinstance(s, tuple)
    )
    sizes = [math.prod(s) for s in leaves]
    return leaves, treedef, sizes


def transition_matrices(sampler, b):
    """Return (G, K, h): x' = G x + K eta + h for the given fixed b.

    ``b=None`` probes the zero-RHS (prior sampling) contract samplers
    expose: the step is differentiated with b=None passed through, so
    any fast path it triggers is what gets verified."""
    gshape = sampler.grid_shape
    n = math.prod(gshape)
    dtype = sampler.dtype if b is None else b.dtype
    shapes, treedef, sizes = _flatten_shapes(sampler.noise_shapes())
    ntot = sum(sizes)

    def f(xflat, zflat):
        chunks = []
        off = 0
        for s, sz in zip(shapes, sizes):
            chunks.append(zflat[off : off + sz].reshape(s))
            off += sz
        noises = jax.tree_util.tree_unflatten(treedef, chunks)
        x = xflat.reshape(gshape)
        return sampler.step_with_noise(x, b, noises).reshape(n)

    x0 = jnp.zeros((n,), dtype)
    z0 = jnp.zeros((ntot,), dtype)
    G = jax.jacfwd(f, argnums=0)(x0, z0)
    K = jax.jacfwd(f, argnums=1)(x0, z0)
    h = f(x0, z0)
    return G, K, h


def invariance_error(sampler, op, b):
    """Max-norm errors (mean_err, cov_err) of the N(A^{-1}b, A^{-1}) fixed point."""
    G, K, h = transition_matrices(sampler, b)
    A = op.to_dense()
    n = A.shape[0]
    Ainv = jnp.linalg.solve(A, jnp.eye(n, dtype=A.dtype))
    mu = Ainv @ (jnp.zeros(n, A.dtype) if b is None else b.reshape(n))
    mean_err = jnp.max(jnp.abs(G @ mu + h - mu))
    cov_err = jnp.max(jnp.abs(G @ Ainv @ G.T + K @ K.T - Ainv))
    scale = jnp.max(jnp.abs(Ainv))
    return mean_err / jnp.maximum(jnp.max(jnp.abs(mu)), 1e-30), cov_err / scale


def sharded_step_error(sampler, mesh, x, b, noises, min_local=4, grid_axes=None):
    """(rel_err, out): one ``step_with_noise`` of ``sampler`` sharded over
    ``mesh`` (:func:`parallel.mesh.shard_sampler`) against the same step
    on one device, with the same explicit noise.  ``rel_err`` is the
    max-norm difference relative to the single-device result's max."""
    from jax.sharding import NamedSharding, PartitionSpec

    from parmgmc_tpu.parallel.mesh import shard_sampler

    step = jax.jit(lambda s, xx, bb, nn: s.step_with_noise(xx, bb, nn))
    ref = step(sampler, x, b, noises)
    smp_sh, xsh = shard_sampler(sampler, mesh, min_local, grid_axes)
    put = lambda a: None if a is None else jax.device_put(a, xsh)
    noises_r = jax.device_put(noises, NamedSharding(mesh, PartitionSpec()))
    out = step(smp_sh, put(x), put(b), noises_r)
    ref = jax.device_put(ref, out.sharding)
    err = jnp.max(jnp.abs(out - ref)) / jnp.max(jnp.abs(ref))
    return float(err), out
