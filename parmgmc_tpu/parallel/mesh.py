"""Device-mesh sharding of samplers and chain state.

Replacement for the reference's MPI domain decomposition
(row-partitioned MPIAIJ + per-color VecScatter ghost exchange,
``/root/reference/src/mc_sor.c:152-214,298-381``): grid-shaped arrays are
sharded block-wise over a ``jax.sharding.Mesh``; the stencil shifts inside
the sweep become compiler-inserted ``collective-permute`` halo exchanges
under GSPMD, exactly the ghost gathers the reference does by hand.

Sharding rules (applied leaf-wise to sampler pytrees):

* a leaf whose leading dims equal a *sharded* level's grid shape gets
  ``P('x', 'y'[, 'z'], None...)`` — operator coefficient fields, diagonals,
  noise scales, low-rank factors;
* coarse levels with fewer than ``min_local`` points per device along a
  mesh axis are fully replicated — every device redundantly computes the
  coarse-grid work, the efficient analogue of the reference's
  GAMG-coarsens-to-rank-0 + sequential Cholesky
  (``src/pc_chols.c:38-47,162-163``; SURVEY §2.3 item 5);
* everything else (dense Cholesky factors, k x k blocks, scalars) is
  replicated.
"""

from __future__ import annotations

import math

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "shard_sampler", "shard_array", "level_specs"]


def make_mesh(mesh_shape, axis_names=None) -> Mesh:
    """Create a Mesh over all available devices, e.g. make_mesh((2, 4))."""
    mesh_shape = tuple(mesh_shape)
    n = math.prod(mesh_shape)
    devices = np.array(jax.devices()[:n]).reshape(mesh_shape)
    if axis_names is None:
        axis_names = ("x", "y", "z")[: len(mesh_shape)]
    return Mesh(devices, axis_names)


def _spec_for_shape(shape, grid_specs):
    """PartitionSpec for a leaf: match leading dims against known grid shapes."""
    for gshape, axes in grid_specs:
        d = len(gshape)
        if len(shape) >= d and tuple(shape[:d]) == gshape:
            return P(*axes, *([None] * (len(shape) - d)))
    return P()  # replicated


def level_specs(grid_shapes, mesh: Mesh, min_local: int = 4, grid_axes=None):
    """(grid_shape, axes) pairs: which grid shapes are sharded and how.

    A grid dim i is sharded over mesh axis ``grid_axes[i]`` (default: the
    mesh axis names in order) while grid_shape[i] / mesh_size >= min_local
    and divisible; coarser levels fall back to replication.
    """
    specs = []
    names = grid_axes if grid_axes is not None else mesh.axis_names
    for gshape in grid_shapes:
        axes = []
        for i, s in enumerate(gshape):
            if i < len(names) and names[i] is not None:
                m = mesh.shape[names[i]]
                if s % m == 0 and s // m >= min_local:
                    axes.append(names[i])
                else:
                    axes.append(None)
            else:
                axes.append(None)
        if all(a is None for a in axes):
            continue
        specs.append((tuple(gshape), tuple(axes)))
    return specs


def _collect_grid_shapes(sampler):
    shapes = []
    ops = getattr(sampler, "ops", None)
    if ops is not None:
        for o in ops:
            shapes.append(tuple(o.grid_shape))
    else:
        shapes.append(tuple(sampler.grid_shape))
    return shapes


def shard_array(x, mesh: Mesh, grid_specs):
    spec = _spec_for_shape(x.shape, grid_specs)
    return jax.device_put(x, NamedSharding(mesh, spec))


def shard_sampler(sampler, mesh: Mesh, min_local: int = 4, grid_axes=None):
    """Device-put every array leaf of the sampler with its mesh sharding.

    Returns (sharded_sampler, state_sharding) where state_sharding is the
    NamedSharding for chain-state fields on the fine grid.  ``grid_axes``
    names the mesh axis for each grid dimension (None = unsharded dim),
    letting other mesh axes carry chain/batch parallelism.
    """
    grid_specs = level_specs(
        _collect_grid_shapes(sampler), mesh, min_local, grid_axes
    )

    def put(leaf):
        if hasattr(leaf, "shape"):
            return shard_array(leaf, mesh, grid_specs)
        return leaf

    sharded = jax.tree_util.tree_map(put, sampler)
    fine = tuple(sampler.grid_shape)
    state_sharding = NamedSharding(mesh, _spec_for_shape(fine, grid_specs))
    return sharded, state_sharding
