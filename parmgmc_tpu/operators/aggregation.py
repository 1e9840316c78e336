"""Algebraic (smoothed-aggregation) multigrid hierarchy for graph operators.

JAX analogue of PETSc ``PCGAMG`` as the reference configures it
for MGMC (``src/pc_gamgmc.c:275-356``, ``examples/benchmark/benchmarkrc``:
smoothed aggregation, Galerkin coarse operators).  Setup runs on the
host with scipy.sparse (like GAMG's setup runs on CPUs); the per-level
results ship to the device as colour-blocked ELL operators
(:class:`~parmgmc_tpu.operators.graph.GraphOperator`) and gather-only
sparse transfers (:class:`~parmgmc_tpu.operators.transfer.SparseTransfer`).

Pipeline per level:
  1. strength graph  S = { (i,j) : |a_ij| > theta * sqrt(a_ii a_jj) },
  2. greedy aggregation (MIS-style) on S,
  3. tentative prolongator P0 (piecewise constant over aggregates),
  4. smoothing   P = (I - omega D^{-1} A) P0   (`agg_nsmooths` analogue),
  5. Galerkin    A_c = P^T A P  (exact, scipy sparse triple product).

Because A_c = P^T A P exactly and the level samplers target each A_c,
the MGMC invariance argument carries over verbatim — verified by the
machine-precision fixed-point tests on small meshes.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from parmgmc_tpu.operators.graph import GraphOperator, from_csr
from parmgmc_tpu.operators.lrc import LRCOperator
from parmgmc_tpu.operators.transfer import sparse_transfer_from_csr

__all__ = ["aggregation_hierarchy", "smoothed_aggregation_level"]


def _strength_graph(A, theta):
    import scipy.sparse as sp

    d = np.sqrt(np.maximum(A.diagonal(), 1e-300))
    C = sp.csr_matrix(A, copy=True)
    C.setdiag(0.0)
    C.eliminate_zeros()
    coo = C.tocoo()
    keep = np.abs(coo.data) > theta * d[coo.row] * d[coo.col]
    return sp.csr_matrix(
        (np.ones(keep.sum()), (coo.row[keep], coo.col[keep])), shape=A.shape
    )


def _aggregate(S):
    """Greedy aggregation: roots = maximal independent set, then attach
    neighbours; stragglers join the nearest aggregate.  Uses the native
    C++ routine when available (identical output)."""
    from parmgmc_tpu.native import aggregate_native

    nat = aggregate_native(S.indptr, S.indices, S.shape[0])
    if nat is not None:
        return nat
    n = S.shape[0]
    agg = np.full(n, -1, dtype=np.int64)
    n_agg = 0
    # Pass 1: roots + their neighbourhoods.
    for i in range(n):
        if agg[i] >= 0:
            continue
        nb = S.indices[S.indptr[i] : S.indptr[i + 1]]
        if np.all(agg[nb] < 0):
            agg[i] = n_agg
            agg[nb] = n_agg
            n_agg += 1
    # Pass 2: attach leftovers to any aggregated strong neighbour.
    for i in range(n):
        if agg[i] >= 0:
            continue
        nb = S.indices[S.indptr[i] : S.indptr[i + 1]]
        hit = nb[agg[nb] >= 0]
        if hit.size:
            agg[i] = agg[hit[0]]
        else:
            agg[i] = n_agg
            n_agg += 1
    return agg, n_agg


def smoothed_aggregation_level(A, theta=0.02, omega=2.0 / 3.0, nsmooth=1):
    """One coarsening step: returns (P, A_coarse) as scipy CSR."""
    import scipy.sparse as sp

    n = A.shape[0]
    S = _strength_graph(A, theta)
    agg, n_agg = _aggregate(S)
    P = sp.csr_matrix(
        (np.ones(n), (np.arange(n), agg)), shape=(n, n_agg)
    )
    if nsmooth:
        Dinv = sp.diags(1.0 / A.diagonal())
        Sm = sp.eye(n) - omega * (Dinv @ A)
        for _ in range(nsmooth):
            P = Sm @ P
        P = sp.csr_matrix(P)
    Ac = sp.csr_matrix(P.T @ A @ P)
    Ac.eliminate_zeros()
    return P, Ac


def aggregation_hierarchy(
    op,
    n_levels=None,
    coarsest_size: int = 128,
    theta: float = 0.02,
    nsmooth: int = 1,
):
    """(ops, transfers) for a GraphOperator (or LRC over one).

    Transfers are expressed in each level's internal (colour-blocked)
    ordering, so device-side cycles never touch the permutations.
    """
    import scipy.sparse as sp

    is_lrc = isinstance(op, LRCOperator)
    base0 = op.base if is_lrc else op
    dtype = base0.dtype

    def to_csr(g: GraphOperator):
        n = g.n
        rows = np.repeat(np.arange(n), g.cols.shape[1])
        A = sp.csr_matrix(
            (np.asarray(g.vals).ravel(), (rows, np.asarray(g.cols).ravel())),
            shape=(n, n),
        )
        A.setdiag(np.asarray(g.diag))
        A.eliminate_zeros()
        return A

    ops = [op]
    transfers = []
    A = to_csr(base0)
    while True:
        if n_levels is not None and len(ops) >= n_levels:
            break
        if n_levels is None and A.shape[0] <= coarsest_size:
            break
        P, Ac = smoothed_aggregation_level(A, theta=theta, nsmooth=nsmooth)
        if Ac.shape[0] >= A.shape[0]:  # no coarsening progress
            break
        coarse_graph = from_csr(Ac, dtype=dtype)
        # P's rows are already in the fine level's internal ordering
        # (A is kept in the CURRENT level's internal ordering below); only
        # the column side needs the coarse level's internal permutation.
        pc = np.asarray(coarse_graph.perm)
        P_int = sp.csr_matrix(P[:, pc])
        tr = sparse_transfer_from_csr(P_int, dtype=dtype)
        transfers.append(tr)
        if is_lrc:
            cur = ops[-1]
            Bc = jnp.stack(
                [tr.restrict(cur.B[:, k]) for k in range(cur.B.shape[-1])],
                axis=-1,
            )
            ops.append(
                LRCOperator(base=coarse_graph, B=Bc, sigma_inv=cur.sigma_inv)
            )
        else:
            ops.append(coarse_graph)
        # Continue in the COARSE level's internal (colour-blocked)
        # ordering: coarse_graph works in Ac[pc][:,pc] coordinates, so
        # the next level's P rows must be built there too.  (Keeping the
        # unpermuted Ac here silently broke Galerkin exactness — and the
        # MGMC invariance oracle — for every hierarchy with >= 3 levels;
        # caught by the round-4 multichain A/B, 2026-08-20.)
        A = sp.csr_matrix(Ac[pc][:, pc])
    return ops, tuple(transfers)
