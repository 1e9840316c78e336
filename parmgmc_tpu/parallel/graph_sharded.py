"""Row-partitioned SPMD domain decomposition for unstructured meshes.

The reference row-partitions mesh matrices over MPI ranks and sweeps
with per-colour ghost scatters (``/root/reference/src/mc_sor.c:298-381``
builds per-colour index sets + VecScatters; ``examples/ex13.py:80-87``
weak-scales the wrench to 512 ranks).  This is the JAX
equivalent, built on ``shard_map`` over a device mesh axis:

* **Partition**: owned rows are split by a balanced cut along the
  widest coordinate axis (locality ~ small boundaries), then stored
  per shard in a colour-blocked ELL with UNIFORM padded colour-block
  extents, so every shard runs the same traced program (padded rows
  are inert self-loops: diag 1, off-diagonals 0, never referenced).
* **Ghosts**: boundary values move NEIGHBOR-WISE by default — one
  ``ppermute`` per nonzero shard offset with cross-shard references
  (typically just +-1 under a coordinate cut), so received bytes per
  shard are O(neighbors x boundary) like the reference's per-colour
  VecScatter (``mc_sor.c:152-214``) — with an ``all_gather`` mode kept
  for A/B probes.  Ghost column ids index the concatenation
  ``[x_local, exchanged_exports]`` statically.
* **Coarse levels**: the algebraic hierarchy below level 0 is
  REPLICATED (mesh coarse levels shrink ~25x per level); restriction
  is a per-shard partial P^T over owned rows + one ``psum``, and
  prolongation is a purely local row gather from the replicated coarse
  vector — the graph analogue of the structured hierarchy's
  replicate-below-threshold strategy (parallel/mesh.py).

Exactness: within a colour, multicolour Gauss-Seidel updates are
independent, and ghosts are refreshed at every colour boundary, so the
sharded sweep applies the SAME operator as the single-device sweep
(verified to f64 rounding on virtual device meshes).  The sharded MGMC
cycle is likewise deterministically equal to the single-device
``step_with_noise`` given matched noises.

Chains may carry the trailing chain axis (``x_local (S, L, C)``): the
multichain layout composes with domain decomposition, scaling mesh
problems in SIZE (shards) and THROUGHPUT (chains) simultaneously.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from parmgmc_tpu._pytree import bcast_trailing as _bc
from parmgmc_tpu._pytree import pytree_dataclass
from parmgmc_tpu.operators.graph import GraphOperator

__all__ = [
    "ShardedGraphOperator",
    "partition_graph_operator",
    "to_local",
    "to_global",
    "rows_to_local",
    "sharded_sor_sweep",
    "sharded_apply",
    "make_sharded_graph_gibbs_step",
    "make_sharded_graph_mgmc_step",
]

# f32 contractions run in TF32 on tensor-core GPUs unless asked not to.
HIGHEST = jax.lax.Precision.HIGHEST


@pytree_dataclass(
    meta=(
        "color_starts", "n_shards", "bmax", "n_local", "ghost_mode",
        "nbr_shifts",
    )
)
class ShardedGraphOperator:
    """Per-shard colour-blocked ELL blocks, stacked on a leading shard
    axis (sharded over the device mesh).  Ghost columns index
    ``[local, exchanged exports]``; see module docstring.

    Two ghost exchanges (``ghost_mode``):

    * ``"neighbor"`` (default) — one ``ppermute`` per nonzero shard
      offset delta in ``nbr_shifts``: shard s ships its (s -> s-delta)
      export block around the ring, so received bytes per shard are
      O(neighbors * boundary), matching the reference's per-colour
      VecScatter locality (``/root/reference/src/mc_sor.c:152-214``).
      ``export_idx`` is (S, m, bmax): row j = the delta_j export slots.
    * ``"allgather"`` — every shard receives EVERY shard's padded
      boundary (O(S * bmax) received bytes); ``export_idx`` is
      (S, bmax).  Kept for A/B probes; fine at small S, does not
      weak-scale.
    """

    vals: jax.Array  # (S, L, w)
    cols: jax.Array  # (S, L, w) int32 into [0, L + ghosts)
    diag: jax.Array  # (S, L)
    export_idx: jax.Array  # (S, bmax) or (S, m, bmax) int32 local slots
    own_gid: jax.Array  # (S, L) int32 global-internal id (0 for padding)
    own_mask: jax.Array  # (S, L) f32: 1 real row, 0 padding
    color_starts: tuple  # uniform local colour offsets (len ncolors+1)
    n_shards: int
    bmax: int
    n_local: int
    ghost_mode: str = "allgather"
    nbr_shifts: tuple = ()

    @property
    def ncolors(self) -> int:
        return len(self.color_starts) - 1

    @property
    def ghost_rows_received(self) -> int:
        """Ghost rows received per shard per exchange (the weak-scaling
        figure of merit: O(neighbors) for neighbor mode, O(S) for
        allgather)."""
        if self.ghost_mode == "neighbor":
            return len(self.nbr_shifts) * self.bmax
        return self.n_shards * self.bmax


def partition_graph_operator(
    op: GraphOperator, n_shards: int, coords=None, ghost_mode: str = "neighbor"
) -> ShardedGraphOperator:
    """Row-partition a colour-blocked GraphOperator into ``n_shards``.

    ``coords`` (n, d) point coordinates in the op's ORIGINAL node
    ordering select a balanced widest-axis cut; without them, the
    original node index orders the cut (Gmsh orderings are usually
    local enough).  Host-side eager setup, like the reference's
    MatCreateAIJ row distribution.
    """
    n = op.n
    vals = np.asarray(op.vals)
    cols = np.asarray(op.cols)
    diag = np.asarray(op.diag)
    perm = np.asarray(op.perm)
    starts = op.color_starts
    ncolors = op.ncolors

    color_of = np.empty(n, np.int32)
    for c in range(ncolors):
        color_of[starts[c] : starts[c + 1]] = c

    # owner: balanced cut along the widest coordinate axis
    if coords is not None:
        ci = np.asarray(coords)[perm]  # internal ordering
        axis = int(np.argmax(ci.max(0) - ci.min(0)))
        order = np.argsort(ci[:, axis], kind="stable")
    else:
        order = np.argsort(perm, kind="stable")  # original-index locality
    owner = np.empty(n, np.int32)
    bounds = [(n * s) // n_shards for s in range(n_shards + 1)]
    for s in range(n_shards):
        owner[order[bounds[s] : bounds[s + 1]]] = s

    # local layouts: per shard, owned rows sorted by (colour, gid);
    # per-colour extents padded to the max over shards
    owned = [np.where(owner == s)[0] for s in range(n_shards)]
    by_color = [
        [gs[color_of[gs] == c] for c in range(ncolors)] for gs in owned
    ]
    rmax = [
        max(len(by_color[s][c]) for s in range(n_shards))
        for c in range(ncolors)
    ]
    lstarts = np.concatenate([[0], np.cumsum(rmax)]).astype(int)
    L = int(lstarts[-1])

    # global-internal -> (owner, local slot)
    slot_of = np.empty(n, np.int64)
    own_gid = np.zeros((n_shards, L), np.int32)
    own_mask = np.zeros((n_shards, L), np.float32)
    for s in range(n_shards):
        for c in range(ncolors):
            gs = by_color[s][c]
            sl = lstarts[c] + np.arange(len(gs))
            slot_of[gs] = sl
            own_gid[s, sl] = gs
            own_mask[s, sl] = 1.0

    # boundary exports: owned gids referenced by another shard
    w = vals.shape[1]
    ref_mask = vals != 0
    pair_need = [[None] * n_shards for _ in range(n_shards)]  # [t][s]
    for t in range(n_shards):
        gt = owned[t]
        nb = cols[gt][ref_mask[gt]]
        for s in range(n_shards):
            if t == s:
                continue
            pair_need[t][s] = np.unique(nb[owner[nb] == s])

    if ghost_mode == "neighbor":
        # per-offset export lists: shard s ships lists_d[s] to (s - d)
        shifts = [
            d
            for d in range(1, n_shards)
            if any(
                len(pair_need[(s - d) % n_shards][s]) for s in range(n_shards)
            )
        ]
        lists = {
            d: [np.sort(pair_need[(s - d) % n_shards][s]) if
                pair_need[(s - d) % n_shards][s] is not None else
                np.empty(0, np.int64) for s in range(n_shards)]
            for d in shifts
        }
        bmax = max(
            [1] + [len(l) for d in shifts for l in lists[d]]
        )
        m = max(1, len(shifts))
        export_idx = np.zeros((n_shards, m, bmax), np.int32)
        # pos_nbr[j, g]: position of gid g in owner(g)'s delta_j list
        pos_nbr = np.zeros((m, n), np.int64)
        for j, d in enumerate(shifts):
            for s in range(n_shards):
                e = lists[d][s]
                export_idx[s, j, : len(e)] = slot_of[e]
                pos_nbr[j, e] = np.arange(len(e))
        j_of_delta = np.zeros(n_shards, np.int64)
        for j, d in enumerate(shifts):
            j_of_delta[d] = j
    else:
        assert ghost_mode == "allgather", ghost_mode
        exports = []
        for s in range(n_shards):
            need = [
                pair_need[t][s] for t in range(n_shards) if t != s
            ]
            e = (
                np.unique(np.concatenate(need))
                if need
                else np.empty(0, np.int64)
            )
            exports.append(e)
        bmax = max(1, max(len(e) for e in exports))
        export_idx = np.zeros((n_shards, bmax), np.int32)
        pos_in_export = np.full(n, -1, np.int64)
        for s in range(n_shards):
            export_idx[s, : len(exports[s])] = slot_of[exports[s]]
            pos_in_export[exports[s]] = np.arange(len(exports[s]))
        shifts = []

    # per-shard ELL with ghost-mapped columns
    vals_sh = np.zeros((n_shards, L, w), vals.dtype)
    cols_sh = np.zeros((n_shards, L, w), np.int32)
    diag_sh = np.ones((n_shards, L), diag.dtype)
    for s in range(n_shards):
        sl_self = np.arange(L, dtype=np.int32)
        cols_sh[s] = sl_self[:, None]  # padding: inert self-loops
        gs = np.where(own_mask[s] > 0)[0]
        gids = own_gid[s, gs]
        vals_sh[s, gs] = vals[gids]
        diag_sh[s, gs] = diag[gids]
        cg = cols[gids]
        local = owner[cg] == s
        if ghost_mode == "neighbor":
            delta = (owner[cg] - s) % n_shards
            jj = j_of_delta[delta]
            ghost = L + jj * bmax + pos_nbr[jj, cg]
        else:
            ghost = L + owner[cg] * bmax + pos_in_export[cg]
        mapped = np.where(local, slot_of[cg], ghost)
        # zero-padded ELL entries may carry self columns owned locally
        # anyway; unreferenced (vals 0) entries map to the row itself
        mapped = np.where(ref_mask[gids], mapped, gs[:, None])
        cols_sh[s, gs] = mapped.astype(np.int32)

    return ShardedGraphOperator(
        vals=jnp.asarray(vals_sh),
        cols=jnp.asarray(cols_sh),
        diag=jnp.asarray(diag_sh),
        export_idx=jnp.asarray(export_idx),
        own_gid=jnp.asarray(own_gid),
        own_mask=jnp.asarray(own_mask),
        color_starts=tuple(int(x) for x in lstarts),
        n_shards=int(n_shards),
        bmax=int(bmax),
        n_local=L,
        ghost_mode=ghost_mode,
        nbr_shifts=tuple(int(d) for d in shifts),
    )


# -- global <-> local layout (host/eager helpers for tests and drivers) ----
def to_local(spec: ShardedGraphOperator, v):
    """(n, [C]) internal-ordered vector -> (S, L, [C]) sharded layout."""
    out = v[spec.own_gid.reshape(-1)].reshape(
        (spec.n_shards, spec.n_local) + v.shape[1:]
    )
    return out * _bc(spec.own_mask, out)


def to_global(spec: ShardedGraphOperator, vl, n: int):
    """(S, L, [C]) sharded layout -> (n, [C]) internal-ordered vector."""
    flat = vl.reshape((spec.n_shards * spec.n_local,) + vl.shape[2:])
    gid = spec.own_gid.reshape(-1)
    mask = spec.own_mask.reshape(-1)
    out = jnp.zeros((n,) + vl.shape[2:], vl.dtype)
    return out.at[gid].add(flat * _bc(mask, flat))


def rows_to_local(spec: ShardedGraphOperator, M):
    """(n, k) row matrix -> (S, L, k) row-sharded blocks (padding rows
    zero).  Used for the LRC pieces B / Bb whose rows live on the fine
    grid: shard-local products then need only one psum per k-vector
    (the Woodbury analogue of the reference's MPI dot products,
    ``/root/reference/src/woodbury.c:259-286``)."""
    out = M[spec.own_gid.reshape(-1)].reshape(
        (spec.n_shards, spec.n_local, M.shape[-1])
    )
    return out * spec.own_mask[..., None]


# -- shard-local compute (runs INSIDE shard_map; leading S axis == 1) ------
def _gather_exports(spec, x_loc, axis_name):
    """Extended vector ``[local, ghosts]`` for one colour sub-sweep.

    neighbor mode: one ``ppermute`` per nonzero shard offset delta —
    shard s ships its (bmax, [C]) export block for delta to shard
    s - delta, so each shard receives O(neighbors * bmax) rows (the
    reference's per-colour VecScatter locality, mc_sor.c:152-214).
    allgather mode: every shard's padded boundary, O(S * bmax) rows."""
    S = spec.n_shards
    if spec.ghost_mode == "neighbor":
        blocks = []
        for j, d in enumerate(spec.nbr_shifts):
            blk = x_loc[spec.export_idx[0, j]]  # (bmax, [C])
            perm = [(s, (s - d) % S) for s in range(S)]
            blocks.append(jax.lax.ppermute(blk, axis_name, perm))
        if not blocks:  # single shard / no cross-shard references
            blocks = [jnp.zeros((spec.bmax,) + x_loc.shape[1:], x_loc.dtype)]
        return jnp.concatenate([x_loc] + blocks, axis=0)
    ex = x_loc[spec.export_idx[0]]  # (bmax, [C])
    table = jax.lax.all_gather(ex, axis_name, tiled=True)  # (S*bmax, [C])
    return jnp.concatenate([x_loc, table], axis=0)


def _local_ell_sums(spec, xe, s, e):
    g = xe[spec.cols[0, s:e]]  # (rows, w, [C])
    return jnp.sum(_bc(spec.vals[0, s:e], g) * g, axis=1)


def sharded_sor_sweep(spec, b_loc, x_loc, omega, axis_name, sweep="forward"):
    """Multicolour SOR sweep on the sharded layout — the mc_sor hot
    loop with per-colour ghost refresh.  Exactly the single-device
    sweep operator (colour-internal updates are independent)."""
    if sweep == "symmetric":
        x_loc = sharded_sor_sweep(spec, b_loc, x_loc, omega, axis_name, "forward")
        return sharded_sor_sweep(spec, b_loc, x_loc, omega, axis_name, "backward")
    order = range(spec.ncolors)
    if sweep == "backward":
        order = reversed(list(order))
    b_loc = jnp.broadcast_to(_bc(b_loc, x_loc), x_loc.shape)
    for c in order:
        s, e = spec.color_starts[c], spec.color_starts[c + 1]
        if s == e:
            continue
        xe = _gather_exports(spec, x_loc, axis_name)
        sums = _local_ell_sums(spec, xe, s, e)
        upd = (1.0 - omega) * x_loc[s:e] + _bc(
            omega / spec.diag[0, s:e], x_loc
        ) * (b_loc[s:e] - sums)
        x_loc = jax.lax.dynamic_update_slice(
            x_loc, upd, (s,) + (0,) * (x_loc.ndim - 1)
        )
    return x_loc


def sharded_apply(spec, x_loc, axis_name):
    """A x on the sharded layout (one ghost gather)."""
    xe = _gather_exports(spec, x_loc, axis_name)
    sums = _local_ell_sums(spec, xe, 0, spec.n_local)
    return _bc(spec.diag[0], x_loc) * x_loc + sums


# -- samplers ---------------------------------------------------------------
def make_sharded_graph_gibbs_step(
    op: GraphOperator,
    mesh: Mesh,
    omega: float = 1.0,
    sweep: str = "forward",
    coords=None,
    axis_name: str = "x",
    n_chains: int = 0,
    ghost_mode: str = "neighbor",
):
    """(step, spec, sharding): a jitted sharded Gibbs chain step.

    step(key, x_loc, b_loc) -> (key, x_loc') on the (S, L, [C]) layout
    (``n_chains > 0`` appends the trailing chain axis).  Targets
    N(A^{-1}b, A^{-1}) exactly — the sweep operator equals the
    single-device one and the noise law is per-owned-row iid (padded
    rows receive noise that nothing ever reads)."""
    S = mesh.shape[axis_name]
    spec = partition_graph_operator(op, S, coords=coords, ghost_mode=ghost_mode)
    om = jnp.asarray(omega, op.dtype)
    nsc = jnp.sqrt((2.0 - om) / om) * jnp.sqrt(spec.diag)
    batch = (n_chains,) if n_chains else ()

    def local_step(spec_l, nsc_l, key, x_loc, b_loc):
        x_loc = x_loc[0]
        b_loc = b_loc[0]
        idx = jax.lax.axis_index(axis_name)
        kl = jax.random.fold_in(key, idx)
        dirs = (
            ["forward", "backward"] if sweep == "symmetric" else [sweep]
        )
        for i, d in enumerate(dirs):
            eta = jax.random.normal(
                jax.random.fold_in(kl, i),
                (spec_l.n_local,) + batch,
                x_loc.dtype,
            )
            btilde = _bc(b_loc, eta) + _bc(nsc_l[0], eta) * eta
            x_loc = sharded_sor_sweep(spec_l, btilde, x_loc, om, axis_name, d)
        return x_loc[None]

    pspec = P(axis_name)
    specs3 = jax.tree_util.tree_map(lambda _: pspec, spec)
    smap = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(specs3, pspec, P(), pspec, pspec),
        out_specs=pspec,
        check_vma=False,
    )

    @jax.jit
    def step(key, x_loc, b_loc):
        key, sub = jax.random.split(key)
        return key, smap(spec, nsc, sub, x_loc, b_loc)

    sharding = NamedSharding(mesh, pspec)
    return step, spec, sharding


def make_sharded_graph_mgmc_step(
    sampler,
    mesh: Mesh,
    coords=None,
    axis_name: str = "x",
    n_chains: int = 0,
    with_noise: bool = True,
    ghost_mode: str = "neighbor",
):
    """(step, spec, sharding): sharded MGMC V-cycle chain step for an
    algebraic (GraphOperator) hierarchy — level 0 row-partitioned with
    per-colour ghost collectives, levels >= 1 replicated (redundant
    compute; they shrink ~25x per level).

    step(key, x_loc, b_loc) -> (key, x_loc').  Deterministically (zero
    noises) the cycle equals the single-device ``step_with_noise``; the
    keyed path draws level-0 noise per shard and coarse noise from the
    SHARED key (identical replicated draws).

    LRC (posterior) hierarchies are supported: a level-0
    ``LRCOperator`` over a GraphOperator base row-shards B and the
    smoother's Woodbury factors Bb (``rows_to_local``); each half-sweep
    adds the replicated low-rank RHS noise B sqrt(Sigma^{-1}) eta2 and
    applies the post-correction x <- x - Bb (B^T x) with B^T x as one
    shard-local rank-k product + psum — the reference weak-scales the
    same construction to 512 ranks (``/root/reference/examples/
    ex13.py:128-185``, ``src/woodbury.c:259-286``).  Coarse LRC levels
    ride the replicated sub-sampler unchanged (per-level B_c)."""
    from parmgmc_tpu.operators.lrc import LRCOperator
    from parmgmc_tpu.samplers.mgmc import MGMCSampler

    op0 = sampler.ops[0]
    is_lrc = isinstance(op0, LRCOperator)
    base0 = op0.base if is_lrc else op0
    assert isinstance(base0, GraphOperator), "graph hierarchies only"
    assert sampler.gamma == 1, "V-cycles only (gamma=1)"
    S = mesh.shape[axis_name]
    spec = partition_graph_operator(base0, S, coords=coords, ghost_mode=ghost_mode)
    s0 = sampler.smoothers[0]
    om = s0.omega
    sweep = s0.sweep
    nsc = jnp.sqrt((2.0 - om) / om) * jnp.sqrt(spec.diag)
    batch = (n_chains,) if n_chains else ()

    if is_lrc:
        assert s0.is_lrc and (
            s0.Bb_fw is not None or s0.Bb_bw is not None
        )
        # r5: create() only builds the direction(s) the sweep uses;
        # substitute the available factor for the never-consumed slot
        bb_fw = s0.Bb_fw if s0.Bb_fw is not None else s0.Bb_bw
        bb_bw = s0.Bb_bw if s0.Bb_bw is not None else s0.Bb_fw
        k_lr = op0.B.shape[-1]
        lrc_consts = (
            rows_to_local(spec, op0.B),
            rows_to_local(spec, bb_fw),
            rows_to_local(spec, bb_bw),
            op0.sigma_inv,
            s0.sqrt_sigma_inv,
        )
    else:
        k_lr = 0
        lrc_consts = ()

    # replicated sub-sampler for levels 1..: same smoothers/coarse
    sub_sampler = MGMCSampler(
        ops=sampler.ops[1:],
        transfers=sampler.transfers[1:],
        smoothers=sampler.smoothers[1:],
        coarse=sampler.coarse,
        n_pre=sampler.n_pre,
        n_post=sampler.n_post,
        n_levels=sampler.n_levels - 1,
        n_coarse=sampler.n_coarse,
        gamma=sampler.gamma,
    )

    # level-0 transfer in sharded form: P^T partials over owned rows,
    # P rows gathered from the replicated coarse vector
    tr = sampler.transfers[0]
    pt_vals = np.asarray(tr.pt_vals)  # (nc, wt) over fine internal ids
    pt_cols = np.asarray(tr.pt_cols)
    p_vals = np.asarray(tr.p_vals)  # (nf, wp) over coarse ids
    p_cols = np.asarray(tr.p_cols)
    owner_of_slot = np.asarray(spec.own_gid)
    # fine internal id -> (owner, slot)
    n_fine = op0.n
    slot_of = np.zeros(n_fine, np.int64)
    owner = np.zeros(n_fine, np.int64)
    for s in range(spec.n_shards):
        gs = np.where(np.asarray(spec.own_mask)[s] > 0)[0]
        gid = owner_of_slot[s, gs]
        slot_of[gid] = gs
        owner[gid] = s
    Ssh = spec.n_shards
    ptv = np.zeros((Ssh, *pt_vals.shape), pt_vals.dtype)
    ptc = np.zeros((Ssh, *pt_cols.shape), np.int32)
    for s in range(Ssh):
        mine = owner[pt_cols] == s
        ptv[s] = np.where(mine, pt_vals, 0.0)
        ptc[s] = np.where(mine, slot_of[pt_cols], 0).astype(np.int32)
    ptv = jnp.asarray(ptv)
    ptc = jnp.asarray(ptc)
    # prolong rows for owned slots (padding rows: zeros)
    L = spec.n_local
    pv = np.zeros((Ssh, L, p_vals.shape[1]), p_vals.dtype)
    pc = np.zeros((Ssh, L, p_cols.shape[1]), np.int32)
    for s in range(Ssh):
        gs = np.where(np.asarray(spec.own_mask)[s] > 0)[0]
        gid = owner_of_slot[s, gs]
        pv[s, gs] = p_vals[gid]
        pc[s, gs] = p_cols[gid]
    pv = jnp.asarray(pv)
    pc = jnp.asarray(pc)

    n_pre, n_post = sampler.n_pre, sampler.n_post
    dirs = ["forward", "backward"] if sweep == "symmetric" else [sweep]

    def op_apply_local(spec_l, lrc_l, x_loc):
        """A x (posterior A for LRC) on the sharded layout."""
        ax = sharded_apply(spec_l, x_loc, axis_name)
        if not is_lrc:
            return ax
        B_l = lrc_l[0][0]  # (L, k)
        bty = jax.lax.psum(
            jnp.tensordot(B_l, x_loc, axes=((0,), (0,)), precision=HIGHEST),
            axis_name,
        )  # (k, [C])
        w = _bc(lrc_l[3], bty) * bty  # Sigma^{-1} B^T x
        return ax + jnp.tensordot(
            B_l, w, axes=((1,), (0,)), precision=HIGHEST
        )

    def gibbs_step_local(spec_l, nsc_l, lrc_l, kl, ksh, x_loc, rhs, ctr):
        """One level-0 Gibbs step (matches GibbsSampler.step_with_noise:
        fresh noise per half-sweep).  LRC: the low-rank RHS noise draw
        eta2 comes from the SHARED key (identical on every shard), and
        the Woodbury post-correction runs shard-local rank-k + psum."""
        for i, d in enumerate(dirs):
            if with_noise:
                eta = jax.random.normal(
                    jax.random.fold_in(kl, 2 * ctr + i),
                    (spec_l.n_local,) + batch,
                    x_loc.dtype,
                )
            else:
                eta = jnp.zeros((spec_l.n_local,) + batch, x_loc.dtype)
            btilde = rhs + _bc(nsc_l[0], eta) * eta
            if is_lrc:
                B_l = lrc_l[0][0]
                if with_noise:
                    eta2 = jax.random.normal(
                        jax.random.fold_in(ksh, 2 * ctr + i),
                        (k_lr,) + batch,
                        x_loc.dtype,
                    )
                else:
                    eta2 = jnp.zeros((k_lr,) + batch, x_loc.dtype)
                w = _bc(lrc_l[4], eta2) * eta2  # sqrt(Sigma^{-1}) eta2
                btilde = btilde + jnp.tensordot(
                    B_l, w, axes=((1,), (0,)), precision=HIGHEST
                )
            x_loc = sharded_sor_sweep(spec_l, btilde, x_loc, om, axis_name, d)
            if is_lrc:
                B_l = lrc_l[0][0]
                Bb_l = lrc_l[1][0] if d == "forward" else lrc_l[2][0]
                bty = jax.lax.psum(
                    jnp.tensordot(
                        B_l, x_loc, axes=((0,), (0,)), precision=HIGHEST
                    ),
                    axis_name,
                )
                x_loc = x_loc - jnp.tensordot(
                    Bb_l, bty, axes=((1,), (0,)), precision=HIGHEST
                )
        return x_loc

    def coarse_cycle(rc, key):
        if with_noise:
            return sub_sampler._cycle_keyed(0, rc, key)
        zeros = jax.tree_util.tree_map(
            lambda sh: jnp.zeros(tuple(sh) + batch, rc.dtype),
            sub_sampler.noise_shapes(),
            is_leaf=lambda l: isinstance(l, tuple),
        )
        return sub_sampler._cycle(0, rc, zeros)

    def local_step(spec_l, nsc_l, ptv_l, ptc_l, pv_l, pc_l, lrc_l, key, x_loc, b_loc):
        # (the replicated sub-sampler is a closure constant: coarse mesh
        # levels are small, and every shard runs the identical program)
        x_loc = x_loc[0]
        b_loc = jnp.broadcast_to(_bc(b_loc[0], x_loc), x_loc.shape)
        ptv_s, ptc_s = ptv_l[0], ptc_l[0]
        pv_s, pc_s = pv_l[0], pc_l[0]
        idx = jax.lax.axis_index(axis_name)
        kl = jax.random.fold_in(key, idx + 1)  # per-shard level-0 stream
        ksh = jax.random.fold_in(key, 0)  # shared (replicated) stream
        # chain residual r = b - A x
        r = b_loc - op_apply_local(spec_l, lrc_l, x_loc)
        # level-0 pre-smooth from zero
        y = jnp.zeros_like(x_loc)
        for i in range(n_pre):
            y = gibbs_step_local(spec_l, nsc_l, lrc_l, kl, ksh, y, r, i)
        # restricted residual: per-shard partial P^T + psum
        rr = r - op_apply_local(spec_l, lrc_l, y)
        rr = rr * _bc(spec_l.own_mask[0], rr)
        g = rr[ptc_s]  # (nc, wt, [C])
        rc = jax.lax.psum(jnp.sum(_bc(ptv_s, g) * g, axis=1), axis_name)
        # replicated coarse cycle (same key on every shard)
        z = coarse_cycle(rc, key)
        # local prolong-add
        gz = z[pc_s]
        y = y + jnp.sum(_bc(pv_s, gz) * gz, axis=1)
        # level-0 post-smooth (rhs = the cycle-local r, as in _cycle)
        for i in range(n_post):
            y = gibbs_step_local(spec_l, nsc_l, lrc_l, kl, ksh, y, r, n_pre + i)
        return (x_loc + y)[None]

    pspec = P(axis_name)
    specs3 = jax.tree_util.tree_map(lambda _: pspec, spec)
    lrc_specs = (pspec, pspec, pspec, P(), P()) if is_lrc else ()
    smap = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(
            specs3, pspec, pspec, pspec, pspec, pspec, lrc_specs, P(),
            pspec, pspec,
        ),
        out_specs=pspec,
        check_vma=False,
    )

    @jax.jit
    def step(key, x_loc, b_loc):
        key, sub = jax.random.split(key)
        return key, smap(spec, nsc, ptv, ptc, pv, pc, lrc_consts, sub, x_loc, b_loc)

    sharding = NamedSharding(mesh, pspec)
    return step, spec, sharding
