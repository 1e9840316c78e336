"""Vertex-star patch (block-)Gibbs sampler.

Rebuild of the reference's ASM star-patch smoother configuration —
firedrake's ``ASMStarPC`` with a ``cholsampler`` sub-sub-PC
(``/root/reference/examples/ex9.py:48-66``), the smoother of choice for
squared-operator priors where point-Gibbs mixes poorly.  Block-Gibbs:
patch S (a node and its star neighbours) is resampled from its exact
conditional

    x_S ~ N(A_SS^{-1} (b_S - A_{S,rest} x_rest), A_SS^{-1})

patch by patch.  Data-parallel formulation: patches are coloured so that
same-colour patches are mutually uncoupled (per-axis residues mod
(radius+3)); one colour pass updates all its patches simultaneously.
The tiny (k,k) patch systems are handled STRUCTURE-OF-ARRAYS: the
patch matrix entries live as subgrid-shaped planes and the Cholesky
factorisation + triangular solves are unrolled over the static k, so
every op is a plain elementwise op over the colour subgrid.  This
replaces the reference's per-patch LAPACK ``potrf``/``trsv`` fast path
(pc_chols.c:174-194) and avoids ``(..., k, k)``-shaped batched
``lax.linalg`` calls, whose tiny trailing dims make poor device
layouts.

Each patch update is an exact Gibbs conditional, so the whole sweep
preserves N(A^{-1}b, A^{-1}) exactly — verified by the machine-precision
invariance tests.  Cost: (radius+3)^d colour passes per sweep, each
touching only its n/(radius+3)^d-point subgrid, so a full sweep is
O(k^3 n) elementwise work regardless of the colour count.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from parmgmc_tpu._pytree import pytree_dataclass
from parmgmc_tpu.operators.stencil import StencilOperator
from parmgmc_tpu.samplers.gibbs import _draw

__all__ = ["PatchGibbsSampler", "GraphPatchGibbsSampler"]


def _shift(x, off, fill=0.0):
    """x[i + off] with constant fill, any radius."""
    r = max((abs(o) for o in off), default=0)
    if r == 0:
        return x
    xp = jnp.pad(x, r, constant_values=fill)
    sl = tuple(slice(r + o, r + o + s) for o, s in zip(off, x.shape))
    return xp[sl]


def _ingrid_mask(shape, off, dtype):
    """1 where node i+off exists."""
    m = np.ones(shape)
    for ax, o in enumerate(off):
        idx = [slice(None)] * len(shape)
        if o < 0:
            idx[ax] = slice(0, -o)
        elif o > 0:
            idx[ax] = slice(shape[ax] - o, shape[ax])
        else:
            continue
        m[tuple(idx)] = 0.0
    return jnp.asarray(m, dtype=dtype)


@pytree_dataclass(meta=("patch_offsets", "ncolor_base"))
class PatchGibbsSampler:
    """Coloured vertex-star block-Gibbs sweep for N(A^{-1}b, A^{-1})."""

    base: StencilOperator
    patch_offsets: tuple  # k member offsets (first = (0,...,0))
    ncolor_base: int  # colours = ncolor_base ** ndim

    @staticmethod
    def create(op: StencilOperator) -> "PatchGibbsSampler":
        assert isinstance(op, StencilOperator)
        d = op.ndim
        patch = [(0,) * d]
        for ax in range(d):
            for s in (-1, 1):
                off = [0] * d
                off[ax] = s
                patch.append(tuple(off))
        return PatchGibbsSampler(
            base=op,
            patch_offsets=tuple(patch),
            ncolor_base=op.radius + 3,
        )

    # -- protocol ------------------------------------------------------------
    @property
    def grid_shape(self):
        return self.base.grid_shape

    @property
    def dtype(self):
        return self.base.dtype

    def noise_shapes(self):
        k = len(self.patch_offsets)
        return [{"eta": (k, *self.grid_shape)}]

    def _color_mask(self, c, shape):
        d = len(shape)
        m = self.ncolor_base
        code = jnp.zeros(shape, dtype=jnp.int32)
        for ax in range(d):
            code = code * m + (
                jax.lax.broadcasted_iota(jnp.int32, shape, ax) % m
            )
        return code == c

    def step_with_noise(self, x, b, noises):
        """One full coloured patch sweep (every node's patch resampled).

        ``b=None`` means a zero RHS (prior sampling) — the repo-wide
        convention every sampler honors.

        Single-trace colour loop: the grid is zero-padded so every
        colour's centre subgrid has the SAME static shape (ceil(N/m)
        points per axis) and the colour's per-axis residues are decoded
        from the ``lax.fori_loop`` index.  One traced pass serves all
        m^d colours — the HLO is O(1)-size instead of ~30k ops for 125
        unrolled 3D passes (which stalled XLA).

        Few dynamic-start ops per pass: one ``dynamic_slice`` of the
        chain-state super-region, one per constants channel actually
        touched (b, diag, the k noise planes, each array-valued
        coefficient field), and one ``dynamic_update_slice``
        write-back: ~a dozen dynamic-start ops for a 3D star patch.  Every member / stencil access inside
        the pass is a STATIC strided view of those regions (the
        super-region carries ``rr = 1 + radius`` extra rings so views
        exist for all member+stencil reach), and the residual is a
        region-local apply over the super-region — no full-grid
        ``A.apply`` per pass.

        Phantom centres introduced by the shape-uniformising padding get
        all-zero member masks (identity systems, writes masked out).
        The patch systems are factored on the fly with an unrolled
        elementwise Cholesky (see module docstring).
        """
        if b is None:  # zero-RHS (prior) convention
            b = jnp.zeros_like(x)
        eta = noises[0]["eta"]  # (k, *grid)
        shape = self.grid_shape
        d = len(shape)
        k = len(self.patch_offsets)
        m = self.ncolor_base
        dtype = self.dtype
        base = self.base
        offsets = self.patch_offsets
        coeff_map = dict(zip(base.offsets, base.coeffs))

        cnt = tuple(-(-n // m) for n in shape)  # ceil(N/m), uniform
        L_reg = tuple((c - 1) * m + 1 for c in cnt)  # member-lattice span
        rr = 1 + base.radius  # member (1) + stencil reach
        L3 = tuple(l + 2 * rr for l in L_reg)  # super-region span
        # low pad m covers member+stencil offsets; high pad m + phantom rows
        pads = tuple((m, m + c * m - n) for c, n in zip(cnt, shape))

        def padg(arr):
            return jnp.pad(arr, pads)

        # -- constants stack: one dynamic_slice per pass serves them all
        arr_rels = tuple(
            o for o, co in coeff_map.items() if getattr(co, "ndim", 0)
        )
        chans = (
            [padg(b), padg(base.diag)]
            + [padg(eta[j]) for j in range(k)]
            + [padg(coeff_map[o]) for o in arr_rels]
        )
        i_b, i_dg, i_eta, i_cf = 0, 1, 2, 2 + k
        cf_chan = {o: i_cf + t for t, o in enumerate(arr_rels)}

        def pass_body(c, xp):
            # per-axis residues of colour c (matches _color_mask's code:
            # axis 0 is the most significant digit)
            a = []
            cc = c
            for _ in range(d):
                a.append(cc % m)
                cc = cc // m
            a = tuple(reversed(a))

            # member in-grid masks on the subgrid; phantom centres
            # (coord >= N from the uniformising pad) kill the whole patch
            coords = [
                a[ax] + m * jax.lax.broadcasted_iota(jnp.int32, cnt, ax)
                for ax in range(d)
            ]
            masks = []
            for o in offsets:
                ok = jnp.ones(cnt, dtype)
                for ax, oo in enumerate(o):
                    p_ax = coords[ax] + oo
                    ok = ok * (
                        (p_ax >= 0) & (p_ax <= shape[ax] - 1)
                    ).astype(dtype)
                masks.append(ok)
            center = masks[0]
            masks = [mk * center for mk in masks]

            # -- dynamic-start region gathers: one per array actually
            # touched
            st = tuple(a[ax] + m - rr for ax in range(d))
            Sx = jax.lax.dynamic_slice(xp, st, L3)
            reg_cache = {}

            def chan_region(chan):
                if chan not in reg_cache:
                    reg_cache[chan] = jax.lax.dynamic_slice(
                        chans[chan], st, L3
                    )
                return reg_cache[chan]

            view_cache = {}

            def view_of(R, tag, off):
                """Static strided view: values of super-region ``R`` at
                member-lattice positions shifted by ``off`` (|off| <= rr)."""
                key = (tag, off)
                if key in view_cache:
                    return view_cache[key]
                sl = tuple(
                    slice(rr + o, rr + o + l) for o, l in zip(off, L_reg)
                )
                reg = jnp.pad(
                    R[sl],
                    [(0, c0 * m - l) for c0, l in zip(cnt, L_reg)],
                )
                v = reg.reshape(tuple(q for c0 in cnt for q in (c0, m)))
                v = v[tuple(q for _ in cnt for q in (slice(None), 0))]
                view_cache[key] = v
                return v

            def view(chan, off):
                """chan None = the x super-region; else a constants channel."""
                R = Sx if chan is None else chan_region(chan)
                return view_of(R, chan, off)

            def cf(rel, at):
                """Coefficient for offset ``rel`` at row position ``at``."""
                co = coeff_map[rel]
                if getattr(co, "ndim", 0):
                    return view(cf_chan[rel], at)
                return jnp.asarray(co, dtype)

            zero = (0,) * d
            xs = [view(None, o) for o in offsets]
            dgs = [view(i_dg, o) for o in offsets]
            ets = [view(i_eta + j, zero) for j in range(k)]

            # residual on the super-region via STATIC shifts (a region-
            # local A.apply: ~nnz fused elementwise ops, not nnz*k
            # strided views); member rows then need only k views.
            # Out-of-grid x reads hit the zero padding, matching the
            # operator's boundary truncation; region-edge shift garbage
            # only lands outside the member lattice.
            def rshift(rel):
                pads2 = tuple(
                    (max(0, -q), max(0, q)) for q in rel
                )
                sp = jnp.pad(Sx, pads2)
                sl = tuple(
                    slice(max(0, q), max(0, q) + L3[ax])
                    for ax, q in enumerate(rel)
                )
                return sp[sl]

            r_reg = chan_region(i_b) - chan_region(i_dg) * Sx
            for rel in base.offsets:
                co = coeff_map[rel]
                cr = (
                    chan_region(cf_chan[rel])
                    if getattr(co, "ndim", 0)
                    else jnp.asarray(co, dtype)
                )
                r_reg = r_reg - cr * rshift(rel)
            rs = [view_of(r_reg, ("r",), o) for o in offsets]

            # A_SS entries, SoA: dummy members get identity rows
            def ass(j1, j2):
                if j1 == j2:
                    return dgs[j1] * masks[j1] + (1.0 - masks[j1])
                o1, o2 = offsets[j1], offsets[j2]
                rel = tuple(q - w for w, q in zip(o1, o2))
                if rel not in coeff_map:
                    return None  # structural zero
                return cf(rel, o1) * masks[j1] * masks[j2]

            # rhs_i = mask_i (b - A x)_i + (A_SS x_S)_i
            rhs = []
            for i in range(k):
                acc = masks[i] * rs[i]
                for j in range(k):
                    e = ass(i, j) if j <= i else ass(j, i)
                    if e is not None:
                        acc = acc + e * xs[j]
                rhs.append(acc)

            # unrolled Cholesky-Banachiewicz over the static k (every op
            # a subgrid-shaped elementwise op; structural zeros still
            # participate below the diagonal because of fill-in)
            Lf = [[None] * k for _ in range(k)]
            for i in range(k):
                for j in range(i + 1):
                    s = ass(i, j)
                    s = jnp.zeros(cnt, dtype) if s is None else s
                    for t in range(j):
                        s = s - Lf[i][t] * Lf[j][t]
                    if i == j:
                        Lf[i][i] = jnp.sqrt(s)
                    else:
                        Lf[i][j] = s / Lf[j][j]

            # z = L^{-1} rhs; y = L^{-T}(z + eta)
            z = []
            for i in range(k):
                s = rhs[i]
                for j in range(i):
                    s = s - Lf[i][j] * z[j]
                z.append(s / Lf[i][i])
            y = [None] * k
            for i in reversed(range(k)):
                s = z[i] + ets[i]
                for j in range(i + 1, k):
                    s = s - Lf[j][i] * y[j]
                y[i] = s / Lf[i][i]

            # scatter: update member positions inside the (already
            # gathered) super-region with STATIC strided edits, then one
            # dynamic_update_slice writes everything back (3/3).  The
            # outer rr rings of the region are copied back unchanged;
            # same-colour patches are >= m apart, so member positions
            # never collide.
            Ru = Sx
            idx0 = tuple(q for _ in cnt for q in (slice(None), 0))
            for j, o in enumerate(offsets):
                sl = tuple(
                    slice(rr + oo, rr + oo + l) for oo, l in zip(o, L_reg)
                )
                sub = jnp.pad(
                    Ru[sl],
                    [(0, c0 * m - l) for c0, l in zip(cnt, L_reg)],
                )
                v = sub.reshape(tuple(q for c0 in cnt for q in (c0, m)))
                new = jnp.where(masks[j] > 0.5, y[j], v[idx0])
                v = v.at[idx0].set(new)
                back = v.reshape(tuple(c0 * m for c0 in cnt))[
                    tuple(slice(0, l) for l in L_reg)
                ]
                Ru = Ru.at[sl].set(back)
            return jax.lax.dynamic_update_slice(xp, Ru, st)

        xp = jax.lax.fori_loop(0, m**d, pass_body, padg(x), unroll=False)
        return jax.lax.dynamic_slice(xp, (m,) * d, shape)

    def prepare(self, b):
        return None

    def step(self, key, x, b, aux=None):
        if b is None:  # zero-RHS (prior) convention
            b = jnp.zeros_like(x)
        key, sub = jax.random.split(key)
        noises = _draw(sub, self.noise_shapes(), x.dtype)
        return key, self.step_with_noise(x, b, noises)


@pytree_dataclass(meta=("kmax", "ncolors"))
class GraphPatchGibbsSampler:
    """Vertex-star block-Gibbs on an unstructured GraphOperator.

    The graph analogue of :class:`PatchGibbsSampler` — the reference's
    ASMStarPC + cholsampler smoother on unstructured meshes
    (``/root/reference/examples/ex9.py:48-66``).  Patch of node i =
    {i} + neighbours(i).  Setup (host): member lists ELL-padded to the
    max patch size ``kmax`` with a sentinel slot n, and a DISTANCE-4
    greedy colouring (colouring of the cubed adjacency graph) so that
    same-colour patches are mutually uncoupled and member-disjoint —
    one colour pass resamples all its patches simultaneously from
    their exact conditionals.  Runtime: ``lax.scan`` over
    uniformly-padded colour sets; all member accesses are batched
    gathers, A_SS entries are recovered from the ELL rows by one-hot
    column matching, and the (kmax, kmax) systems are factored with
    the same unrolled elementwise Cholesky (structure-of-arrays — no
    ``(..., k, k)`` arrays, see module docstring).
    """

    base: object  # GraphOperator
    members: jax.Array  # (n + 1, kmax) int32, sentinel-padded (slot n)
    member_mask: jax.Array  # (n + 1, kmax) 1.0 for real members
    color_sets: jax.Array  # (ncolors, cmax) int32 centres, sentinel-padded
    kmax: int
    ncolors: int

    @staticmethod
    def create(op) -> "GraphPatchGibbsSampler":
        import numpy as np
        import scipy.sparse as sp

        n = op.n
        vals = np.asarray(op.vals)
        cols = np.asarray(op.cols)
        real = vals != 0.0

        deg = real.sum(axis=1)
        kmax = int(deg.max()) + 1
        members = np.full((n + 1, kmax), n, dtype=np.int32)
        mask = np.zeros((n + 1, kmax), dtype=np.float64)
        members[:n, 0] = np.arange(n, dtype=np.int32)
        mask[:n, 0] = 1.0
        for i in range(n):
            nb = cols[i][real[i]]
            members[i, 1 : 1 + len(nb)] = nb
            mask[i, 1 : 1 + len(nb)] = 1.0

        # distance-4 colouring: same-colour centres farther than 3 hops
        # apart, so patches (radius-1 stars) are uncoupled and disjoint
        rows = np.repeat(np.arange(n), real.sum(axis=1))
        B = sp.csr_matrix(
            (np.ones(len(rows), bool), (rows, cols[real])), shape=(n, n)
        ) + sp.eye(n, dtype=bool, format="csr")
        B3 = ((B @ B) @ B).tocsr()
        from parmgmc_tpu.operators.graph import greedy_coloring

        colors = greedy_coloring(B3.indptr, B3.indices, n)
        ncolors = int(colors.max()) + 1
        cmax = int(np.bincount(colors, minlength=ncolors).max())
        color_sets = np.full((ncolors, cmax), n, dtype=np.int32)
        for c in range(ncolors):
            idx = np.nonzero(colors == c)[0]
            color_sets[c, : len(idx)] = idx

        return GraphPatchGibbsSampler(
            base=op,
            members=jnp.asarray(members),
            member_mask=jnp.asarray(mask, dtype=op.dtype),
            color_sets=jnp.asarray(color_sets),
            kmax=kmax,
            ncolors=ncolors,
        )

    # -- protocol ------------------------------------------------------------
    @property
    def grid_shape(self):
        return (self.base.n,)

    @property
    def dtype(self):
        return self.base.dtype

    def noise_shapes(self):
        return [{"eta": (self.kmax, self.base.n)}]

    def step_with_noise(self, x, b, noises):
        if b is None:  # zero-RHS (prior) convention
            b = jnp.zeros_like(x)
        base = self.base
        n = base.n
        k = self.kmax
        dtype = self.dtype
        eta = noises[0]["eta"]  # (k, n)

        zrow = jnp.zeros((1,), dtype)
        diag_p = jnp.concatenate([base.diag, zrow])
        eta_p = jnp.concatenate([eta, jnp.zeros((k, 1), dtype)], axis=1)
        vals_p = jnp.concatenate(
            [base.vals, jnp.zeros((1, base.vals.shape[1]), dtype)]
        )
        cols_p = jnp.concatenate(
            [base.cols, jnp.full((1, base.cols.shape[1]), n, jnp.int32)]
        )

        def pass_body(x_pad, centers):
            r = b - base.apply(x_pad[:n])
            r_p = jnp.concatenate([r, zrow])

            mem = self.members[centers]  # (cmax, k)
            mask = self.member_mask[centers] * (
                centers < n
            ).astype(dtype)[:, None]

            xs = [x_pad[mem[:, a]] for a in range(k)]
            rs = [r_p[mem[:, a]] for a in range(k)]
            dgs = [diag_p[mem[:, a]] for a in range(k)]
            ets = [eta_p[a][centers] for a in range(k)]
            mks = [mask[:, a] for a in range(k)]
            va = [vals_p[mem[:, a]] for a in range(k)]  # (cmax, w)
            ca = [cols_p[mem[:, a]] for a in range(k)]

            # A_SS entries by one-hot ELL column matching (padding
            # entries carry val 0, sentinel rows are all-zero)
            cache = {}

            def ass(a, bb):
                if a == bb:
                    return dgs[a] * mks[a] + (1.0 - mks[a])
                if (a, bb) in cache:
                    return cache[(a, bb)]
                e = (
                    jnp.sum(
                        va[a] * (ca[a] == mem[:, bb, None]).astype(dtype),
                        axis=1,
                    )
                    * mks[a]
                    * mks[bb]
                )
                cache[(a, bb)] = e
                return e

            rhs = []
            for i in range(k):
                acc = mks[i] * rs[i]
                for j in range(k):
                    acc = acc + (ass(i, j) if j <= i else ass(j, i)) * xs[j]
                rhs.append(acc)

            Lf = [[None] * k for _ in range(k)]
            for i in range(k):
                for j in range(i + 1):
                    s = ass(i, j)
                    for t in range(j):
                        s = s - Lf[i][t] * Lf[j][t]
                    if i == j:
                        Lf[i][i] = jnp.sqrt(s)
                    else:
                        Lf[i][j] = s / Lf[j][j]

            z = []
            for i in range(k):
                s = rhs[i]
                for j in range(i):
                    s = s - Lf[i][j] * z[j]
                z.append(s / Lf[i][i])
            y = [None] * k
            for i in reversed(range(k)):
                s = z[i] + ets[i]
                for j in range(i + 1, k):
                    s = s - Lf[j][i] * y[j]
                y[i] = s / Lf[i][i]

            # scatter: same-colour patches are member-disjoint; sentinel
            # slots all write x_pad[n]'s own value 0 (mask -> old = 0)
            upd = jnp.stack(
                [jnp.where(mks[a] > 0.5, y[a], xs[a]) for a in range(k)],
                axis=1,
            )
            x_pad = x_pad.at[mem.reshape(-1)].set(upd.reshape(-1))
            return x_pad, None

        x_pad = jnp.concatenate([x, zrow])
        x_pad, _ = jax.lax.scan(pass_body, x_pad, self.color_sets)
        return x_pad[:n]

    def prepare(self, b):
        return None

    def step(self, key, x, b, aux=None):
        key, sub = jax.random.split(key)
        noises = _draw(sub, self.noise_shapes(), x.dtype)
        return key, self.step_with_noise(x, b, noises)
