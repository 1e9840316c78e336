"""Human-readable sampler summaries — the PCView analogue.

The reference prints composed-PC configurations through PETSc's viewer
(``-pc_view``): mcgibbs reports colour counts and omega
(``/root/reference/src/pc_mcgibbs.c:257-266``), cholsampler reports
factor nonzeros (``src/pc_chols.c:383-396``), gamgmc recurses into the
per-level smoothers.  Here samplers are frozen pytrees, so the summary
walks the tree and reports the same operational facts: grids, colour
counts, omega/sweep, factor sizes, hierarchy
depth.  Use it to sanity-check a registry-built config without reading
pytrees by hand::

    >>> from parmgmc_tpu import describe
    >>> print(describe(sampler))
"""

from __future__ import annotations

import math

__all__ = ["describe"]


def _fmt_n(n: int) -> str:
    if n >= 1 << 20:
        return f"{n / (1 << 20):.1f}M"
    if n >= 1 << 10:
        return f"{n / (1 << 10):.1f}K"
    return str(n)


def _op_line(op) -> str:
    name = type(op).__name__
    gshape = tuple(getattr(op, "grid_shape", ()))
    n = math.prod(gshape) if gshape else getattr(op, "n", 0)
    extra = ""
    if hasattr(op, "offsets"):
        extra = f", {len(op.offsets) + 1}-point stencil, radius {op.radius}"
    if hasattr(op, "cols"):  # GraphOperator ELL
        extra = f", ELL width {op.cols.shape[-1]}"
    if type(op).__name__ == "LRCOperator":
        k = op.B.shape[-1]
        inner = _op_line(op.base)
        return f"{name}[rank-{k} update of {inner}]"
    return f"{name} {'x'.join(map(str, gshape))} ({_fmt_n(n)} dof{extra})"


def describe(sampler, _indent: int = 0) -> str:
    """Recursive one-screen summary of a composed sampler (see module doc)."""
    pad = "  " * _indent
    t = type(sampler).__name__
    lines = []

    if t == "MGMCSampler":
        lines.append(
            f"{pad}MGMCSampler: {sampler.n_levels} levels, "
            f"{'V' if sampler.gamma == 1 else 'W'}"
            f"({sampler.n_pre},{sampler.n_post})-cycles"
            + (f", {sampler.n_coarse} coarse its" if sampler.n_coarse != 1 else "")
        )
        for l, op in enumerate(sampler.ops):
            lines.append(f"{pad}  level {l}: {_op_line(op)}")
            if l < sampler.n_levels - 1:
                tr = type(sampler.transfers[l]).__name__
                lines.append(
                    f"{pad}    transfer: {tr}; smoother:"
                )
                lines.append(describe(sampler.smoothers[l], _indent + 3))
        lines.append(f"{pad}  coarse solver:")
        lines.append(describe(sampler.coarse, _indent + 2))
    elif t == "GibbsSampler":
        base = sampler.base
        ncolors = 2
        if hasattr(base, "is_star"):
            r = base.radius
            ncolors = (r + 1) if base.is_star() else (r + 1) ** base.ndim
        elif hasattr(base, "color_starts"):
            ncolors = len(base.color_starts) - 1
        lrc = ", low-rank corrected" if sampler.is_lrc else ""
        lines.append(
            f"{pad}GibbsSampler on {_op_line(base)}: {ncolors} colours, "
            f"omega={float(sampler.omega):g}, sweep={sampler.sweep}{lrc}"
        )
    elif t == "CholeskySampler":
        n = sampler.L.shape[0]
        lines.append(
            f"{pad}CholeskySampler: dense factor {n}x{n} "
            f"({_fmt_n(n * (n + 1) // 2)} stored entries)"
        )
    elif t == "PatchGibbsSampler":
        k = len(sampler.patch_offsets)
        d = len(sampler.grid_shape)
        lines.append(
            f"{pad}PatchGibbsSampler on {_op_line(sampler.base)}: "
            f"{k}-node star patches, {sampler.ncolor_base ** d} colours, "
            f"on-the-fly unrolled {k}x{k} Cholesky (SoA)"
        )
    elif t == "SparseCholeskySampler":
        nnzL = sampler._lu.L.nnz
        lines.append(
            f"{pad}SparseCholeskySampler: host-side sparse LDL^T, "
            f"n={_fmt_n(sampler.n)}, nnz(L)={_fmt_n(nnzL)}"
            + (
                f", Matheron posterior (k={len(sampler._lrc['sigma'])})"
                if sampler._lrc is not None
                else ""
            )
        )
    elif t == "GraphPatchGibbsSampler":
        lines.append(
            f"{pad}GraphPatchGibbsSampler on {_op_line(sampler.base)}: "
            f"vertex-star patches (kmax={sampler.kmax}), "
            f"{sampler.ncolors} distance-4 colours, "
            f"on-the-fly unrolled Cholesky (SoA)"
        )
    elif t == "WoodburySampler":
        k = sampler.B.shape[-1]
        lines.append(f"{pad}WoodburySampler: rank-{k} update; inner sampler:")
        lines.append(describe(sampler.sampler, _indent + 1))
    else:
        gshape = tuple(getattr(sampler, "grid_shape", ()))
        lines.append(f"{pad}{t} on grid {'x'.join(map(str, gshape))}")
    return "\n".join(lines)
