"""Gmsh meshes and P1 finite-element assembly of Matérn precisions.

Unstructured-mesh analogue of the reference's MS assembly path
(``/root/reference/src/ms.c:84-164``: P1 FE weak form
``kappa^2 u v + grad u . grad v`` on a DMPlex/Gmsh mesh).  Here the mesh
is parsed directly from Gmsh 4.1 ``.msh`` files (triangles in 2D,
tetrahedra in 3D), the stiffness K and consistent mass M are assembled
on the host into scipy CSR, and the precision A = kappa^2 M + K ships
to the device as a colour-blocked GraphOperator.

Also provides ``unit_square_mesh`` for self-contained tests.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

__all__ = [
    "read_gmsh",
    "write_gmsh",
    "mesh_path",
    "unit_square_mesh",
    "masked_grid_mesh",
    "assemble_p1",
    "assemble_p2",
    "matern_precision_mesh",
    "matern_precision_mesh_p2",
    "refine",
    "geometric_mgmc_hierarchy",
    "mesh_observation_mats",
]


def read_gmsh(path):
    """Parse a Gmsh 4.1 ASCII .msh file -> (points (n,d), cells (m,k)).

    Keeps the highest-dimensional elements found (tets if present, else
    triangles); coordinates are truncated to that dimension.
    """
    with open(path) as f:
        lines = f.read().split("\n")
    i = 0

    def until(tag):
        nonlocal i
        while lines[i].strip() != tag:
            i += 1
        i += 1

    until("$Nodes")
    header = lines[i].split()
    i += 1
    num_blocks, num_nodes = int(header[0]), int(header[1])
    max_tag = int(header[3])
    coords = np.zeros((max_tag + 1, 3))
    for _ in range(num_blocks):
        bh = lines[i].split()
        i += 1
        nb = int(bh[3])
        tags = [int(lines[i + k]) for k in range(nb)]
        i += nb
        for k in range(nb):
            xyz = lines[i + k].split()
            coords[tags[k]] = [float(xyz[0]), float(xyz[1]), float(xyz[2])]
        i += nb

    until("$Elements")
    header = lines[i].split()
    i += 1
    num_blocks = int(header[0])
    tris, tets = [], []
    for _ in range(num_blocks):
        bh = lines[i].split()
        i += 1
        etype, nb = int(bh[2]), int(bh[3])
        for k in range(nb):
            parts = lines[i + k].split()
            if etype == 2:
                tris.append([int(p) for p in parts[1:4]])
            elif etype == 4:
                tets.append([int(p) for p in parts[1:5]])
        i += nb

    if tets:
        cells_tagged = np.asarray(tets)
        dim = 3
    elif tris:
        cells_tagged = np.asarray(tris)
        dim = 2
    else:
        raise ValueError("no triangles or tetrahedra found in mesh")

    used = np.unique(cells_tagged)
    remap = np.full(coords.shape[0], -1, dtype=np.int64)
    remap[used] = np.arange(used.size)
    cells = remap[cells_tagged]
    points = coords[used][:, :dim]
    return points, cells


def write_gmsh(path, points, cells):
    """Write (points, cells) as a minimal Gmsh 4.1 ASCII ``.msh`` file.

    One node block + one element block (triangles in 2D, tets in 3D) —
    exactly the subset :func:`read_gmsh` consumes; round-trips bitwise
    on the coordinate text.  Lets the repo ship its OWN mesh assets
    (``data/*.msh``, generated by ``examples/make_meshes.py``) instead
    of reading the reference's read-only data directory
    (reference ships ``/root/reference/data/{wrench,lshape,...}.msh``).
    """
    points = np.asarray(points, dtype=np.float64)
    cells = np.asarray(cells)
    n, d = points.shape
    k = cells.shape[1]
    assert k == d + 1, "cells must be simplices of the point dimension"
    etype = {3: 2, 4: 4}[k]  # gmsh: 2 = tri, 4 = tet
    xyz = np.zeros((n, 3))
    xyz[:, :d] = points
    lines = ["$MeshFormat", "4.1 0 8", "$EndMeshFormat"]
    lines += ["$Nodes", f"1 {n} 1 {n}", f"{d} 1 0 {n}"]
    lines += [str(i + 1) for i in range(n)]
    lines += [f"{p[0]:.16g} {p[1]:.16g} {p[2]:.16g}" for p in xyz]
    lines += ["$EndNodes"]
    lines += ["$Elements", f"1 {len(cells)} 1 {len(cells)}",
              f"{d} 1 {etype} {len(cells)}"]
    lines += [
        str(i + 1) + " " + " ".join(str(v + 1) for v in c)
        for i, c in enumerate(cells)
    ]
    lines += ["$EndElements", ""]
    with open(path, "w") as f:
        f.write("\n".join(lines))


def mesh_path(name: str) -> str:
    """Resolve a mesh asset name ("wrench", "lshape.msh", or a path).

    Order: an existing path as given -> the repo's own ``data/``
    directory -> the reference mount (``/root/reference/data``, kept as
    a fallback only).  Regenerate the repo assets with
    ``python examples/make_meshes.py``.
    """
    import os

    if not name.endswith(".msh"):
        name = name + ".msh"
    if os.path.exists(name):
        return name
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    for root in (os.path.join(here, "data"), "/root/reference/data"):
        p = os.path.join(root, os.path.basename(name))
        if os.path.exists(p):
            return p
    raise FileNotFoundError(
        f"mesh asset {name!r} not found; run `python examples/make_meshes.py`"
    )


def masked_grid_mesh(bbox, h, inside, jitter: float = 0.15, seed: int = 0):
    """Simplicial mesh of an implicit region: Kuhn-subdivided grid cells
    whose centroid satisfies ``inside(points) -> bool mask``, unused
    nodes dropped, interior nodes jittered deterministically.

    The device-side framework only needs *some* family of irregular
    simplicial meshes to exercise the unstructured path (the reference
    gets its wrench/lshape geometries from external CAD + Gmsh, which
    this repo deliberately does not depend on); degree variation comes
    from the masked boundary and the jitter.  2D -> triangles,
    3D -> tets; jitter is capped so Kuhn simplices cannot degenerate.
    """
    bbox = np.asarray(bbox, dtype=np.float64)  # (d, 2)
    d = bbox.shape[0]
    ns = [int(np.ceil((hi - lo) / h)) for lo, hi in bbox]
    axes = [np.linspace(lo, hi, n + 1) for (lo, hi), n in zip(bbox, ns)]
    grids = np.meshgrid(*axes, indexing="ij")
    pts = np.stack([g.ravel() for g in grids], axis=-1)
    shape = tuple(n + 1 for n in ns)

    def nid(idx):  # (..., d) integer coords -> flat node id
        out = idx[..., 0]
        for a in range(1, d):
            out = out * shape[a] + idx[..., a]
        return out

    base = np.stack(
        np.meshgrid(*[np.arange(n) for n in ns], indexing="ij"), axis=-1
    ).reshape(-1, d)  # (ncells, d) lower corners
    if d == 2:
        corner_sets = [
            [(0, 0), (1, 0), (1, 1)],
            [(0, 0), (1, 1), (0, 1)],
        ]
    elif d == 3:
        # Kuhn subdivision: 6 tets per cube along the main diagonal,
        # consistent across faces of neighbouring cells.
        corner_sets = [
            [(0, 0, 0), (1, 0, 0), (1, 1, 0), (1, 1, 1)],
            [(0, 0, 0), (1, 0, 0), (1, 0, 1), (1, 1, 1)],
            [(0, 0, 0), (0, 1, 0), (1, 1, 0), (1, 1, 1)],
            [(0, 0, 0), (0, 1, 0), (0, 1, 1), (1, 1, 1)],
            [(0, 0, 0), (0, 0, 1), (1, 0, 1), (1, 1, 1)],
            [(0, 0, 0), (0, 0, 1), (0, 1, 1), (1, 1, 1)],
        ]
    else:
        raise ValueError("masked_grid_mesh supports d in (2, 3)")
    cells = np.concatenate([
        nid(base[:, None, :] + np.asarray(cs)[None]) for cs in corner_sets
    ], axis=0)
    cent = pts[cells].mean(axis=1)
    cells = cells[np.asarray(inside(cent), bool)]

    used = np.unique(cells)
    remap = np.full(pts.shape[0], -1, dtype=np.int64)
    remap[used] = np.arange(used.size)
    cells = remap[cells]
    pts = pts[used]

    if jitter:
        # boundary nodes = nodes on any grid-box face of the kept region
        # boundary: nodes appearing in few cells move less safely — keep
        # it simple and only jitter nodes strictly inside the region.
        rng = np.random.default_rng(seed)
        off = (rng.random(pts.shape) * 2 - 1) * (jitter * h)
        shifted = pts + off
        keep = np.asarray(inside(shifted), bool) & np.asarray(
            inside(pts), bool
        )
        # cells sharing a node with the bbox hull keep their nodes fixed
        pts = np.where(keep[:, None], shifted, pts)
        # reject any jitter that degenerates a simplex
        X = pts[cells]
        T = np.transpose(X[:, 1:] - X[:, :1], (0, 2, 1))
        det = np.linalg.det(T)
        if np.any(np.abs(det) < 1e-6 * h**d):
            raise ValueError("jitter degenerated a cell; lower `jitter`")
    return pts, cells


def unit_square_mesh(n: int):
    """Structured triangulation of [0,1]^2 with (n+1)^2 nodes (tests)."""
    xs = np.linspace(0, 1, n + 1)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    pts = np.stack([X.ravel(), Y.ravel()], axis=-1)
    cells = []
    for i in range(n):
        for j in range(n):
            v00 = i * (n + 1) + j
            v10 = (i + 1) * (n + 1) + j
            v01 = v00 + 1
            v11 = v10 + 1
            cells.append([v00, v10, v11])
            cells.append([v00, v11, v01])
    return pts, np.asarray(cells)


def assemble_p1(points: np.ndarray, cells: np.ndarray):
    """P1 stiffness K and consistent mass M as scipy CSR (vectorised)."""
    import scipy.sparse as sp

    d = points.shape[1]
    k = cells.shape[1]
    assert k == d + 1, "cells must be simplices of the coordinate dimension"
    ne = cells.shape[0]
    X = points[cells]  # (ne, d+1, d)

    # Edge matrix T: columns x_i - x_0, volume, and barycentric gradients.
    T = np.transpose(X[:, 1:] - X[:, :1], (0, 2, 1))  # (ne, d, d)
    detT = np.linalg.det(T)
    vol = np.abs(detT) / (1.0 if d == 1 else (2.0 if d == 2 else 6.0))
    Tinv = np.linalg.inv(T)  # (ne, d, d)
    # gradients of barycentric coords: lambda_i, i=1..d rows of Tinv;
    # lambda_0 = 1 - sum -> grad = -sum of rows.
    G = np.zeros((ne, d + 1, d))
    G[:, 1:, :] = Tinv
    G[:, 0, :] = -Tinv.sum(axis=1)

    Ke = np.einsum("eid,ejd,e->eij", G, G, vol)  # (ne, d+1, d+1)
    # consistent P1 mass: vol/((d+1)(d+2)) * (1 + delta_ij)
    base = np.ones((d + 1, d + 1)) + np.eye(d + 1)
    Me = vol[:, None, None] * base[None] / ((d + 1) * (d + 2))

    rows = np.repeat(cells, d + 1, axis=1).ravel()
    colS = np.tile(cells, (1, d + 1)).ravel()
    n = points.shape[0]
    K = sp.csr_matrix((Ke.ravel(), (rows, colS)), shape=(n, n))
    M = sp.csr_matrix((Me.ravel(), (rows, colS)), shape=(n, n))
    K.sum_duplicates()
    M.sum_duplicates()
    return K, M


def matern_precision_mesh(points, cells, kappa: float):
    """A = kappa^2 M + K as scipy CSR (the ms.c weak form)."""
    K, M = assemble_p1(points, cells)
    return (kappa**2) * M + K


def assemble_p2(points: np.ndarray, cells: np.ndarray):
    """P2 (CG2) stiffness/mass: (K, M, dof_points) as scipy CSR.

    The reference's benchmark spaces are CG2 (``examples/ex13.py``,
    ``benchmark/problem_petsc.hh``); this assembles the same quadratic
    Lagrange space on simplices.  DOFs = mesh vertices + edge midpoints.
    Basis in barycentric coordinates: vertex phi_i = l_i(2 l_i - 1),
    edge phi_ij = 4 l_i l_j; all element integrals use the EXACT
    simplex monomial formula  int l^alpha = vol * d! * prod(a_k!) /
    (|alpha| + d)!  — the integrands are polynomials of degree <= 4, so
    there is no quadrature error at all.
    """
    import math as _math

    import scipy.sparse as sp

    d = points.shape[1]
    assert cells.shape[1] == d + 1
    ne = cells.shape[0]
    nv = points.shape[0]
    X = points[cells]

    T = np.transpose(X[:, 1:] - X[:, :1], (0, 2, 1))
    vol = np.abs(np.linalg.det(T)) / (1.0 if d == 1 else (2.0 if d == 2 else 6.0))
    Tinv = np.linalg.inv(T)
    G = np.zeros((ne, d + 1, d))
    G[:, 1:, :] = Tinv
    G[:, 0, :] = -Tinv.sum(axis=1)
    GG = np.einsum("eid,ejd->eij", G, G)  # (ne, d+1, d+1)

    # global edge-midpoint dof ids
    locedges = [(i, j) for i in range(d + 1) for j in range(i + 1, d + 1)]
    edge_id = {}
    cell_edofs = np.zeros((ne, len(locedges)), dtype=np.int64)
    pts_extra = []
    for e in range(ne):
        for q, (i, j) in enumerate(locedges):
            a, b = int(cells[e, i]), int(cells[e, j])
            key = (min(a, b), max(a, b))
            if key not in edge_id:
                edge_id[key] = nv + len(pts_extra)
                pts_extra.append(0.5 * (points[a] + points[b]))
            cell_edofs[e, q] = edge_id[key]
    dof_points = np.concatenate([points, np.asarray(pts_extra)], axis=0)
    loc_dofs = np.concatenate([cells, cell_edofs], axis=1)  # (ne, nloc)
    nloc = loc_dofs.shape[1]
    n = dof_points.shape[0]

    # basis value polynomials: list of (monomial exponent tuple, coeff)
    def mono(*pairs):
        m = [0] * (d + 1)
        for idx, p in pairs:
            m[idx] += p
        return tuple(m)

    vals = []
    grads = []  # list of (monomial, coeff, barycentric-gradient index)
    for i in range(d + 1):
        vals.append([(mono((i, 2)), 2.0), (mono((i, 1)), -1.0)])
        grads.append([(mono((i, 1)), 4.0, i), (mono(), -1.0, i)])
    for i, j in locedges:
        vals.append([(mono((i, 1), (j, 1)), 4.0)])
        grads.append([(mono((j, 1)), 4.0, i), (mono((i, 1)), 4.0, j)])

    fact = _math.factorial

    def integral(m):
        """int_simplex prod l_k^{m_k} dV / vol."""
        s = sum(m)
        num = fact(d)
        for mk in m:
            num *= fact(mk)
        return num / fact(s + d)

    def madd(m1, m2):
        return tuple(a + b for a, b in zip(m1, m2))

    Ke = np.zeros((ne, nloc, nloc))
    Me = np.zeros((ne, nloc, nloc))
    for a in range(nloc):
        for b in range(a + 1):
            mv = 0.0
            for m1, c1 in vals[a]:
                for m2, c2 in vals[b]:
                    mv += c1 * c2 * integral(madd(m1, m2))
            Me[:, a, b] = Me[:, b, a] = mv * vol
            kv = np.zeros(ne)
            for m1, c1, g1 in grads[a]:
                for m2, c2, g2 in grads[b]:
                    kv += c1 * c2 * integral(madd(m1, m2)) * GG[:, g1, g2]
            Ke[:, a, b] = Ke[:, b, a] = kv * vol

    rows = np.repeat(loc_dofs, nloc, axis=1).ravel()
    colS = np.tile(loc_dofs, (1, nloc)).ravel()
    K = sp.csr_matrix((Ke.ravel(), (rows, colS)), shape=(n, n))
    M = sp.csr_matrix((Me.ravel(), (rows, colS)), shape=(n, n))
    K.sum_duplicates()
    M.sum_duplicates()
    return K, M, dof_points


def matern_precision_mesh_p2(points, cells, kappa: float):
    """(A, dof_points): the CG2 Matérn precision kappa^2 M + K."""
    K, M, dof_points = assemble_p2(points, cells)
    return (kappa**2) * M + K, dof_points


def refine(points: np.ndarray, cells: np.ndarray, return_transfer: bool = False):
    """Uniform simplex refinement: tri -> 4 tris, tet -> 8 tets.

    The analogue of the reference's mesh-refinement hierarchy setup
    (DMRefineHierarchy in ms.c:310-321 / ex13's refinement weak scaling).
    With ``return_transfer`` also returns the P1 interpolation matrix
    P (n_fine x n_coarse, CSR): kept vertices interpolate as identity,
    edge midpoints as the mean of their edge's endpoints — the exact
    coarse-to-fine embedding of P1 FEM spaces under uniform refinement
    (what Firedrake/PCMG hand PETSc in ex9/assembled_transfer.py).
    """
    d = points.shape[1]
    k = cells.shape[1]
    edge_mid = {}
    pts = [p for p in points]

    def mid(a, b):
        key = (min(a, b), max(a, b))
        if key not in edge_mid:
            edge_mid[key] = len(pts)
            pts.append(0.5 * (points[a] + points[b]))
        return edge_mid[key]

    new_cells = []
    if k == 3:  # triangles
        for a, b, c in cells:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            new_cells += [[a, ab, ca], [ab, b, bc], [ca, bc, c], [ab, bc, ca]]
    elif k == 4:  # tets: 4 corner tets + octahedron split along one diagonal
        for a, b, c, dd in cells:
            ab, ac, ad = mid(a, b), mid(a, c), mid(a, dd)
            bc, bd, cd = mid(b, c), mid(b, dd), mid(c, dd)
            new_cells += [
                [a, ab, ac, ad],
                [b, ab, bc, bd],
                [c, ac, bc, cd],
                [dd, ad, bd, cd],
                # octahedron {ab,ac,ad,bc,bd,cd} split along diagonal ab-cd
                [ab, ac, ad, cd],
                [ab, ac, bc, cd],
                [ab, bc, bd, cd],
                [ab, ad, bd, cd],
            ]
    else:
        raise ValueError("only tri/tet meshes")
    if not return_transfer:
        return np.asarray(pts), np.asarray(new_cells)
    import scipy.sparse as sp

    nc, nf = len(points), len(pts)
    rows = list(range(nc))
    cols = list(range(nc))
    vals = [1.0] * nc
    for (a, b), m in edge_mid.items():
        rows += [m, m]
        cols += [a, b]
        vals += [0.5, 0.5]
    P = sp.csr_matrix((vals, (rows, cols)), shape=(nf, nc))
    return np.asarray(pts), np.asarray(new_cells), P


def geometric_mgmc_hierarchy(op, Ps, dtype=None):
    """(ops, transfers): GEOMETRIC Galerkin hierarchy on a refined mesh.

    ``op`` is the GraphOperator (or LRCOperator over one) assembled on
    the FINEST mesh of a refinement chain; ``Ps`` are the per-refinement
    P1 interpolation matrices (coarse -> fine, original node orderings,
    coarsest refinement first).  Each coarse operator is the EXACT
    Galerkin triple product P^T A P computed in f64 scipy — the
    ``-pc_mg_galerkin both`` contract that MGMC invariance depends on —
    then colour-blocked via ``from_csr``; transfers are re-expressed in
    both levels' internal orderings so device-side cycles never touch
    permutations.  This is the reference's geometric-MG-on-mesh path
    (ex9's Firedrake PCMG + assembled_transfer.py) — higher-quality
    coarse spaces than smoothed aggregation when the refinement chain
    is available.
    """
    import scipy.sparse as sp

    from parmgmc_tpu.operators.graph import GraphOperator, from_csr
    from parmgmc_tpu.operators.lrc import LRCOperator
    from parmgmc_tpu.operators.transfer import sparse_transfer_from_csr

    is_lrc = isinstance(op, LRCOperator)
    base0 = op.base if is_lrc else op
    assert isinstance(base0, GraphOperator)
    if dtype is None:
        dtype = base0.dtype

    def to_csr_orig(g):
        """CSR of g in the ORIGINAL node ordering."""
        n = g.n
        rows = np.repeat(np.arange(n), g.cols.shape[1])
        A = sp.csr_matrix(
            (
                np.asarray(g.vals, np.float64).ravel(),
                (rows, np.asarray(g.cols).ravel()),
            ),
            shape=(n, n),
        )
        A.setdiag(np.asarray(g.diag, np.float64))
        A.eliminate_zeros()
        ip = np.asarray(g.iperm)
        return A[ip][:, ip]  # internal -> original

    ops = [op]
    transfers = []
    A = to_csr_orig(base0)
    fine_perm = np.asarray(base0.perm)
    for P in reversed(Ps):
        Ac = (P.T @ A @ P).tocsr()
        Ac.eliminate_zeros()
        coarse = from_csr(Ac, dtype=dtype)
        P_int = sp.csr_matrix(P[fine_perm][:, np.asarray(coarse.perm)])
        tr = sparse_transfer_from_csr(P_int, dtype=dtype)
        transfers.append(tr)
        if is_lrc:
            cur = ops[-1]
            Bc = jnp.stack(
                [tr.restrict(cur.B[:, k]) for k in range(cur.B.shape[-1])],
                axis=-1,
            )
            ops.append(
                LRCOperator(base=coarse, B=Bc, sigma_inv=cur.sigma_inv)
            )
        else:
            ops.append(coarse)
        A = Ac
        fine_perm = np.asarray(coarse.perm)
    return ops, tuple(transfers)


def mesh_observation_mats(
    points, cells, sigma2, coords, radii, obsvals=None, order: int = 1
):
    """Ball-average observation operators on a mesh (obs.c:135-173).

    Column i = M @ (indicator of ball i / vol(ball i)) with M the
    consistent P1 (or P2 with ``order=2``) mass matrix; S = Sigma^{-1} =
    ones/sigma2; f = B (S * y_obs).  Returned in the mesh's ORIGINAL
    node (resp. CG2 dof) ordering.
    """
    import math as _math

    if order == 2:
        _, M, points = assemble_p2(points, cells)
    else:
        _, M = assemble_p1(points, cells)
    coords = np.asarray(coords, dtype=float)
    radii = np.asarray(radii, dtype=float)
    d = points.shape[1]
    nobs = coords.shape[0]
    cols = []
    for i in range(nobs):
        vol = _math.pi * radii[i] ** 2 if d == 2 else 4 * _math.pi / 3 * radii[i] ** 3
        ind = (
            ((points - coords[i]) ** 2).sum(axis=1) < radii[i] ** 2
        ).astype(float) / vol
        cols.append(M @ ind)
    B = np.stack(cols, axis=-1)
    sigma_inv = np.full(nobs, 1.0 / sigma2)
    f = B @ (sigma_inv * np.asarray(obsvals)) if obsvals is not None else None
    return B, sigma_inv, f
