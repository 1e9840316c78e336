"""ctypes loader for the native graph-setup library.

Compiles ``graph_setup.cpp`` on first use (cached as a .so next to the
source); every entry point has a pure-Python fallback so the package
works without a toolchain.  ``lib()`` returns None when unavailable.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_LOCK = threading.Lock()
_LIB = None
_TRIED = False

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "graph_setup.cpp")
_SO = os.path.join(_DIR, "libgraph_setup.so")


def lib():
    """The loaded ctypes library, or None if unavailable."""
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        try:
            if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(
                _SRC
            ):
                subprocess.run(
                    ["g++", "-O3", "-shared", "-fPIC", "-o", _SO, _SRC],
                    check=True,
                    capture_output=True,
                )
            L = ctypes.CDLL(_SO)
            i64p = ctypes.POINTER(ctypes.c_int64)
            i32p = ctypes.POINTER(ctypes.c_int32)
            f64p = ctypes.POINTER(ctypes.c_double)
            L.pmg_greedy_coloring.restype = ctypes.c_int32
            L.pmg_greedy_coloring.argtypes = [ctypes.c_int64, i64p, i32p, i32p]
            L.pmg_aggregate.restype = ctypes.c_int64
            L.pmg_aggregate.argtypes = [ctypes.c_int64, i64p, i32p, i64p]
            L.pmg_ell_pack.restype = None
            L.pmg_ell_pack.argtypes = [
                ctypes.c_int64,
                ctypes.c_int64,
                i64p,
                i32p,
                f64p,
                f64p,
                i32p,
            ]
            _LIB = L
        except Exception:
            _LIB = None
        return _LIB


def _ptr(a, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def greedy_coloring_native(indptr, indices, n):
    L = lib()
    if L is None:
        return None
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    colors = np.empty(n, dtype=np.int32)
    L.pmg_greedy_coloring(
        n, _ptr(indptr, ctypes.c_int64), _ptr(indices, ctypes.c_int32),
        _ptr(colors, ctypes.c_int32),
    )
    return colors


def aggregate_native(indptr, indices, n):
    L = lib()
    if L is None:
        return None
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    agg = np.empty(n, dtype=np.int64)
    n_agg = L.pmg_aggregate(
        n, _ptr(indptr, ctypes.c_int64), _ptr(indices, ctypes.c_int32),
        _ptr(agg, ctypes.c_int64),
    )
    return agg, int(n_agg)


_SOR_SRC = os.path.join(_DIR, "ref_sor_bench.cpp")
_SOR_SO = os.path.join(_DIR, "libref_sor_bench.so")
_SOR_LIB = None
_SOR_TRIED = False


def ref_sor_bench(n: int, nsweeps: int = 8, kappa2: float = 1.0,
                  omega: float = 1.0):
    """Time the reference's CSR red/black SOR hot loop on one host core.

    Returns (n_dof, sec_per_sweep, sec_per_noise_fill) or None if no
    toolchain is available.  Used to anchor bench.py's vs_baseline in a
    measured number (BASELINE.md)."""
    if _sor_lib() is None:
        return None
    hinv2 = float((n + 1) ** 2)  # unit-domain FD scaling
    sweep = ctypes.c_double()
    fill = ctypes.c_double()
    ndof = _SOR_LIB.pmg_ref_sor_bench(
        n, nsweeps, kappa2, hinv2, omega,
        ctypes.byref(sweep), ctypes.byref(fill),
    )
    return int(ndof), float(sweep.value), float(fill.value)


def _sor_lib():
    """Load (building if needed) the SOR-bench library; None if no
    toolchain.  Shared by the structured and CSR entry points."""
    global _SOR_LIB, _SOR_TRIED
    with _LOCK:
        if not _SOR_TRIED:
            _SOR_TRIED = True
            try:
                if not os.path.exists(_SOR_SO) or os.path.getmtime(
                    _SOR_SO
                ) < os.path.getmtime(_SOR_SRC):
                    subprocess.run(
                        ["g++", "-O3", "-shared", "-fPIC", "-o", _SOR_SO,
                         _SOR_SRC],
                        check=True,
                        capture_output=True,
                    )
                L = ctypes.CDLL(_SOR_SO)
                f64p = ctypes.POINTER(ctypes.c_double)
                i64p = ctypes.POINTER(ctypes.c_int64)
                i32p = ctypes.POINTER(ctypes.c_int32)
                L.pmg_ref_sor_bench.restype = ctypes.c_int64
                L.pmg_ref_sor_bench.argtypes = [
                    ctypes.c_int64, ctypes.c_int64, ctypes.c_double,
                    ctypes.c_double, ctypes.c_double, f64p, f64p,
                ]
                L.pmg_ref_sor_bench_csr.restype = ctypes.c_int64
                L.pmg_ref_sor_bench_csr.argtypes = [
                    ctypes.c_int64, i64p, i32p, f64p, f64p,
                    ctypes.c_int64, ctypes.c_double, f64p, f64p,
                ]
                _SOR_LIB = L
            except Exception:
                _SOR_LIB = None
    return _SOR_LIB


def ref_sor_bench_csr(A_csr, nsweeps: int = 8, omega: float = 1.0):
    """Time the reference's multicolour CSR SOR hot loop on a
    caller-provided matrix (colour-blocked row order — pass
    ``GraphOperator.to_csr()``), one host core.

    Returns (n, sec_per_sweep, sec_per_noise_fill) or None without a
    toolchain.  Anchors the UNSTRUCTURED benchmark's vs_baseline
    (examples/benchmark_matern.py --anchor-ranks)."""
    import scipy.sparse as sp

    L = _sor_lib()
    if L is None:
        return None
    A = sp.csr_matrix(A_csr)
    n = A.shape[0]
    diag = np.ascontiguousarray(A.diagonal(), dtype=np.float64)
    Aoff = (A - sp.diags(diag)).tocsr()
    Aoff.eliminate_zeros()
    rowptr = np.ascontiguousarray(Aoff.indptr, dtype=np.int64)
    col = np.ascontiguousarray(Aoff.indices, dtype=np.int32)
    val = np.ascontiguousarray(Aoff.data, dtype=np.float64)
    sweep = ctypes.c_double()
    fill = ctypes.c_double()
    ndof = L.pmg_ref_sor_bench_csr(
        n, _ptr(rowptr, ctypes.c_int64), _ptr(col, ctypes.c_int32),
        _ptr(val, ctypes.c_double), _ptr(diag, ctypes.c_double),
        nsweeps, omega, ctypes.byref(sweep), ctypes.byref(fill),
    )
    return int(ndof), float(sweep.value), float(fill.value)


def ell_pack_native(indptr, indices, data, n, w):
    L = lib()
    if L is None:
        return None
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int32)
    data = np.ascontiguousarray(data, dtype=np.float64)
    vals = np.empty((n, w), dtype=np.float64)
    cols = np.empty((n, w), dtype=np.int32)
    L.pmg_ell_pack(
        n, w, _ptr(indptr, ctypes.c_int64), _ptr(indices, ctypes.c_int32),
        _ptr(data, ctypes.c_double), _ptr(vals, ctypes.c_double),
        _ptr(cols, ctypes.c_int32),
    )
    return vals, cols
