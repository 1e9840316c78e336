// Native host-side graph-setup kernels for parmgmc_tpu.
//
// The reference does its sweep/hierarchy setup in C inside PETSc (JP
// colouring MATCOLORINGJP, mc_sor.c:383-395; GAMG aggregation).  The
// device compute path needs none of that at run time, but building the
// colour-blocked ELL operators and aggregation hierarchies for meshes
// with millions of nodes is O(n) pointer-chasing that is slow in
// Python — these routines are the native equivalents, exposed through
// ctypes (see parmgmc_tpu/native/__init__.py) with a pure-Python
// fallback when no toolchain is available.
//
// Build: g++ -O3 -shared -fPIC -o libgraph_setup.so graph_setup.cpp

#include <cstdint>
#include <vector>

extern "C" {

// Greedy distance-1 colouring in natural order (same algorithm as the
// Python fallback, bit-for-bit identical colours).
// indptr: n+1 int64, indices: int32. colors: out, n int32.
// Returns the number of colours.
int32_t pmg_greedy_coloring(int64_t n, const int64_t* indptr,
                            const int32_t* indices, int32_t* colors) {
  std::vector<int32_t> mark;  // colour -> last row that marked it
  mark.reserve(64);
  int32_t ncolors = 0;
  for (int64_t i = 0; i < n; ++i) colors[i] = -1;
  for (int64_t i = 0; i < n; ++i) {
    for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k) {
      int32_t c = colors[indices[k]];
      if (c >= 0) {
        if (c >= (int32_t)mark.size()) mark.resize(c + 1, -1);
        mark[c] = (int32_t)i;
      }
    }
    int32_t c = 0;
    while (c < (int32_t)mark.size() && mark[c] == (int32_t)i) ++c;
    colors[i] = c;
    if (c >= ncolors) ncolors = c + 1;
    if (c >= (int32_t)mark.size()) mark.resize(c + 1, -1);
  }
  return ncolors;
}

// Greedy MIS-style aggregation on a strength graph (two passes, same
// semantics as the Python fallback in operators/aggregation.py).
// Returns the number of aggregates; agg: out, n int64.
int64_t pmg_aggregate(int64_t n, const int64_t* indptr,
                      const int32_t* indices, int64_t* agg) {
  for (int64_t i = 0; i < n; ++i) agg[i] = -1;
  int64_t n_agg = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (agg[i] >= 0) continue;
    bool clean = true;
    for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k)
      if (agg[indices[k]] >= 0) { clean = false; break; }
    if (clean) {
      agg[i] = n_agg;
      for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k)
        agg[indices[k]] = n_agg;
      ++n_agg;
    }
  }
  for (int64_t i = 0; i < n; ++i) {
    if (agg[i] >= 0) continue;
    int64_t hit = -1;
    for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k)
      if (agg[indices[k]] >= 0) { hit = agg[indices[k]]; break; }
    agg[i] = (hit >= 0) ? hit : n_agg++;
  }
  return n_agg;
}

// Pack a CSR matrix (off-diagonal part already extracted) into
// fixed-width ELL: vals (n, w) doubles zero-padded, cols (n, w) int32
// padded with the row index.
void pmg_ell_pack(int64_t n, int64_t w, const int64_t* indptr,
                  const int32_t* indices, const double* data,
                  double* vals, int32_t* cols) {
  for (int64_t i = 0; i < n; ++i) {
    int64_t lo = indptr[i], hi = indptr[i + 1];
    int64_t k = 0;
    for (; k < hi - lo && k < w; ++k) {
      vals[i * w + k] = data[lo + k];
      cols[i * w + k] = indices[lo + k];
    }
    for (; k < w; ++k) {
      vals[i * w + k] = 0.0;
      cols[i * w + k] = (int32_t)i;
    }
  }
}

}  // extern "C"
