// Native host engine: the two host-side primitives of the port that run
// over every cell or every matrix row in threaded C++ (numpy would take one
// single-threaded pass per gather or scatter):
//   * cgmg_atom_lists: the atom-cell locality lists (ops/neighbors.py);
//   * cgmg_csr_to_sliced: a CSR matrix into the sliced ELL layout
//     (ops/ell.py).
// utils/native.py builds it with g++ at first use and binds it by ctypes;
// without it each caller takes a numpy path.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

unsigned n_threads() {
  unsigned hw = std::thread::hardware_concurrency();
  return hw ? std::min(hw, 32u) : 1;
}

template <class F>
void parallel_for(int64_t n, F&& f) {
  unsigned T = n_threads();
  if (n < (1 << 15) || T < 2) {
    f(0, n, 0);
    return;
  }
  std::vector<std::thread> ts;
  for (unsigned t = 0; t < T; ++t)
    ts.emplace_back([&, t] { f(n * t / T, n * (t + 1) / T, t); });
  for (auto& th : ts) th.join();
}

}  // namespace

extern "C" {

// Atom-cell locality lists (the reference's rhs_assembly_optimization,
// src/step-50.cc:260-306 — its single most expensive stage at 64k atoms).
// Atoms are pre-bucketed on a uniform grid of pitch >= cutoff (host side);
// each cell probes the buckets overlapped by its cutoff-inflated bounding
// box and applies the exact corner-distance criterion
//   min_v |x - v|^2 = sum_d min((x_d - lo_d)^2, (x_d - lo_d - h)^2) < c^2.
// Two-phase: K == 0 -> fill counts only; K > 0 -> also fill the padded
// (m, K) int32 list matrix (-1 padding), candidates emitted in bucket
// order (deterministic).  Parallel over cells, no temporaries.
void cgmg_atom_lists(const double* lower, const double* hh, int64_t m,
                     int64_t dim, const double* spos, const int64_t* aorder,
                     const int64_t* bstarts, const int64_t* bshape,
                     const double* borigin, double pitch, double cutoff,
                     int64_t K, int32_t* lists, int64_t* counts) {
  const double c2 = cutoff * cutoff;
  parallel_for(m, [&](int64_t clo, int64_t chi, unsigned) {
    int64_t blo[3], bhi[3], bi[3];
    for (int64_t c = clo; c < chi; ++c) {
      const double* l = lower + c * dim;
      const double h = hh[c];
      for (int64_t d = 0; d < dim; ++d) {
        int64_t a = (int64_t)std::floor((l[d] - cutoff - borigin[d]) / pitch);
        int64_t b = (int64_t)std::floor((l[d] + h + cutoff - borigin[d]) / pitch);
        blo[d] = std::min(std::max(a, int64_t(0)), bshape[d] - 1);
        bhi[d] = std::min(std::max(b, int64_t(0)), bshape[d] - 1);
        bi[d] = blo[d];
      }
      int64_t cnt = 0;
      for (;;) {
        int64_t lin = bi[0];
        for (int64_t d = 1; d < dim; ++d) lin = lin * bshape[d] + bi[d];
        for (int64_t a = bstarts[lin]; a < bstarts[lin + 1]; ++a) {
          const double* p = spos + a * dim;
          double d2 = 0.0;
          for (int64_t d = 0; d < dim; ++d) {
            const double u = p[d] - l[d];
            const double v = u - h;
            d2 += std::min(u * u, v * v);
          }
          if (d2 < c2) {
            if (K > 0 && cnt < K) lists[c * K + cnt] = (int32_t)aorder[a];
            ++cnt;
          }
        }
        // advance the dim-dimensional bucket-box iterator
        int64_t d = dim - 1;
        for (; d >= 0; --d) {
          if (++bi[d] <= bhi[d]) break;
          bi[d] = blo[d];
        }
        if (d < 0) break;
      }
      counts[c] = cnt;
    }
  });
}

// CSR -> sliced ELL (caller-zeroed flat outputs; value slots memcpy
// dtype-agnostically, columns narrow int64 -> int32): slot k of row r goes
// to off[r / c] + c * k + r % c, the row's entries in CSR order.  The numpy
// equivalent (repeat + fancy scatters over every nonzero) is single-threaded.
void cgmg_csr_to_sliced(const int64_t* indptr, const int64_t* indices,
                        const char* data, int64_t itemsize, int64_t n_rows,
                        int64_t c, const int64_t* off, int32_t* scols,
                        char* svals) {
  parallel_for(n_rows, [&](int64_t lo, int64_t hi, unsigned) {
    for (int64_t r = lo; r < hi; ++r) {
      const int64_t s = indptr[r], e = indptr[r + 1];
      const int64_t base = off[r / c] + r % c;
      for (int64_t p = s; p < e; ++p) {
        const int64_t t = base + c * (p - s);
        scols[t] = (int32_t)indices[p];
        std::memcpy(svals + t * itemsize, data + p * itemsize, itemsize);
      }
    }
  });
}

}  // extern "C"
