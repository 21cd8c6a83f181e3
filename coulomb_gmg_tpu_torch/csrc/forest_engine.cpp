// Native topology engine: the performance-critical host-side primitives of
// the mesh/DoF/assembly-plan pipeline (the role deal.II + p4est play for
// the reference application: DoF enumeration, sparsity construction,
// partition-invariant key management — src/step-50.cc:646-731).
//
// The Python layer expresses all topology work through two primitives over
// int64 keys (lattice-linearized vertices/cells/matrix entries):
//   * sort_unique_inverse: sorted unique keys + inverse map (np.unique)
//   * searchsorted / lookup: vectorized binary search
// These dominate host time at large cell counts (hundreds of millions of
// keys per cycle at the 64k-atom scale).  sort_unique_inverse is a
// parallel bucket sort: one histogram pass over the top key bits, a
// parallel scatter into buckets, independent per-bucket std::sorts, and a
// parallel unique-rank fill — no merge phase, near-linear scaling.
//
// Build: make -C native

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

namespace {

struct KV {
  int64_t key;
  int64_t idx;
};

inline bool kv_less(const KV& a, const KV& b) {
  return a.key < b.key || (a.key == b.key && a.idx < b.idx);
}

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

// Always splits (bucket loops do O(total) inner work even when the bucket
// COUNT is small, so the parallel_for element threshold is wrong for them).
template <class F>
void parallel_buckets(int64_t B, F&& f) {
  unsigned T = n_threads();
  if (B < 2 || T < 2) {
    f(0, B, 0);
    return;
  }
  std::vector<std::thread> ts;
  for (unsigned t = 0; t < T; ++t)
    ts.emplace_back([&, t] { f(B * t / T, B * (t + 1) / T, t); });
  for (auto& th : ts) th.join();
}

}  // namespace

extern "C" {

// keys[n] -> sorted_unique (caller-allocated, capacity n), inverse[n]
// (position of keys[i] in the unique array).  Returns the unique count.
int64_t cgmg_sort_unique_inverse(const int64_t* keys, int64_t n,
                                 int64_t* sorted_unique, int64_t* inverse) {
  if (n == 0) return 0;
  const unsigned T = n_threads();

  // key range -> bucket shift for ~8 buckets per thread (power of two)
  int64_t kmin = keys[0], kmax = keys[0];
  {
    std::vector<int64_t> mins(T, keys[0]), maxs(T, keys[0]);
    parallel_for(n, [&](int64_t lo, int64_t hi, unsigned t) {
      int64_t mn = keys[lo], mx = keys[lo];
      for (int64_t i = lo; i < hi; ++i) {
        mn = std::min(mn, keys[i]);
        mx = std::max(mx, keys[i]);
      }
      mins[t] = mn;
      maxs[t] = mx;
    });
    for (unsigned t = 0; t < T; ++t) {
      kmin = std::min(kmin, mins[t]);
      kmax = std::max(kmax, maxs[t]);
    }
  }
  unsigned bucket_bits = 10;  // 1024 buckets
  const int64_t range = kmax - kmin;
  int shift = 0;
  while ((range >> shift) >= (int64_t(1) << bucket_bits)) ++shift;
  const int64_t B = (range >> shift) + 1;

  // histogram per thread
  std::vector<std::vector<int64_t>> hist(T, std::vector<int64_t>(B, 0));
  parallel_for(n, [&](int64_t lo, int64_t hi, unsigned t) {
    auto& h = hist[t];
    for (int64_t i = lo; i < hi; ++i) ++h[(keys[i] - kmin) >> shift];
  });
  // per-(thread,bucket) scatter offsets; bucket-major layout
  std::vector<int64_t> bucket_start(B + 1, 0);
  for (int64_t b = 0; b < B; ++b)
    for (unsigned t = 0; t < T; ++t) bucket_start[b + 1] += hist[t][b];
  for (int64_t b = 0; b < B; ++b) bucket_start[b + 1] += bucket_start[b];
  std::vector<std::vector<int64_t>> offs(T, std::vector<int64_t>(B));
  {
    std::vector<int64_t> cur(bucket_start.begin(), bucket_start.end() - 1);
    for (unsigned t = 0; t < T; ++t)
      for (int64_t b = 0; b < B; ++b) {
        offs[t][b] = cur[b];
        cur[b] += hist[t][b];
      }
  }
  // scatter
  std::vector<KV> buf(n);
  parallel_for(n, [&](int64_t lo, int64_t hi, unsigned t) {
    auto& o = offs[t];
    for (int64_t i = lo; i < hi; ++i) {
      const int64_t b = (keys[i] - kmin) >> shift;
      buf[o[b]++] = {keys[i], i};
    }
  });
  // sort each bucket (parallel over buckets, dynamic-ish split)
  {
    std::vector<std::thread> ts;
    std::vector<int64_t> order(B);
    for (int64_t b = 0; b < B; ++b) order[b] = b;
    // big buckets first for balance
    std::sort(order.begin(), order.end(), [&](int64_t a, int64_t b2) {
      return (bucket_start[a + 1] - bucket_start[a]) >
             (bucket_start[b2 + 1] - bucket_start[b2]);
    });
    std::vector<int64_t> idx_counter(1, 0);
    std::mutex* mtx = new std::mutex;
    for (unsigned t = 0; t < T; ++t)
      ts.emplace_back([&, mtx] {
        for (;;) {
          int64_t k;
          {
            std::lock_guard<std::mutex> g(*mtx);
            if (idx_counter[0] >= B) return;
            k = idx_counter[0]++;
          }
          const int64_t b = order[k];
          std::sort(buf.begin() + bucket_start[b],
                    buf.begin() + bucket_start[b + 1], kv_less);
        }
      });
    for (auto& th : ts) th.join();
    delete mtx;
  }
  // unique-rank: per-bucket unique counts, prefix, then fill
  std::vector<int64_t> uniq_in_bucket(B, 0);
  parallel_buckets(B, [&](int64_t lo, int64_t hi, unsigned) {
    for (int64_t b = lo; b < hi; ++b) {
      int64_t c = 0;
      int64_t prev = INT64_MIN;
      for (int64_t i = bucket_start[b]; i < bucket_start[b + 1]; ++i)
        if (buf[i].key != prev) {
          prev = buf[i].key;
          ++c;
        }
      uniq_in_bucket[b] = c;
    }
  });
  std::vector<int64_t> uniq_base(B + 1, 0);
  for (int64_t b = 0; b < B; ++b)
    uniq_base[b + 1] = uniq_base[b] + uniq_in_bucket[b];
  parallel_buckets(B, [&](int64_t lo, int64_t hi, unsigned) {
    for (int64_t b = lo; b < hi; ++b) {
      int64_t u = uniq_base[b] - 1;
      int64_t prev = INT64_MIN;
      for (int64_t i = bucket_start[b]; i < bucket_start[b + 1]; ++i) {
        if (buf[i].key != prev) {
          prev = buf[i].key;
          sorted_unique[++u] = prev;
        }
        inverse[buf[i].idx] = u;
      }
    }
  });
  return uniq_base[B];
}

// Fused CSR-pattern builder for Q1 assembly plans.
//
// Enumerates the (row, col) pairs of the system/level sparsity in place —
// the clean cells' nb x nb cross products are IMPLICIT (generated from
// cell2dof on the fly, never materialized host-side), explicit extra pairs
// (constraint-expanded dirty-cell entries + regularization diagonals)
// follow — then performs one parallel bucket sort + unique over the
// composite key row*n+col and emits:
//   indptr[n+1], indices[nnz] (CSR pattern), inverse[total]
//   (data position of every enumerated pair, in enumeration order).
// Returns nnz.  This replaces the reference's deal.II
// make_sparsity_pattern + ConstraintMatrix::distribute_local_to_global
// position resolution (src/step-50.cc:699-731) with a single fused pass.
int64_t cgmg_pattern(const int64_t* c2d, int64_t m, int64_t nb,
                     const int64_t* erows, const int64_t* ecols, int64_t k,
                     int64_t n, int64_t* indptr, int64_t* indices,
                     int64_t* inverse) {
  const int64_t nb2 = nb * nb;
  const int64_t mq = m * nb2;
  const int64_t total = mq + k;
  if (total == 0) {
    for (int64_t i = 0; i <= n; ++i) indptr[i] = 0;
    return 0;
  }
  const unsigned T = n_threads();

  // bucket by top key bits (keys are in [0, n*n))
  unsigned bucket_bits = 11;  // 2048 buckets
  __int128 range128 = (__int128)n * n;
  int shift = 0;
  while ((range128 >> shift) > (int64_t(1) << bucket_bits)) ++shift;
  const int64_t B = int64_t(range128 >> shift) + 1;

  // visit every enumerated pair with its index — strength-reduced cell
  // loops (a per-pair i/nb2, rem/nb, rem%nb key_of costs ~2 int64
  // divisions per visit and dominated the histogram+scatter passes)
  auto visit_range = [&](int64_t lo, int64_t hi, auto&& fn) {
    int64_t i = lo;
    if (i < mq) {
      int64_t c = i / nb2;
      int64_t rem = i - c * nb2;
      int64_t ii = rem / nb, jj = rem - (rem / nb) * nb;
      const int64_t stop = std::min(hi, mq);
      while (i < stop) {
        const int64_t* row = c2d + c * nb;
        const int64_t rbase = row[ii] * n;
        for (; jj < nb && i < stop; ++jj, ++i) fn(i, rbase + row[jj]);
        if (jj == nb) {
          jj = 0;
          if (++ii == nb) { ii = 0; ++c; }
        }
      }
    }
    for (; i < hi; ++i) {
      const int64_t j = i - mq;
      fn(i, erows[j] * n + ecols[j]);
    }
  };

  std::vector<std::vector<int64_t>> hist(T, std::vector<int64_t>(B, 0));
  parallel_for(total, [&](int64_t lo, int64_t hi, unsigned t) {
    auto& h = hist[t];
    visit_range(lo, hi, [&](int64_t, int64_t key) { ++h[key >> shift]; });
  });
  std::vector<int64_t> bucket_start(B + 1, 0);
  for (int64_t b = 0; b < B; ++b)
    for (unsigned t = 0; t < T; ++t) bucket_start[b + 1] += hist[t][b];
  for (int64_t b = 0; b < B; ++b) bucket_start[b + 1] += bucket_start[b];
  std::vector<std::vector<int64_t>> offs(T, std::vector<int64_t>(B));
  {
    std::vector<int64_t> cur(bucket_start.begin(), bucket_start.end() - 1);
    for (unsigned t = 0; t < T; ++t)
      for (int64_t b = 0; b < B; ++b) {
        offs[t][b] = cur[b];
        cur[b] += hist[t][b];
      }
  }
  std::vector<KV> buf(total);
  parallel_for(total, [&](int64_t lo, int64_t hi, unsigned t) {
    auto& o = offs[t];
    visit_range(lo, hi, [&](int64_t i, int64_t key) {
      buf[o[key >> shift]++] = {key, i};
    });
  });
  {
    std::vector<std::thread> ts;
    std::vector<int64_t> order(B);
    for (int64_t b = 0; b < B; ++b) order[b] = b;
    std::sort(order.begin(), order.end(), [&](int64_t a, int64_t b2) {
      return (bucket_start[a + 1] - bucket_start[a]) >
             (bucket_start[b2 + 1] - bucket_start[b2]);
    });
    std::vector<int64_t> idx_counter(1, 0);
    std::mutex* mtx = new std::mutex;
    for (unsigned t = 0; t < T; ++t)
      ts.emplace_back([&, mtx] {
        for (;;) {
          int64_t kk;
          {
            std::lock_guard<std::mutex> g(*mtx);
            if (idx_counter[0] >= B) return;
            kk = idx_counter[0]++;
          }
          const int64_t b = order[kk];
          std::sort(buf.begin() + bucket_start[b],
                    buf.begin() + bucket_start[b + 1], kv_less);
        }
      });
    for (auto& th : ts) th.join();
    delete mtx;
  }
  std::vector<int64_t> uniq_in_bucket(B, 0);
  parallel_buckets(B, [&](int64_t lo, int64_t hi, unsigned) {
    for (int64_t b = lo; b < hi; ++b) {
      int64_t c = 0;
      int64_t prev = INT64_MIN;
      for (int64_t i = bucket_start[b]; i < bucket_start[b + 1]; ++i)
        if (buf[i].key != prev) {
          prev = buf[i].key;
          ++c;
        }
      uniq_in_bucket[b] = c;
    }
  });
  std::vector<int64_t> uniq_base(B + 1, 0);
  for (int64_t b = 0; b < B; ++b)
    uniq_base[b + 1] = uniq_base[b] + uniq_in_bucket[b];
  const int64_t nnz = uniq_base[B];
  // Fill indices (= key % n) and inverse; row counts accumulate straight
  // into the caller's indptr.  Unique keys within a bucket are sorted, so
  // same-row entries form runs — one relaxed atomic add per (bucket, row)
  // run (~nnz/row_degree + B atomics total).  Atomic because a row's keys
  // can straddle a bucket (hence thread) boundary.  This replaces the
  // former T x (n+1) per-thread count arrays (which transiently doubled
  // peak host memory at large n: ~2.5 GB at 10M dofs) and their serial
  // O(n*T) reduction.
  parallel_for(n + 1, [&](int64_t lo, int64_t hi, unsigned) {
    std::memset(indptr + lo, 0, (hi - lo) * sizeof(int64_t));
  });
  parallel_buckets(B, [&](int64_t lo, int64_t hi, unsigned) {
    for (int64_t b = lo; b < hi; ++b) {
      int64_t u = uniq_base[b] - 1;
      int64_t prev = INT64_MIN;
      int64_t run_row = -1, run = 0;
      for (int64_t i = bucket_start[b]; i < bucket_start[b + 1]; ++i) {
        if (buf[i].key != prev) {
          prev = buf[i].key;
          ++u;
          indices[u] = prev % n;
          const int64_t row = prev / n;
          if (row != run_row) {
            if (run)
              __atomic_fetch_add(&indptr[run_row + 1], run,
                                 __ATOMIC_RELAXED);
            run_row = row;
            run = 0;
          }
          ++run;
        }
        inverse[buf[i].idx] = u;
      }
      if (run)
        __atomic_fetch_add(&indptr[run_row + 1], run, __ATOMIC_RELAXED);
    }
  });
  for (int64_t r = 0; r < n; ++r) indptr[r + 1] += indptr[r];
  return nnz;
}

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

// Dirty-cell constraint-expansion cross products (fem/assembly.py
// _expand_entries): for each cell segment [cell_off[c], cell_off[c+1])
// of expanded (dof, weight, local-i) triples, emit the full cartesian
// product — the matrix-entry stream of deal.II's
// distribute_local_to_global for constrained cells.  Pair p of segment c
// (a-major, b-minor) writes
//   m_cell[p]=c (LOCAL id), m_i=exp_i[a], m_j=exp_i[b],
//   m_w=exp_w[a]*exp_w[b], m_row=exp_dof[a], m_col=exp_dof[b]
// at position pair_start[c] + .. (pair_start = prefix of seg_len^2,
// caller-computed).  Parallel over cells, disjoint writes, no temporaries
// — the numpy construction is ~8 passes over six 8M-entry arrays.
void cgmg_cross_gather(const int64_t* cell_off, int64_t n_seg,
                       const int64_t* pair_start, const int64_t* exp_i,
                       const double* exp_w, const int64_t* exp_dof,
                       int64_t* m_cell, int64_t* m_i, int64_t* m_j,
                       double* m_w, int64_t* m_row, int64_t* m_col) {
  parallel_buckets(n_seg, [&](int64_t clo, int64_t chi, unsigned) {
    for (int64_t c = clo; c < chi; ++c) {
      const int64_t s = cell_off[c], e = cell_off[c + 1];
      int64_t p = pair_start[c];
      for (int64_t a = s; a < e; ++a) {
        const int64_t ia = exp_i[a], da = exp_dof[a];
        const double wa = exp_w[a];
        for (int64_t b = s; b < e; ++b, ++p) {
          m_cell[p] = c;
          m_i[p] = ia;
          m_j[p] = exp_i[b];
          m_w[p] = wa * exp_w[b];
          m_row[p] = da;
          m_col[p] = exp_dof[b];
        }
      }
    }
  });
}

// vectorized lower_bound of q[m] in sorted[n]
void cgmg_searchsorted(const int64_t* sorted, int64_t n, const int64_t* q,
                       int64_t m, int64_t* out) {
  parallel_for(m, [&](int64_t lo, int64_t hi, unsigned) {
    for (int64_t i = lo; i < hi; ++i)
      out[i] = std::lower_bound(sorted, sorted + n, q[i]) - sorted;
  });
}

// fused lookup: position in sorted unique keys or -1 when absent
void cgmg_lookup(const int64_t* sorted, int64_t n, const int64_t* q,
                 int64_t m, int64_t* out) {
  parallel_for(m, [&](int64_t lo, int64_t hi, unsigned) {
    for (int64_t i = lo; i < hi; ++i) {
      const int64_t* it = std::lower_bound(sorted, sorted + n, q[i]);
      out[i] = (it != sorted + n && *it == q[i]) ? (it - sorted) : -1;
    }
  });
}

// Threaded bincount: out[pos[p]] += w[p] (out caller-zeroed, length n_out).
// numpy's np.bincount is single-threaded and dominates assembly at the
// 64k-atom scale (118M weights per system matrix); here each thread
// accumulates a slice of the entries into a private partial array and the
// partials tree-reduce — deterministic within each output bin because
// every partial sums its entries in enumeration order and the reduction
// order over threads is fixed.
void cgmg_scatter_add(const int64_t* pos, const double* w, int64_t n,
                      double* out, int64_t n_out) {
  const unsigned T = n_threads();
  if (n < (1 << 18) || T < 2) {
    for (int64_t p = 0; p < n; ++p) out[pos[p]] += w[p];
    return;
  }
  std::vector<std::vector<double>> partials(T);
  parallel_for(n, [&](int64_t lo, int64_t hi, unsigned t) {
    auto& acc = partials[t];
    acc.assign(n_out, 0.0);
    for (int64_t p = lo; p < hi; ++p) acc[pos[p]] += w[p];
  });
  parallel_for(n_out, [&](int64_t lo, int64_t hi, unsigned) {
    for (unsigned t = 0; t < T; ++t) {
      const double* acc = partials[t].data();
      for (int64_t i = lo; i < hi; ++i) out[i] += acc[i];
    }
  });
}

// Threaded block gather: out[r*stride + s] = src[idx[r]*stride + s]
// (numpy fancy indexing of (n_cells, nb, nb) element tensors is
// single-threaded and copies ~118 MB per system assembly at 64k atoms).
void cgmg_gather_blocks(const double* src, const int64_t* idx, int64_t n_idx,
                        int64_t stride, double* out) {
  parallel_for(n_idx, [&](int64_t lo, int64_t hi, unsigned) {
    for (int64_t r = lo; r < hi; ++r)
      std::memcpy(out + r * stride, src + idx[r] * stride,
                  sizeof(double) * stride);
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

// dtype-agnostic variant (rows as raw bytes) — per-cell atom LISTS are
// int32 and 2.2 GB at the 64k-atom scale; their child-inherits-parent
// migration (src/step-50.cc:441-456) is a row gather of that buffer.
void cgmg_gather_rows_bytes(const char* src, const int64_t* idx,
                            int64_t n_idx, int64_t row_bytes, char* out) {
  parallel_for(n_idx, [&](int64_t lo, int64_t hi, unsigned) {
    for (int64_t r = lo; r < hi; ++r)
      std::memcpy(out + r * row_bytes, src + idx[r] * row_bytes, row_bytes);
  });
}

}  // extern "C"
