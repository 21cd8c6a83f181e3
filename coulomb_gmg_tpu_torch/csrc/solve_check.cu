// The Solve's check on the card: the system matrix's three norms and the
// distribution of the constrained rows
// (coulomb_gmg_tpu_torch/solver/check.py:matrix_norms, distribute_rows).
//
// Replaces no TPU kernel.  The JAX package takes these on the host after
// each solve (numpy over every nonzero: np.bincount, np.add.reduceat; and
// fem/constraints.py:distribute, a Python loop over the constrained rows),
// and so did the port; the card sat idle through it.
//
// matrix_norms reads the system where the solve left it, as the sliced ELL
// of ops/ell.py:Slices (slot k of row C s + j at off[s] + C k + j, C = 32;
// a row's entries first, in CSR order, ascending columns, then slots of
// column 0 and value 0).  A thread a row sums its row's |a| and a^2 in the
// row's order (linf_mat, fro_mat) and, for the column of the same index,
// the |a| of the mirror entries: the pattern is symmetric, so column r
// holds an entry in each row i of row r's columns, and (i, r) is found by
// binary search in row i.  Row r's columns ascend, so column r's sum adds
// its entries in ascending row order: the order of np.bincount over the
// CSR values, whose bits l1_mat keeps.  No nnz-sized temporary, no
// atomics: each block writes its max / max / sum / count to a partial, and
// one block reduces the partials in a fixed order.  A missing mirror is
// counted, and the wrapper raises on it.
//
// distribute_rows: a thread a constrained row writes
//     out[rows[k]] = inhomog[k] + (w[e0] x[c[e0]] + ... + w[e1-1] x[c[e1-1]])
// summed in CSR order from 0.0 into a copy of x (its columns are never
// constrained rows, so reading x and writing out need no order).
//
// Every product and sum is rounded on its own (__dmul_rn, __dadd_rn: no
// fused multiply-add), so the plain versions give the same bits for the
// column and row sums and the distribution; the Frobenius norm's sum of
// squares goes through the blocks' trees, which the plain version does not
// copy, so it agrees with it to rounding.
//
// What bounds it on the H100: memory.  matrix_norms reads each slot's
// int32 column and float64 value once for its row, then log2(width) more
// columns and one value for its mirror, mostly from L2 (the mirror's row is
// a near neighbour in a mesh's numbering); the byte bound counts each
// nonzero's column and value once, what the norms need (PERF.md).  distribute_rows reads
// the constraint CSR once and gathers one x a weight.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSlice = 32;      // ops/ell.py:SLICE
constexpr int kThreads = 256;

// The slot of (row, target) in the sliced ELL, or -1.  A padding slot
// (k > 0, column 0) sorts after every column.
__device__ __forceinline__ long long find_slot(
    const long long* __restrict__ off, const int32_t* __restrict__ cols,
    long long row, int32_t target) {
  const long long s = row / kSlice;
  const long long base = off[s] + row % kSlice;
  const int w = (int)((off[s + 1] - off[s]) / kSlice);
  int lo = 0, hi = w;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const int32_t c = cols[base + (long long)mid * kSlice];
    if (!(mid > 0 && c == 0) && c < target) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  if (lo < w) {
    const long long slot = base + (long long)lo * kSlice;
    const int32_t c = cols[slot];
    if (c == target && !(lo > 0 && c == 0)) return slot;
  }
  return -1;
}

__global__ void matrix_norms_kernel(const long long* __restrict__ off,
                                    const int32_t* __restrict__ cols,
                                    const double* __restrict__ vals,
                                    long long n, double* __restrict__ partial) {
  __shared__ double s_col[kThreads], s_row[kThreads], s_sq[kThreads],
      s_miss[kThreads];
  const int t = threadIdx.x;
  const long long r = blockIdx.x * (long long)kThreads + t;
  double rs = 0.0, cs = 0.0, sq = 0.0, miss = 0.0;
  if (r < n) {
    const long long s = r / kSlice;
    const long long base = off[s] + r % kSlice;
    const int w = (int)((off[s + 1] - off[s]) / kSlice);
    for (int k = 0; k < w; ++k) {
      const long long slot = base + (long long)k * kSlice;
      const int32_t c = cols[slot];
      if (k > 0 && c == 0) break;            // the row's padding
      const double a = fabs(vals[slot]);
      rs = __dadd_rn(rs, a);
      sq = __dadd_rn(sq, __dmul_rn(a, a));
      const long long m =
          (c >= 0 && c < n) ? find_slot(off, cols, c, (int32_t)r) : -1;
      if (m < 0) {
        miss = __dadd_rn(miss, 1.0);
      } else {
        cs = __dadd_rn(cs, fabs(vals[m]));
      }
    }
  }
  s_col[t] = cs;
  s_row[t] = rs;
  s_sq[t] = sq;
  s_miss[t] = miss;
  __syncthreads();
  for (int h = kThreads / 2; h > 0; h >>= 1) {
    if (t < h) {
      s_col[t] = fmax(s_col[t], s_col[t + h]);
      s_row[t] = fmax(s_row[t], s_row[t + h]);
      s_sq[t] = __dadd_rn(s_sq[t], s_sq[t + h]);
      s_miss[t] = __dadd_rn(s_miss[t], s_miss[t + h]);
    }
    __syncthreads();
  }
  if (t == 0) {
    double* p = partial + 4 * (long long)blockIdx.x;
    p[0] = s_col[0];
    p[1] = s_row[0];
    p[2] = s_sq[0];
    p[3] = s_miss[0];
  }
}

// One block: out = (max column sum, max row sum, sqrt(sum of squares),
// missing mirrors), each thread folding the partials t, t + 256, ... in
// turn, then the same tree as above.
__global__ void reduce_norms_kernel(const double* __restrict__ partial,
                                    long long n_blocks,
                                    double* __restrict__ out) {
  __shared__ double s_col[kThreads], s_row[kThreads], s_sq[kThreads],
      s_miss[kThreads];
  const int t = threadIdx.x;
  double cs = 0.0, rs = 0.0, sq = 0.0, miss = 0.0;
  for (long long b = t; b < n_blocks; b += kThreads) {
    const double* p = partial + 4 * b;
    cs = fmax(cs, p[0]);
    rs = fmax(rs, p[1]);
    sq = __dadd_rn(sq, p[2]);
    miss = __dadd_rn(miss, p[3]);
  }
  s_col[t] = cs;
  s_row[t] = rs;
  s_sq[t] = sq;
  s_miss[t] = miss;
  __syncthreads();
  for (int h = kThreads / 2; h > 0; h >>= 1) {
    if (t < h) {
      s_col[t] = fmax(s_col[t], s_col[t + h]);
      s_row[t] = fmax(s_row[t], s_row[t + h]);
      s_sq[t] = __dadd_rn(s_sq[t], s_sq[t + h]);
      s_miss[t] = __dadd_rn(s_miss[t], s_miss[t + h]);
    }
    __syncthreads();
  }
  if (t == 0) {
    out[0] = s_col[0];
    out[1] = s_row[0];
    out[2] = __dsqrt_rn(s_sq[0]);
    out[3] = s_miss[0];
  }
}

__global__ void distribute_rows_kernel(
    const int32_t* __restrict__ rows, const int32_t* __restrict__ indptr,
    const int32_t* __restrict__ cols, const double* __restrict__ w,
    const double* __restrict__ inhomog, const double* __restrict__ x,
    double* __restrict__ out, long long n_con) {
  const long long k = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (k >= n_con) return;
  double acc = 0.0;
  const int32_t end = indptr[k + 1];
  for (int32_t e = indptr[k]; e < end; ++e) {
    acc = __dadd_rn(acc, __dmul_rn(w[e], x[cols[e]]));
  }
  out[rows[k]] = __dadd_rn(inhomog[k], acc);
}

}  // namespace

// partial: 4 * ceil(n / 256) doubles of scratch; out: 4 doubles.
extern "C" int matrix_norms_f64(const void* off, const void* cols,
                                const void* vals, long long n, void* partial,
                                void* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0) {
    matrix_norms_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
        (const long long*)off, (const int32_t*)cols, (const double*)vals, n,
        (double*)partial);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  reduce_norms_kernel<<<1, kThreads, 0, st>>>((const double*)partial, blocks,
                                              (double*)out);
  return (int)cudaGetLastError();
}

extern "C" int distribute_rows_f64(const void* rows, const void* indptr,
                                   const void* cols, const void* w,
                                   const void* inhomog, const void* x,
                                   void* out, long long n_con, void* stream) {
  if (n_con <= 0) return 0;
  const unsigned blocks = (unsigned)((n_con + kThreads - 1) / kThreads);
  distribute_rows_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)rows, (const int32_t*)indptr, (const int32_t*)cols,
      (const double*)w, (const double*)inhomog, (const double*)x,
      (double*)out, n_con);
  return (int)cudaGetLastError();
}
