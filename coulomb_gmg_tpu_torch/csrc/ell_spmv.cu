// ELL sparse matrix-vector product in the transposed (K, n_rows) layout.
//
// Replaces the Pallas kernel coulomb_gmg_tpu/ops/ell.py:_ell_kernel and its
// jnp stand-in coulomb_gmg_tpu/solver/tpu_gmg.py:_ell_mv_t, which carried
// every level-operator apply of the GMG V-cycle on the TPU:
//
//     y[i] = sum_k vals[k * n_rows + i] * x[cols[k * n_rows + i]]
//
// Padding slots carry value 0 and a valid column, so no slot is skipped.
//
// What bounds it on the H100: memory bandwidth.  A row reads (4 + 4) * K
// bytes of cols and vals (K = 27 for level, interface and restriction
// operators, 8 for prolongation, 1 to 12 for the constraint tables) plus K
// gathered entries of x, for 2 * K flops: far below the card's
// flop-per-byte balance point.
//
// What the design does about it: one thread per row, and the (K, n_rows)
// layout makes neighbouring threads read neighbouring addresses of cols and
// vals for each k, so those loads coalesce into full 128-byte transactions.
//   - K = 27, the width of the level, interface and restriction operators
//     and of most launches of a solve, is a template argument, so the loop
//     is unrolled and the compiler issues the loads of many slots ahead of
//     the FMA chain that consumes them (32 registers, about 20 loads in
//     flight per row), not one dependent load pair after another.  Other K
//     (8 for prolongation, 1 to 12 for the constraint tables, on operators
//     small enough that the launch sets their time) take a loop in steps
//     of 4 slots.
//   - cols and vals are read once, so they are loaded with the streaming
//     (evict-first) cache policy: they pass through L2 without pushing out
//     x, which the gathers of neighbouring rows read again (x is 2.1 MB in
//     float32 at 531k rows, L2 is 50 MB).  The loads also ask L2 to fetch
//     256 bytes per miss: each warp reads 128 bytes of each of 2 K
//     streams, and the neighbouring warp wants the next 128.  The gather
//     goes through the read-only data path (__ldg).
// At K = 27, 531,442 rows streaming the same bytes with no gather at all
// is hardly faster (PERF.md); staging (K, rows) slabs in shared memory
// with bulk asynchronous copies (a 2-stage pipeline) and two or four rows
// per thread were slower.
// The sum runs in k order as one FMA chain in a register, the chain of the
// earlier loop kernel, so the result has the same bits; there are no
// atomics, so it is deterministic.  The kernel allocates nothing and
// launches on the stream it is given.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// A load of data read once: streaming (evict-first), 256-byte L2 fetch.
__device__ __forceinline__ int ld_stream(const int* p) {
  int v;
  asm("ld.global.cs.L2::256B.s32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ float ld_stream(const float* p) {
  float v;
  asm("ld.global.cs.L2::256B.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ double ld_stream(const double* p) {
  double v;
  asm("ld.global.cs.L2::256B.f64 %0, [%1];" : "=d"(v) : "l"(p));
  return v;
}

// y[i] for a K known at compile time: every load first, then the chain.
template <typename T, int K>
__device__ __forceinline__ T row_fixed(const int* __restrict__ cols,
                                       const T* __restrict__ vals,
                                       const T* __restrict__ x,
                                       long long n_rows, long long i) {
  int c[K];
  T v[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    c[k] = ld_stream(cols + k * n_rows + i);
    v[k] = ld_stream(vals + k * n_rows + i);
  }
  T g[K];
#pragma unroll
  for (int k = 0; k < K; ++k) g[k] = __ldg(x + c[k]);
  T acc = T(0);
#pragma unroll
  for (int k = 0; k < K; ++k) acc += v[k] * g[k];
  return acc;
}

// y[i] for any K: steps of 4 slots, then the rest, in k order.
template <typename T>
__device__ __forceinline__ T row_any(const int* __restrict__ cols,
                                     const T* __restrict__ vals,
                                     const T* __restrict__ x, int K,
                                     long long n_rows, long long i) {
  T acc = T(0);
  int k = 0;
  for (; k + 4 <= K; k += 4) {
    int c[4];
    T v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      c[j] = ld_stream(cols + (k + j) * n_rows + i);
      v[j] = ld_stream(vals + (k + j) * n_rows + i);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) acc += v[j] * __ldg(x + c[j]);
  }
  for (; k < K; ++k) {
    const long long o = k * n_rows + i;
    acc += ld_stream(vals + o) * __ldg(x + ld_stream(cols + o));
  }
  return acc;
}

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
ell_spmv_kernel(const int* __restrict__ cols, const T* __restrict__ vals,
                const T* __restrict__ x, T* __restrict__ y, int k_any,
                long long n_rows) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads
                      + threadIdx.x;
  if (i >= n_rows) return;
  if constexpr (K > 0)
    y[i] = row_fixed<T, K>(cols, vals, x, n_rows, i);
  else
    y[i] = row_any<T>(cols, vals, x, k_any, n_rows, i);
}

template <typename T, int K>
int go(unsigned grid, cudaStream_t s, const int* c, const T* v, const T* x,
       T* y, int k_any, long long n_rows) {
  ell_spmv_kernel<T, K><<<grid, kThreads, 0, s>>>(c, v, x, y, k_any, n_rows);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* cols, const void* vals, const void* x, void* y,
           int K, long long n_rows, void* stream) {
  if (n_rows <= 0) return 0;
  if (K < 0) return -1;
  const long long blocks = (n_rows + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return -1;
  const unsigned grid = static_cast<unsigned>(blocks);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* c = static_cast<const int*>(cols);
  const T* v = static_cast<const T*>(vals);
  const T* xx = static_cast<const T*>(x);
  T* yy = static_cast<T*>(y);
  switch (K) {
    case 27: return go<T, 27>(grid, s, c, v, xx, yy, K, n_rows);
    default: return go<T, 0>(grid, s, c, v, xx, yy, K, n_rows);
  }
}

}  // namespace

extern "C" int ell_spmv_f32(const void* cols, const void* vals, const void* x,
                            void* y, int K, long long n_rows, void* stream) {
  return launch<float>(cols, vals, x, y, K, n_rows, stream);
}

extern "C" int ell_spmv_f64(const void* cols, const void* vals, const void* x,
                            void* y, int K, long long n_rows, void* stream) {
  return launch<double>(cols, vals, x, y, K, n_rows, stream);
}
