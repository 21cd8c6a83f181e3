// ELL sparse matrix-vector product, in two layouts.
//
// Replaces the Pallas kernel coulomb_gmg_tpu/ops/ell.py:_ell_kernel and its
// jnp stand-in coulomb_gmg_tpu/solver/tpu_gmg.py:_ell_mv_t, which carried
// every level-operator apply of the GMG V-cycle on the TPU:
//
//     y[i] = sum_k vals[slot(k, i)] * x[cols[slot(k, i)]]
//
// Padding slots carry value 0 and a valid column, so no slot is skipped.
//
//   - padded (ell_spmv_*): slot(k, i) = k * n_rows + i, K slots a row.  The
//     operators built on the device (ops/stencil.py, K = 27) and those
//     carried over from a JAX tree.
//   - sliced (ell_sliced_*): rows go in slices of 32 consecutive rows, each
//     slice s with its own width w_s (its longest row), and slot(k, 32 s +
//     j) = off[s] + 32 k + j.  Every operator built on the host from a CSR
//     or COO (ops/ell.py:SlicedELL).
//
// What bounds it on the H100: memory bandwidth.  A row reads (4 + 4) * K
// bytes of cols and vals in float32, (4 + 8) * K in float64, plus K
// gathered entries of x, for 2 * K flops: far below the card's
// flop-per-byte balance point.  So the bytes of padding are time: on the
// float64 system of the 8,000-atom host-assembled run (K = 51, 614,973
// rows) 54% of the padded layout's slots are padding, forced on every row
// by the few long rows of hanging nodes, and the padded kernel read them
// at close to the card's bandwidth.  The sliced layout reads 1.19x the
// nonzeros' slots there (1.11x in slices of 8 rows).
//
// Padded kernel: one thread per row, and the (K, n_rows) layout makes
// neighbouring threads read neighbouring addresses of cols and vals for
// each k, so those loads coalesce into full 128-byte transactions.
//   - K = 27, the width of the stencil level operators and of most
//     launches of a float32 solve, is a template argument, so the loop is
//     unrolled and the compiler issues the loads of many slots ahead of the
//     FMA chain that consumes them (32 registers, about 20 loads in flight
//     per row).  Other K take a loop in steps of 4 slots.
//   - cols and vals are read once, so they are loaded with the streaming
//     (evict-first) cache policy: they pass through L2 without pushing out
//     x, which the gathers of neighbouring rows read again (x is 2.1 MB in
//     float32 at 531k rows, L2 is 50 MB).  The loads also ask L2 to fetch
//     256 bytes per miss: each warp reads 128 bytes of each of 2 K
//     streams, and the neighbouring warp wants the next 128.  The gather
//     goes through the read-only data path (__ldg).
//   At K = 27, 531,442 rows streaming the same bytes with no gather at all
//   is hardly faster (PERF.md); staging (K, rows) slabs in shared memory
//   with bulk asynchronous copies (a 2-stage pipeline) and two or four rows
//   per thread were slower.
//
// Sliced kernel: one thread per row, and a warp is one slice of 32 rows
// (ops/ell.py:SLICE, kSlice here), so it reads 128 bytes of cols and 128 or
// 256 of vals per slot as the padded kernel does, and runs its slice's
// width with no divergence.  A row's first slots (all of them in most
// slices of a level operator) take the padded kernel's unrolled schedule
// in a head of 8, 16 or 27 slots, the smallest that holds the slice; a
// narrower slice loads its last slot again in place of the missing ones
// (lines already fetched) rather than predicating its loads, which was
// slower.  Slots past 27 go in batches of 16, all loads issued before the
// gathers and FMAs that use them (the padded runtime loop has 4 in
// flight).  Operators of at most 8 entries a row take 8-slot heads and
// batches, in fewer registers.  Loads stream with the 256-byte L2 fetch as
// in the padded kernel: here the next 256 bytes of a slice are its next
// slots, which the same lanes read next.  Small operators run in blocks of
// 64 threads (launch_sliced).  On the H100, without the L2 fetch and with
// slices of 8 rows (fewer bytes; 4 slices a warp, the trip count the
// widest of them) the system product was no faster and most of the
// 8,000-atom levels slower (PERF.md).
//
// Both kernels sum a row in k order as one FMA chain in a register, and a
// row's real slots come first in both layouts; a padding slot adds
// 0 * x[col], which is +-0 for finite x.  So on finite inputs the sliced
// kernel gives the padded kernel's values.  There are no atomics, so both
// are deterministic.  The kernels allocate nothing and launch on the stream
// they are given.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // the padded kernel's block
constexpr int kSlice = 32;      // rows of a slice (ops/ell.py:SLICE)

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

// The first W slots of a row whose slice is w wide, as the padded
// kernel's unrolled schedule reads them: every load, then every gather,
// then the chain in k order.  Slots past w (w < W) load the row's last
// slot again, from lines already loaded, and add nothing: no predicate
// sits between the loads, which ran faster than predicated loads.  With
// kFull (w == W) nothing is clamped or skipped.
template <int W, bool kFull, typename T>
__device__ __forceinline__ T row_head(const int* __restrict__ cr,
                                      const T* __restrict__ vr,
                                      const T* __restrict__ x, int w) {
  int c[W];
  T v[W];
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const int kk = kFull || k < w ? k : w - 1;
    c[k] = ld_stream(cr + kk * kSlice);
    v[k] = ld_stream(vr + kk * kSlice);
  }
  T g[W];
#pragma unroll
  for (int k = 0; k < W; ++k) g[k] = __ldg(x + c[k]);
  T acc = T(0);
#pragma unroll
  for (int k = 0; k < W; ++k)
    if (kFull || k < w) acc += v[k] * g[k];
  return acc;
}

// The first min(w, kHead) slots of a row by row_head, in the smallest of
// the widths 8, 16 and kHead that holds them.
template <int kHead, typename T>
__device__ __forceinline__ T row_start(const int* __restrict__ cr,
                                       const T* __restrict__ vr,
                                       const T* __restrict__ x, int w) {
  if (w >= kHead) return row_head<kHead, true>(cr, vr, x, w);
  if constexpr (kHead > 16)
    if (w > 16) return row_head<kHead, false>(cr, vr, x, w);
  if constexpr (kHead > 8)
    if (w > 8) return row_head<16, false>(cr, vr, x, w);
  return w > 0 ? row_head<8, false>(cr, vr, x, w) : T(0);
}

// Sliced layout: row i = 32 s + j reads its slice's w_s slots, 32 apart,
// in k order: the first ones by row_head, in one of three widths (8, 16 or
// kHead, the smallest that holds w_s, so a narrow slice issues few
// loads), the rest in batches of kBatch, predicated to w_s.  kHead = 27,
// kBatch = 16 for operators with rows of more than 8 entries; 8 and 8 for
// narrower ones (the prolongations), which then hold fewer registers.  A
// warp is one slice, so every branch here is uniform across it.  Lanes
// past n_rows run their slice (its padding rows) and store nothing, so the
// warp stays whole for the reduction.  kBlock threads a block: see
// launch_sliced.
template <typename T, int kBlock, int kHead, int kBatch>
__global__ void __launch_bounds__(kBlock)
ell_sliced_kernel(const long long* __restrict__ off,
                  const int* __restrict__ cols, const T* __restrict__ vals,
                  const T* __restrict__ x, T* __restrict__ y,
                  long long n_rows) {
  static_assert(kSlice == 32 && kBlock % kSlice == 0, "a warp a slice");
  const long long i = static_cast<long long>(blockIdx.x) * kBlock
                      + threadIdx.x;
  const long long s = i / kSlice;
  int w = 0;
  long long at = 0;
  if (s < (n_rows + kSlice - 1) / kSlice) {
    const long long lo = off[s];
    w = static_cast<int>((off[s + 1] - lo) / kSlice);
    at = lo + (i - s * kSlice);
  }
  const int* __restrict__ cr = cols + at;
  const T* __restrict__ vr = vals + at;
  T acc = row_start<kHead>(cr, vr, x, w);
  // every lane has its slice's width already, but the reduction tells the
  // compiler that the trip count is uniform; without it the loop ran slower
  const int w_max = __reduce_max_sync(0xffffffffu, w);
  for (int k = kHead; k < w_max; k += kBatch) {
    int c[kBatch];
    T v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      c[j] = 0;
      v[j] = T(0);
      if (k + j < w) {
        c[j] = ld_stream(cr + (k + j) * kSlice);
        v[j] = ld_stream(vr + (k + j) * kSlice);
      }
    }
    T g[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      g[j] = k + j < w ? __ldg(x + c[j]) : T(0);
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (k + j < w) acc += v[j] * g[j];
  }
  if (i < n_rows) y[i] = acc;
}

// The grid of one thread per row, or 0 when it does not fit.
unsigned grid_of(long long n_rows) {
  const long long blocks = (n_rows + kThreads - 1) / kThreads;
  return blocks > 0x7fffffffLL ? 0u : static_cast<unsigned>(blocks);
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
  const unsigned grid = grid_of(n_rows);
  if (K < 0 || grid == 0) return -1;
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

template <typename T, int kBlock>
int go_sliced(cudaStream_t s, const void* off, const void* cols,
              const void* vals, const void* x, void* y, long long n_rows,
              int width) {
  const long long blocks = (n_rows + kBlock - 1) / kBlock;
  if (blocks > 0x7fffffffLL) return -1;
  const unsigned grid = static_cast<unsigned>(blocks);
  const auto* o = static_cast<const long long*>(off);
  const auto* c = static_cast<const int*>(cols);
  const auto* v = static_cast<const T*>(vals);
  const auto* xx = static_cast<const T*>(x);
  auto* yy = static_cast<T*>(y);
  if (width <= 8)
    ell_sliced_kernel<T, kBlock, 8, 8><<<grid, kBlock, 0, s>>>(
        o, c, v, xx, yy, n_rows);
  else
    ell_sliced_kernel<T, kBlock, 27, 16><<<grid, kBlock, 0, s>>>(
        o, c, v, xx, yy, n_rows);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of 256 threads when the grid gives every SM at least 8 of them
// (270k rows on the H100's 132 SMs: the system, the finest level and its
// restriction), else of 64.  A small operator is a few microseconds of
// latency: 256-thread blocks put all its rows on a few SMs (14,336 rows
// are 56 blocks), each issuing 8 warps' loads and gathers in turn, where
// 64-thread blocks spread the same rows over every SM.  On the H100 that
// ran faster on the 8,000-atom levels of 14k-85k rows, and 256 on the
// large operators (PERF.md).
template <typename T>
int launch_sliced(const void* off, const void* cols, const void* vals,
                  const void* x, void* y, long long n_rows, int width,
                  void* stream) {
  if (n_rows <= 0) return 0;
  if (width < 0) return -1;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_rows >= 8LL * 256 * sms)
    return go_sliced<T, 256>(s, off, cols, vals, x, y, n_rows, width);
  return go_sliced<T, 64>(s, off, cols, vals, x, y, n_rows, width);
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

extern "C" int ell_sliced_f32(const void* off, const void* cols,
                              const void* vals, const void* x, void* y,
                              long long n_rows, int width, void* stream) {
  return launch_sliced<float>(off, cols, vals, x, y, n_rows, width, stream);
}

extern "C" int ell_sliced_f64(const void* off, const void* cols,
                              const void* vals, const void* x, void* y,
                              long long n_rows, int width, void* stream) {
  return launch_sliced<double>(off, cols, vals, x, y, n_rows, width, stream);
}
