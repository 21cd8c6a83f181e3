// Exact sequential SSOR on the card: the smoother of the level-matrix GMG
// (coulomb_gmg_tpu_torch/ops/smoothers.py:CardSSOR), one application with
// a zero initial guess, in the level matrix's own row order:
//
//     forward   y1 = (D/omega + L)^{-1} r
//     backward  z  = (D/omega + U)^{-1} (r - A y1),   y = y1 + z
//
// the arithmetic of the host version (ops/smoothers.py:HostSSOR, scipy's
// triangular solves in float64), which the kernel is held to.
//
// Replaces no TPU kernel.  The JAX package smooths with the same scipy
// solves on the host (coulomb_gmg_tpu/ops/smoothers.py:make_ssor_host),
// and so did the port: each application read the defect back to the host,
// solved there and uploaded the result.  Here the sweep runs where the
// level matrix already lies.
//
// What bounds it on the H100: the latency of the dependency chain, not bytes
// or operations.  Row i of the forward sweep needs y1_j of every j < i in
// its row, so rows form a chain as deep as the longest path through the
// lower triangle: 343 steps at the 44,084-row level of the 1,000-atom run,
// 51 at its 14,336-row level.  A step is a value seen in L2 by a waiting
// warp, the warp's sum, a division and a store: 1.1-2.6 us measured, while
// the level's 524k nonzeros (12 bytes each) take 2 us at the card's memory
// rate in all.
//
// The design keeps a step as short as a step can be, without any
// synchronisation of the whole card between steps (sync-free, Liu et al.,
// "A synchronization-free algorithm for parallel sparse triangular
// solves", Euro-Par 2016):
//   - one warp a row; each warp claims its row from an atomic ticket, in
//     increasing row order (decreasing in the backward sweep), so every
//     row a warp waits on is held by a warp that is already running, and
//     the sweep cannot deadlock whatever order the blocks start in;
//   - a warp reads all it can before it waits: its row's values and
//     columns, r_i and diag_i / omega, and in the backward sweep y1_i and
//     the whole residual sum (A y1)_i.  After the wait come only the sum
//     of the waited terms, a division and the store.  (Read after the
//     wait, r_i and diag_i put a memory round trip into every step: 1.4x
//     as long a sweep on the H100.)  Each lane waits only on its own
//     column;
//   - a row's result is its own ready flag: the vector it is published in
//     holds a NaN of a payload that no arithmetic returns (kNotYet) until
//     the row's warp stores the value, one aligned 64-bit store, and a
//     waiting lane polls that word (relaxed loads at device scope, through
//     L2) until it is anything else.  So a step is one poll that succeeds
//     and one store, with no fence and no second read (a ready flag beside
//     the value, published after a fence, took 1.2-1.6x as long a sweep);
//   - a block is one warp, so the card holds at most 32 polling warps an
//     SM (its limit of blocks), 4,224 on the H100: with two warps a block
//     the 8,448 pollers took up to 1.3x as long at the largest levels; a
//     grid of 2,048 warps looping over the tickets up to 1.35x, one of
//     4,224 such warps within 4% of this;
//   - the forward sweep publishes y1 in ``yp`` and keeps a copy in ``y1``;
//     the backward sweep publishes z in ``z`` and reads the copy for its
//     residual, so the residual takes no launch or vector of its own;
//   - each sweep returns to kNotYet what the other polls (the forward sweep
//     its row of ``z``, the backward sweep its row of ``yp``, which no warp
//     reads by then) and resets the other's ticket, so an application needs
//     no memset and nothing from the host between launches.  Waiting with
//     __nanosleep backoffs made the sweep slower at every level tried.
//
// Arithmetic: float64 throughout; a float32 matrix and defect are read as
// float32 and widened, and the result is rounded to the defect's type.  A
// lane sums its columns in order and the warp adds the lanes in a fixed
// butterfly, with no atomics in any sum, so two applications give the same
// bits.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;   // one warp a block, one row a warp
constexpr unsigned kAll = 0xffffffffu;
// a NaN whose payload arithmetic never returns (the card's NaNs are
// canonical): "not published yet"; ops/smoothers.py:NOT_YET
constexpr long long kNotYet = 0x7ff4dead5eed0001ll;

__device__ __forceinline__ double wait_for(const double* p) {
  long long b;
  do {
    asm volatile("ld.relaxed.gpu.b64 %0, [%1];" : "=l"(b) : "l"(p) : "memory");
  } while (b == kNotYet);
  return __longlong_as_double(b);
}

__device__ __forceinline__ void publish(double* p, double v) {
  asm volatile("st.relaxed.gpu.b64 [%0], %1;" ::"l"(p),
               "l"(__double_as_longlong(v)) : "memory");
}

// The warp's ticket from tickets[mine]; the first warp of the sweep resets
// the other sweep's counter, which no warp uses until the next launch.
__device__ __forceinline__ int claim(int32_t* tickets, int mine) {
  int t = 0;
  if (threadIdx.x == 0) {
    t = atomicAdd(tickets + mine, 1);
    if (t == 0) tickets[1 - mine] = 0;
  }
  return __shfl_sync(kAll, t, 0);
}

// The same sum in every lane, in a fixed order.
__device__ __forceinline__ double warp_sum(double v) {
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kAll, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kWarp)
ssor_forward(const int32_t* __restrict__ indptr,
             const int32_t* __restrict__ indices, const T* __restrict__ vals,
             const T* __restrict__ diag, const T* __restrict__ r,
             double omega, double* yp, double* y1, double* z,
             int32_t* tickets, int n) {
  const int lane = threadIdx.x;
  const int i = claim(tickets, 0);
  if (i >= n) return;
  const int32_t beg = indptr[i], end = indptr[i + 1];
  const double dw = static_cast<double>(diag[i]) / omega;
  const double ri = static_cast<double>(r[i]);
  double acc = 0.0;
  for (int32_t e = beg + lane; e < end; e += kWarp) {
    const int32_t j = indices[e];
    const double a = static_cast<double>(vals[e]);
    if (j < i) acc = fma(a, wait_for(yp + j), acc);
  }
  acc = warp_sum(acc);
  if (lane == 0) {
    const double y = (ri - acc) / dw;
    publish(yp + i, y);
    y1[i] = y;
    z[i] = __longlong_as_double(kNotYet);
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarp)
ssor_backward(const int32_t* __restrict__ indptr,
              const int32_t* __restrict__ indices, const T* __restrict__ vals,
              const T* __restrict__ diag, const T* __restrict__ r,
              double omega, double* yp, const double* __restrict__ y1,
              double* z, T* out, int32_t* tickets, int n) {
  const int lane = threadIdx.x;
  const int t = claim(tickets, 1);
  if (t >= n) return;
  const int i = n - 1 - t;
  const int32_t beg = indptr[i], end = indptr[i + 1];
  const double dw = static_cast<double>(diag[i]) / omega;
  const double y1i = y1[i];
  double ay = 0.0;
  for (int32_t e = beg + lane; e < end; e += kWarp)
    ay = fma(static_cast<double>(vals[e]), y1[indices[e]], ay);
  const double res = static_cast<double>(r[i]) - warp_sum(ay);
  double az = 0.0;
  for (int32_t e = beg + lane; e < end; e += kWarp) {
    const int32_t j = indices[e];
    const double a = static_cast<double>(vals[e]);
    if (j > i) az = fma(a, wait_for(z + j), az);
  }
  az = warp_sum(az);
  if (lane == 0) {
    const double zi = (res - az) / dw;
    publish(z + i, zi);
    out[i] = static_cast<T>(y1i + zi);
    yp[i] = __longlong_as_double(kNotYet);
  }
}

template <typename T>
int sweep(const void* indptr, const void* indices, const void* vals,
          const void* diag, const void* r, double omega, void* yp, void* y1,
          void* z, void* out, void* tickets, int n, void* stream) {
  if (n <= 0) return 0;
  const unsigned blocks = (unsigned)n;
  cudaStream_t st = (cudaStream_t)stream;
  const auto* p = (const int32_t*)indptr;
  const auto* c = (const int32_t*)indices;
  const auto* v = (const T*)vals;
  const auto* d = (const T*)diag;
  const auto* b = (const T*)r;
  auto* tk = (int32_t*)tickets;
  ssor_forward<T><<<blocks, kWarp, 0, st>>>(
      p, c, v, d, b, omega, (double*)yp, (double*)y1, (double*)z, tk, n);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssor_backward<T><<<blocks, kWarp, 0, st>>>(
      p, c, v, d, b, omega, (double*)yp, (const double*)y1, (double*)z,
      (T*)out, tk, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ssor_sweep_f64(const void* indptr, const void* indices,
                              const void* vals, const void* diag,
                              const void* r, double omega, void* yp, void* y1,
                              void* z, void* out, void* tickets, int n,
                              void* stream) {
  return sweep<double>(indptr, indices, vals, diag, r, omega, yp, y1, z, out,
                       tickets, n, stream);
}

extern "C" int ssor_sweep_f32(const void* indptr, const void* indices,
                              const void* vals, const void* diag,
                              const void* r, double omega, void* yp, void* y1,
                              void* z, void* out, void* tickets, int n,
                              void* stream) {
  return sweep<float>(indptr, indices, vals, diag, r, omega, yp, y1, z, out,
                      tickets, n, stream);
}
