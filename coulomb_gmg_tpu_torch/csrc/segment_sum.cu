// Ordered segment sums: the values of the card CSR assembly
// (coulomb_gmg_tpu_torch/fem/card_assembly.py:segment_sum).
//
// Replaces no TPU kernel.  The JAX package sums the assembly's entries into
// their CSR slots on the host (fem/assembly.py:assemble_np, np.bincount);
// the port's float64 route does it on the card, where the entries already
// are, and a scatter-add there (index_add_) would use float64 atomics,
// whose order of additions, and so whose last bits, change from run to run.
// Here the entries come sorted by slot (a stable sort, so each slot's run
// keeps the enumeration order of the host plan), and one thread sums one
// slot's run in order, from 0.0:
//
//     out[s] = v(src[seg[s]]) + ... + v(src[seg[s + 1] - 1])
//     k(t) = scale[t / nb^2] * kvals[t % nb^2]  (scaled: unit coefficient)
//          = kvals[t]                           (unscaled)
//     v(t) = k(t)                               (t >= 0: weight 1)
//     v(t) = dvals[q], q = -1 - t               (t < 0, with dvals)
//     v(t) = k((dirty_idx[c] nb + i[a]) nb + i[b]) * (w[a] * w[b])
//            (t < 0: the pair of the constraint expansion coded
//            q = a kq + (b - cell_off[c]), c = cell[a])
//
// The pairs of a dirty cell's expansion are computed here from the small
// expansion arrays (entries of the dirty cells only), so the plan keeps one
// int32 code per entry and no weight.  Every product and sum is rounded on
// its own (__dmul_rn, __dadd_rn: no fused multiply-add), so the result has
// the bits of a sequential np.bincount of the host engine's values
// (fem/assembly.py: k64[c, i, j] * (w_a * w_b)), and of the plain version.
//
// What bounds it on the H100: memory.  A slot reads its run's int32 codes
// (contiguous, so a warp's 32 runs share cache lines) and gathers 8 or 16
// bytes per entry from the element values, which stay in L2 (the scaled
// form reads one h per cell and a 64-entry reference matrix).  On the
// 8,000-atom cycle-0 float64 system (31.1M entries in 13.0M slots, 0.53 GB
// by roofline.py:segment_sum's count) it takes 0.34 ms, 46% of that bound,
// against 6.6 ms for the plain torch version (chip_smoke.py phase 3, one
// H100 80GB HBM3 at 700 W).  Runs are short (1-8 entries, up to ~200 at
// constraint masters), so one thread a slot keeps the threads of a warp on
// about equal work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <bool kScaled>
__device__ __forceinline__ double element(const double* __restrict__ kvals,
                                          const double* __restrict__ scale,
                                          int nb2, long long t) {
  return kScaled ? __dmul_rn(scale[t / nb2], kvals[t % nb2]) : kvals[t];
}

template <bool kScaled>
__global__ void segment_sum_kernel(
    const int32_t* __restrict__ seg, const int32_t* __restrict__ src,
    const double* __restrict__ kvals, const double* __restrict__ scale,
    int nb, const double* __restrict__ dvals, int kq,
    const int32_t* __restrict__ cell, const int32_t* __restrict__ li,
    const double* __restrict__ w, const int32_t* __restrict__ cell_off,
    const int32_t* __restrict__ dirty_idx, double* __restrict__ out,
    long long n) {
  long long s = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (s >= n) return;
  const int nb2 = nb * nb;
  double acc = 0.0;
  const int32_t end = seg[s + 1];
  for (int32_t e = seg[s]; e < end; ++e) {
    const int32_t t = src[e];
    double v;
    if (t >= 0) {
      v = element<kScaled>(kvals, scale, nb2, t);
    } else {
      const long long q = -1 - (long long)t;
      if (dvals != nullptr) {
        v = dvals[q];
      } else {
        const long long a = q / kq;
        const int32_t c = cell[a];
        const long long b = cell_off[c] + q % kq;
        const long long flat =
            ((long long)dirty_idx[c] * nb + li[a]) * nb + li[b];
        v = __dmul_rn(element<kScaled>(kvals, scale, nb2, flat),
                      __dmul_rn(w[a], w[b]));
      }
    }
    acc = __dadd_rn(acc, v);
  }
  out[s] = acc;
}

}  // namespace

extern "C" int segment_sum_f64(const void* seg, const void* src,
                               const void* kvals, const void* scale, int nb,
                               const void* dvals, int kq, const void* cell,
                               const void* li, const void* w,
                               const void* cell_off, const void* dirty_idx,
                               void* out, long long n, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  cudaStream_t st = (cudaStream_t)stream;
  const auto* g = (const int32_t*)seg;
  const auto* c = (const int32_t*)src;
  const auto* k = (const double*)kvals;
  const auto* h = (const double*)scale;
  const auto* d = (const double*)dvals;
  const auto* ce = (const int32_t*)cell;
  const auto* ie = (const int32_t*)li;
  const auto* we = (const double*)w;
  const auto* off = (const int32_t*)cell_off;
  const auto* di = (const int32_t*)dirty_idx;
  if (scale != nullptr) {
    segment_sum_kernel<true><<<blocks, threads, 0, st>>>(
        g, c, k, h, nb, d, kq, ce, ie, we, off, di, (double*)out, n);
  } else {
    segment_sum_kernel<false><<<blocks, threads, 0, st>>>(
        g, c, k, h, nb, d, kq, ce, ie, we, off, di, (double*)out, n);
  }
  return (int)cudaGetLastError();
}
