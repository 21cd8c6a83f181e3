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
// operators, 8 for prolongation) plus K gathered entries of x, for 2 * K
// flops: far below the card's flop-per-byte balance point.
//
// What the design does about it: one thread per row, and the (K, n_rows)
// layout makes neighbouring threads read neighbouring addresses of cols and
// vals for each k, so those loads coalesce into full 128-byte transactions.
// The gather of x goes through the read-only data path (__ldg); the column
// indices of a stencil operator are local, so most of it hits L1/L2.  The
// sum runs in k order in a register; there are no atomics, so the result is
// deterministic.  The kernel allocates nothing and launches on the stream it
// is given.

#include <cuda_runtime.h>

namespace {

template <typename T>
__global__ void ell_spmv_kernel(const int* __restrict__ cols,
                                const T* __restrict__ vals,
                                const T* __restrict__ x,
                                T* __restrict__ y,
                                int K, long long n_rows) {
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_rows) return;
  T acc = T(0);
  for (int k = 0; k < K; ++k) {
    long long o = static_cast<long long>(k) * n_rows + i;
    acc += vals[o] * __ldg(x + cols[o]);
  }
  y[i] = acc;
}

template <typename T>
int launch(const void* cols, const void* vals, const void* x, void* y,
           int K, long long n_rows, void* stream) {
  if (n_rows <= 0) return 0;
  const int threads = 256;
  const long long blocks = (n_rows + threads - 1) / threads;
  ell_spmv_kernel<T><<<static_cast<unsigned int>(blocks), threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cols), static_cast<const T*>(vals),
      static_cast<const T*>(x), static_cast<T*>(y), K, n_rows);
  return static_cast<int>(cudaGetLastError());
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
