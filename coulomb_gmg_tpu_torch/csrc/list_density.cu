// Gaussian charge density over each cell's atom list (the locality
// density of the float64 route, and of the tpu_cg routes in float32).
//
// Replaces no TPU kernel.  The JAX package evaluates this density with
// jnp code over padded (n_cells, K) lists (coulomb_gmg_tpu/ops/density.py:
// compute_density, its list branch); the port's plain twin is the list
// branch of coulomb_gmg_tpu_torch/ops/density.py:compute_density.  For
// every cell c with atoms in its list and every point of the tensor-product
// rule (n1 abscissae x1 a axis, n1^dim points, axis 0 slowest):
//
//     rho(c, p) = scale * sum_a q_a prod_d exp(-(xq_d - X_a,d)^2 / rc2)
//     xq_d = lower_d + h * x1[p_d],  h = h0 2^-level,  lower_d = lo_d + h ijk_d
//
// over a in atoms[ptr[home[c]] : ptr[home[c] + 1]] (ops/neighbors.py:
// AtomLists: refinement carries home, a child reading its parent's row).
// The cell's corner and width come from the forest's level and ijk on the
// card, by the same roundings as Forest.cell_lower (__dmul_rn, __dadd_rn),
// so no per-cell geometry travels from the host.
//
// What bounds it on the H100: neither bytes nor operations at these sizes
// (the 1,000-atom float64 cell evaluates about 2M (cell, atom) entries a
// cycle: 6 exponentials and 8 points each); the launch and the list upload
// are what it costs.  The design keeps the arithmetic exact and the order
// fixed rather than fast:
//   * one warp a cell (4 warps a block); rows with an empty list and rows
//     past n_rows up to n_out are written as exact zeros;
//   * the lanes take the list 32 atoms at a time, each lane one atom: it
//     evaluates the Gaussian per axis (dim * n1 exponentials, as the plain
//     version's separable form) and puts the factors and the charge in the
//     warp's shared memory;
//   * each lane owns points p = lane, lane + 32, ... and adds every atom's
//     term to its own sums in list order, so the sum needs no reduction
//     across lanes and repeat runs give the same bits; the term multiplies
//     as the plain version's _sep_rho does, ((e_1 e_2) q) e_0 in 3D;
//   * rules of n1 <= kMaxN1 points an axis (the production rules, n1 = 2,
//     and the golden Gaussian's, n1 = 5) take n1 as a template argument:
//     the sums in registers (at most 4 a lane), the factors in static
//     shared memory; larger rules take n1 at run time, the factors in
//     dynamic shared memory and each lane's sums in its own entries of the
//     output row, with the same operations in the same order.
// Every product and sum is rounded on its own (no contraction), and the
// build has no --use_fast_math, so exp and expf keep their accuracy.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;          // warps (cells) a block
constexpr int kMaxDim = 3;
constexpr int kMaxN1 = 5;          // larger rules: list_density_any_kernel

__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double div_rn(double a, double b) {
  return __ddiv_rn(a, b);
}
__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double exp_of(double t) { return exp(t); }
__device__ __forceinline__ float exp_of(float t) { return expf(t); }

// The cell's corner along axis d in T, rounded as Forest.cell_lower.
template <typename T>
__device__ __forceinline__ T cell_low(int d, int dim, const double* lo,
                                      double h, const int64_t* ijk,
                                      long long c) {
  return d < dim ? (T)__dadd_rn(lo[d], __dmul_rn(h, (double)ijk[c * dim + d]))
                 : T(0);
}

// One atom's per-axis factor exp(-(xq - x)^2 / rc2).
template <typename T>
__device__ __forceinline__ T factor(T xq, T x, T rc2) {
  const T u = add_rn(xq, -x);
  return exp_of(div_rn(-mul_rn(u, u), rc2));
}

// One atom's term at the point of axis indices i0, i1, i2, multiplied as
// the plain version's _sep_rho: ((e_1 e_2) q) e_0 in 3D.
template <typename T>
__device__ __forceinline__ T term(const T* et, int n1, int dim, T q, int i0,
                                  int i1, int i2) {
  if (dim == 3)
    return mul_rn(mul_rn(mul_rn(et[n1 + i1], et[2 * n1 + i2]), q), et[i0]);
  if (dim == 2) return mul_rn(mul_rn(et[n1 + i1], q), et[i0]);
  return mul_rn(et[i0], q);
}

template <typename T, int N1>
__global__ void __launch_bounds__(32 * kWarps) list_density_kernel(
    const int64_t* __restrict__ ptr, const int32_t* __restrict__ atoms,
    const int32_t* __restrict__ home, const int64_t* __restrict__ level,
    const int64_t* __restrict__ ijk, int dim, double lo0, double lo1,
    double lo2, double h0, const T* __restrict__ x1,
    const T* __restrict__ apos, T rc2, T scale, T* __restrict__ out,
    long long n_rows, long long n_out) {
  constexpr int kPerLane = (N1 * N1 * N1 + 31) / 32;
  __shared__ T s_e[kWarps][32][kMaxDim * N1];
  __shared__ T s_q[kWarps][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long c = (long long)blockIdx.x * kWarps + warp;
  if (c >= n_out) return;                           // uniform in the warp
  int n_pts = N1;
  for (int d = 1; d < dim; ++d) n_pts *= N1;

  T acc[kPerLane];
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) acc[k] = T(0);

  long long beg = 0, end = 0;
  if (c < n_rows) {
    const int32_t r = home[c];
    beg = ptr[r];
    end = ptr[r + 1];
  }
  if (beg < end) {
    // the cell's points per axis, rounded as the plain version rounds them
    const double lo[kMaxDim] = {lo0, lo1, lo2};
    const double h = ldexp(h0, -(int)level[c]);
    const T ht = (T)h;
    T xq[kMaxDim][N1];
#pragma unroll
    for (int d = 0; d < kMaxDim; ++d) {
      const T low = cell_low<T>(d, dim, lo, h, ijk, c);
#pragma unroll
      for (int i = 0; i < N1; ++i) xq[d][i] = add_rn(low, mul_rn(ht, x1[i]));
    }
    // each owned point's index along each axis
    int pi[kPerLane][kMaxDim];
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      int p = lane + 32 * k;
#pragma unroll
      for (int d = kMaxDim - 1; d >= 0; --d) {
        pi[k][d] = d < dim ? p % N1 : 0;
        if (d < dim) p /= N1;
      }
    }
    T* e = &s_e[warp][0][0];
    for (long long base = beg; base < end; base += 32) {
      const int n = (int)(end - base < 32 ? end - base : 32);
      if (lane < n) {
        const T* pa = apos + 4 * (long long)atoms[base + lane];
        T* el = e + lane * (kMaxDim * N1);
#pragma unroll
        for (int d = 0; d < kMaxDim; ++d) {
          if (d < dim) {
            const T x = pa[d];
#pragma unroll
            for (int i = 0; i < N1; ++i)
              el[d * N1 + i] = factor(xq[d][i], x, rc2);
          }
        }
        s_q[warp][lane] = pa[3];
      }
      __syncwarp();
      for (int t = 0; t < n; ++t) {                 // list order
        const T* et = e + t * (kMaxDim * N1);
        const T q = s_q[warp][t];
#pragma unroll
        for (int k = 0; k < kPerLane; ++k) {
          if (lane + 32 * k < n_pts)
            acc[k] = add_rn(acc[k], term(et, N1, dim, q, pi[k][0], pi[k][1],
                                         pi[k][2]));
        }
      }
      __syncwarp();
    }
  }
  T* o = out + c * n_pts;
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const int p = lane + 32 * k;
    if (p < n_pts) o[p] = beg < end ? mul_rn(scale, acc[k]) : T(0);
  }
}

// Rules of more than kMaxN1 points an axis: n1 at run time, the same
// operations in the same order as list_density_kernel.  The factors of
// each warp's 32 atoms and their charges sit in dynamic shared memory
// (32 (dim n1 + 1) values a warp); each lane keeps its points' sums in
// the output row, which only it reads and writes, and scales them last.
template <typename T>
__global__ void __launch_bounds__(32 * kWarps) list_density_any_kernel(
    const int64_t* __restrict__ ptr, const int32_t* __restrict__ atoms,
    const int32_t* __restrict__ home, const int64_t* __restrict__ level,
    const int64_t* __restrict__ ijk, int dim, int n1, double lo0,
    double lo1, double lo2, double h0, const T* __restrict__ x1,
    const T* __restrict__ apos, T rc2, T scale, T* __restrict__ out,
    long long n_rows, long long n_out) {
  extern __shared__ __align__(16) unsigned char s_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long c = (long long)blockIdx.x * kWarps + warp;
  if (c >= n_out) return;                           // uniform in the warp
  const int stride = dim * n1;                      // factors an atom
  T* e = reinterpret_cast<T*>(s_raw) + warp * 32 * (stride + 1);
  T* sq = e + 32 * stride;
  int n_pts = n1;
  for (int d = 1; d < dim; ++d) n_pts *= n1;
  T* o = out + c * n_pts;
  for (int p = lane; p < n_pts; p += 32) o[p] = T(0);

  long long beg = 0, end = 0;
  if (c < n_rows) {
    const int32_t r = home[c];
    beg = ptr[r];
    end = ptr[r + 1];
  }
  if (beg >= end) return;                           // the row stays zero
  const double lo[kMaxDim] = {lo0, lo1, lo2};
  const double h = ldexp(h0, -(int)level[c]);
  const T ht = (T)h;
  T low[kMaxDim];
  for (int d = 0; d < kMaxDim; ++d) low[d] = cell_low<T>(d, dim, lo, h, ijk, c);
  for (long long base = beg; base < end; base += 32) {
    const int n = (int)(end - base < 32 ? end - base : 32);
    if (lane < n) {
      const T* pa = apos + 4 * (long long)atoms[base + lane];
      T* el = e + lane * stride;
      for (int d = 0; d < dim; ++d)
        for (int i = 0; i < n1; ++i)
          el[d * n1 + i] = factor(add_rn(low[d], mul_rn(ht, x1[i])), pa[d],
                                  rc2);
      sq[lane] = pa[3];
    }
    __syncwarp();
    for (int p = lane; p < n_pts; p += 32) {
      int pi[kMaxDim] = {0, 0, 0}, rest = p;
      for (int d = dim - 1; d >= 0; --d) {
        pi[d] = rest % n1;
        rest /= n1;
      }
      T a = o[p];
      for (int t = 0; t < n; ++t)                   // list order
        a = add_rn(a, term(e + t * stride, n1, dim, sq[t], pi[0], pi[1],
                           pi[2]));
      o[p] = a;
    }
    __syncwarp();
  }
  for (int p = lane; p < n_pts; p += 32) o[p] = mul_rn(scale, o[p]);
}

template <typename T>
int launch(const void* ptr, const void* atoms, const void* home,
           const void* level, const void* ijk, int dim, int n1, double lo0,
           double lo1, double lo2, double h0, const void* x1,
           const void* apos, T rc2, T scale, void* out, long long n_rows,
           long long n_out, void* stream) {
  if (dim < 1 || dim > kMaxDim || n_rows < 0 || n_rows > n_out)
    return (int)cudaErrorInvalidValue;
  if (n_out == 0) return 0;
  const long long blocks = (n_out + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* p = static_cast<const int64_t*>(ptr);
  const auto* a = static_cast<const int32_t*>(atoms);
  const auto* hm = static_cast<const int32_t*>(home);
  const auto* lv = static_cast<const int64_t*>(level);
  const auto* ij = static_cast<const int64_t*>(ijk);
  const auto* x = static_cast<const T*>(x1);
  const auto* ap = static_cast<const T*>(apos);
  auto* o = static_cast<T*>(out);
  const dim3 grid((unsigned)blocks), block(32 * kWarps);
#define LIST_DENSITY_CASE(N)                                               \
  case N:                                                                  \
    list_density_kernel<T, N><<<grid, block, 0, st>>>(                     \
        p, a, hm, lv, ij, dim, lo0, lo1, lo2, h0, x, ap, rc2, scale, o,    \
        n_rows, n_out);                                                    \
    break;
  static_assert(kMaxN1 == 5, "the cases below instantiate n1 = 1 ... 5");
  if (n1 < 1) return (int)cudaErrorInvalidValue;
  switch (n1) {
    LIST_DENSITY_CASE(1)
    LIST_DENSITY_CASE(2)
    LIST_DENSITY_CASE(3)
    LIST_DENSITY_CASE(4)
    LIST_DENSITY_CASE(5)
    default: {
      const size_t smem = sizeof(T) * kWarps * 32 * (size_t)(dim * n1 + 1);
      int dev = 0, optin = 0;
      cudaError_t err = cudaGetDevice(&dev);
      if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(
            &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
      if (err != cudaSuccess) return (int)err;
      if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
      err = cudaFuncSetAttribute(list_density_any_kernel<T>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
      if (err != cudaSuccess) return (int)err;
      list_density_any_kernel<T><<<grid, block, smem, st>>>(
          p, a, hm, lv, ij, dim, n1, lo0, lo1, lo2, h0, x, ap, rc2, scale, o,
          n_rows, n_out);
    }
  }
#undef LIST_DENSITY_CASE
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int list_density_f64(const void* ptr, const void* atoms,
                                const void* home, const void* level,
                                const void* ijk, int dim, int n1, double lo0,
                                double lo1, double lo2, double h0,
                                const void* x1, const void* apos, double rc2,
                                double scale, void* out, long long n_rows,
                                long long n_out, void* stream) {
  return launch<double>(ptr, atoms, home, level, ijk, dim, n1, lo0, lo1, lo2,
                        h0, x1, apos, rc2, scale, out, n_rows, n_out,
                        stream);
}

extern "C" int list_density_f32(const void* ptr, const void* atoms,
                                const void* home, const void* level,
                                const void* ijk, int dim, int n1, double lo0,
                                double lo1, double lo2, double h0,
                                const void* x1, const void* apos, float rc2,
                                float scale, void* out, long long n_rows,
                                long long n_out, void* stream) {
  return launch<float>(ptr, atoms, home, level, ijk, dim, n1, lo0, lo1, lo2,
                       h0, x1, apos, rc2, scale, out, n_rows, n_out, stream);
}
