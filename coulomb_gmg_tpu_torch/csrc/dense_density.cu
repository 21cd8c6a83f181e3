// Brute-force Gaussian charge density at the RHS quadrature points.
//
// Replaces the Pallas kernel coulomb_gmg_tpu/ops/pallas_density.py:
// _density_kernel (reached through density_pallas_cells from the
// brute-force branch of ops/density.py:compute_density, which runs when
// the reference's "Flag for RHS evaluation optimization" is off).  For
// every quadrature point x of every cell it computes
//
//     rho(x) = scale * sum_a q_a * exp(-|x - X_a|^2 * inv_rc2)
//
// over ALL atoms, with x = lower[c] + h[c] * pref[q] built in the kernel
// from the cell's lower corner and width, as _density_cells_call does on
// the device.
//
// What bounds it on the H100: expf throughput and the FP32 issue rate, not
// bytes.  Each (point, atom) pair costs one exponential and about 10 FP32
// operations; a point reads 16 bytes of cell data and writes 4.
//
// What the design does about it: one thread per point, 256 threads per
// CTA.  The CTA stages 256 atoms at a time in shared memory as float4
// (x, y, z, q), read by all threads as broadcasts.  The sum runs in float32
// registers over all atoms in a fixed order and each point is written once,
// already scaled: no atomics, deterministic.  Rows past n_cells up to
// n_out are written as exact zeros (the padded-cell contract of the RHS
// assembly), so the output needs no separate clearing pass.
//
// The TPU kernel formed r^2 as |x|^2 + |X|^2 - 2 x.X for its matrix unit,
// which cancels in float32 at large coordinates; here r^2 comes from direct
// differences.  The point is built with __fmul_rn / __fadd_rn (no FMA
// contraction) so it rounds as the plain version and the JAX package do.
// Build without --use_fast_math so expf keeps its accuracy.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;     // points per CTA, and atoms per tile

__global__ void dense_density_kernel(const float* __restrict__ lower,
                                     const float* __restrict__ h,
                                     const float* __restrict__ pref,
                                     const float4* __restrict__ atoms,
                                     float* __restrict__ out,
                                     long long n_cells, long long n_out,
                                     int n_q, int n_atoms, float inv_rc2,
                                     float scale) {
  __shared__ float4 tile[kThreads];
  const long long p = static_cast<long long>(blockIdx.x) * kThreads
                      + threadIdx.x;
  const long long c = p / n_q;
  const bool live = c < n_cells;
  float px = 0.f, py = 0.f, pz = 0.f;
  if (live) {
    const int q = static_cast<int>(p - c * n_q);
    const float hc = h[c];
    px = __fadd_rn(lower[3 * c], __fmul_rn(hc, pref[3 * q]));
    py = __fadd_rn(lower[3 * c + 1], __fmul_rn(hc, pref[3 * q + 1]));
    pz = __fadd_rn(lower[3 * c + 2], __fmul_rn(hc, pref[3 * q + 2]));
  }
  float acc = 0.f;
  // every thread of the CTA takes part in the tile loads, live or not
  for (int a0 = 0; a0 < n_atoms; a0 += kThreads) {
    const int m = min(kThreads, n_atoms - a0);
    __syncthreads();                  // previous tile fully consumed
    if (threadIdx.x < m) tile[threadIdx.x] = atoms[a0 + threadIdx.x];
    __syncthreads();
    if (!live) continue;
    for (int a = 0; a < m; ++a) {
      const float4 A = tile[a];
      const float dx = px - A.x;
      const float dy = py - A.y;
      const float dz = pz - A.z;
      const float r2 = dx * dx + dy * dy + dz * dz;
      acc += A.w * expf(-r2 * inv_rc2);
    }
  }
  if (p < n_out * n_q) out[p] = live ? acc * scale : 0.f;
}

}  // namespace

extern "C" int dense_density_f32(const void* lower, const void* h,
                                 const void* pref, const void* atoms,
                                 void* out, long long n_cells,
                                 long long n_out, int n_q, int n_atoms,
                                 float inv_rc2, float scale, void* stream) {
  if (n_cells > n_out || n_q <= 0) return -1;
  const long long n_pts = n_out * n_q;
  if (n_pts <= 0) return 0;
  const long long blocks = (n_pts + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return -1;
  dense_density_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lower), static_cast<const float*>(h),
      static_cast<const float*>(pref), static_cast<const float4*>(atoms),
      static_cast<float*>(out), n_cells, n_out, n_q, n_atoms, inv_rc2, scale);
  return static_cast<int>(cudaGetLastError());
}
