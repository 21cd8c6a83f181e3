// Gradient of the exact potential of Gaussian-smeared point charges.
//
// Replaces the Pallas kernel coulomb_gmg_tpu/ops/pallas_gradient.py:
// _grad_kernel, which carried the FE-error postprocess (energy-norm error,
// src/step-50.cc:1423-1461) on the TPU.  For every point x it computes
//
//     grad(x) = sum_a W_a (x - X_a),
//     W_a = q_a (2 r e^{-(r/r_c)^2} / (sqrt(pi) r_c) - erf(r/r_c)) / r^3,
//
// with r = |x - X_a| and W_a = 0 where r^2 < 1e-14 (the removable
// singularity at an atom, the guard of pallas_gradient.py:62).
//
// What bounds it on the H100: the special-function units and FP32 issue
// rate, not bytes.  Each (point, atom) pair costs an rsqrt, an exp and an
// erf (erff is a polynomial with a branch on |x|) plus about 25 FP32
// operations, while a point reads 12 bytes and writes 12.
//
// What the design does about it: one thread per point, 256 threads per
// CTA.  The CTA stages 256 atoms at a time in shared memory as float4
// (x, y, z, q); every thread reads the same atom in the same step, so the
// shared-memory reads are broadcasts.  The three components accumulate in
// float32 registers over all atoms in a fixed order and each point is
// written once: no atomics, deterministic.
//
// The TPU kernel formed r^2 as |x|^2 + |X|^2 - 2 x.X for its matrix unit;
// that cancels in float32 at large coordinates.  Here r^2 comes from direct
// differences, which needs no centring of the coordinates.  erf is the CUDA
// math library's erff, not the Abramowitz-Stegun fit the TPU needed.
// Build without --use_fast_math so expf and erff keep their accuracy.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;     // points per CTA, and atoms per tile

__global__ void exact_gradient_kernel(const float* __restrict__ pts,
                                      const float4* __restrict__ atoms,
                                      float* __restrict__ out,
                                      long long n_pts, int n_atoms,
                                      float inv_rc, float two_inv_sqrtpi_rc) {
  __shared__ float4 tile[kThreads];
  const long long p = static_cast<long long>(blockIdx.x) * kThreads
                      + threadIdx.x;
  const bool live = p < n_pts;
  float px = 0.f, py = 0.f, pz = 0.f;
  if (live) {
    px = pts[3 * p];
    py = pts[3 * p + 1];
    pz = pts[3 * p + 2];
  }
  float gx = 0.f, gy = 0.f, gz = 0.f;
  for (int a0 = 0; a0 < n_atoms; a0 += kThreads) {
    const int m = min(kThreads, n_atoms - a0);
    __syncthreads();                  // previous tile fully consumed
    if (threadIdx.x < m) tile[threadIdx.x] = atoms[a0 + threadIdx.x];
    __syncthreads();
    for (int a = 0; a < m; ++a) {
      const float4 A = tile[a];
      const float dx = px - A.x;
      const float dy = py - A.y;
      const float dz = pz - A.z;
      const float r2 = dx * dx + dy * dy + dz * dz;
      const bool near = r2 < 1e-14f;
      const float ir = rsqrtf(near ? 1.f : r2);
      const float r = r2 * ir;
      const float rq = r * inv_rc;
      const float w = A.w * (two_inv_sqrtpi_rc * r * expf(-rq * rq)
                             - erff(rq)) * (ir * ir * ir);
      const float wz = near ? 0.f : w;
      gx += wz * dx;
      gy += wz * dy;
      gz += wz * dz;
    }
  }
  if (live) {
    out[3 * p] = gx;
    out[3 * p + 1] = gy;
    out[3 * p + 2] = gz;
  }
}

}  // namespace

extern "C" int exact_gradient_f32(const void* pts, const void* atoms,
                                  void* out, long long n_pts, int n_atoms,
                                  float inv_rc, float two_inv_sqrtpi_rc,
                                  void* stream) {
  if (n_pts <= 0) return 0;
  const long long blocks = (n_pts + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return -1;
  exact_gradient_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), static_cast<const float4*>(atoms),
      static_cast<float*>(out), n_pts, n_atoms, inv_rc, two_inv_sqrtpi_rc);
  return static_cast<int>(cudaGetLastError());
}
