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
// What bounds it on the H100: FP32 issue and the special-function units,
// not bytes (a point reads 12 bytes and writes 12; atoms are reused by
// every point).  The full formula costs an rsqrt, an exp and an erf (erff is
// a polynomial with a branch on |x|) and about 25 FP32 operations per pair.
// But at 8,000 atoms 99.4% of the pairs are far: r / r_c >= FAR = 4.5
// (ops/gradient.py).  There, in float32, erff returns exactly 1 and the
// Gaussian term is below 8.2e-9, under half an ulp of 1 (2^-25), so the
// bracket rounds to exactly -1 and W_a = -q_a / r^3
// (tests/test_torch_gradient.py sweeps every float32 r / r_c in [FAR, 1e4]
// to show it).
//
// What the design does about it: far pairs take a path of one rsqrtf and a
// dozen FP32 operations, with no branch per pair.  Each warp owns 64
// neighbouring points (8 cells of 8 points) and reduces their bounding box
// once.  For each staged atom tile, every lane tests one atom in 32 against
// that box: an atom whose squared distance to the box is at least far_r2 =
// (FAR r_c)^2 (1 + 1e-4) is far from all 64 points (the margin keeps each
// computed r / r_c above FAR).  A ballot turns the tests into a near mask,
// and the warp walks the tile in atom order: runs of far atoms in a tight
// loop, each near atom with the full formula and its guard.  The far path
// computes rsqrtf(r^2), ir^3 and q * (-1) * ir^3 in the order of the full
// formula, so its terms have the bits the full formula gives; the atom
// order and the accumulation order are unchanged, so the output is
// bit-identical to the earlier single-path kernel.
//
// Layout: 256 threads per CTA, two neighbouring points per thread, so each
// shared-memory read of an atom serves two pairs.  The CTA stages 256 atoms
// at a time as float4 (x, y, z, q); every thread of a warp reads the same
// atom in the same step (broadcast).  The three components accumulate in
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

constexpr int kThreads = 256;     // atoms per tile
constexpr int kPts = 2;           // neighbouring points per thread
constexpr int kWords = kThreads / 32;

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// rsqrtf of a normal input: the special-function unit's reciprocal square
// root, without the rescaling that rsqrtf adds for subnormal inputs (a far
// pair's r^2 is at least far_r2), so the same bits as rsqrtf there.
__device__ __forceinline__ float rsqrt_normal(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__global__ void __launch_bounds__(kThreads)
exact_gradient_kernel(const float* __restrict__ pts,
                      const float4* __restrict__ atoms,
                      float* __restrict__ out, long long n_pts, int n_atoms,
                      float inv_rc, float two_inv_sqrtpi_rc, float far_r2) {
  __shared__ float4 tile[kThreads];
  const int lane = threadIdx.x & 31;
  const long long p0 = (static_cast<long long>(blockIdx.x) * kThreads
                        + threadIdx.x) * kPts;
  float px[kPts], py[kPts], pz[kPts], gx[kPts], gy[kPts], gz[kPts];
#pragma unroll
  for (int j = 0; j < kPts; ++j) {
    // a point past the end repeats the last one: it keeps the box tight
    const long long p = min(p0 + j, n_pts - 1);
    px[j] = pts[3 * p];
    py[j] = pts[3 * p + 1];
    pz[j] = pts[3 * p + 2];
    gx[j] = gy[j] = gz[j] = 0.f;
  }
  // the bounding box of the warp's points
  float lox = px[0], hix = px[0], loy = py[0], hiy = py[0];
  float loz = pz[0], hiz = pz[0];
#pragma unroll
  for (int j = 1; j < kPts; ++j) {
    lox = fminf(lox, px[j]); hix = fmaxf(hix, px[j]);
    loy = fminf(loy, py[j]); hiy = fmaxf(hiy, py[j]);
    loz = fminf(loz, pz[j]); hiz = fmaxf(hiz, pz[j]);
  }
  lox = warp_min(lox); loy = warp_min(loy); loz = warp_min(loz);
  hix = warp_max(hix); hiy = warp_max(hiy); hiz = warp_max(hiz);

  for (int a0 = 0; a0 < n_atoms; a0 += kThreads) {
    const int m = min(kThreads, n_atoms - a0);
    __syncthreads();                  // previous tile fully consumed
    if (threadIdx.x < m) tile[threadIdx.x] = atoms[a0 + threadIdx.x];
    __syncthreads();
    // near mask: bit l of word k is atom 32 k + l within far reach of a
    // point of the warp
    unsigned near[kWords];
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      const int a = 32 * k + lane;
      bool nr = false;
      if (a < m) {
        const float4 A = tile[a];
        const float dx = fmaxf(fmaxf(lox - A.x, A.x - hix), 0.f);
        const float dy = fmaxf(fmaxf(loy - A.y, A.y - hiy), 0.f);
        const float dz = fmaxf(fmaxf(loz - A.z, A.z - hiz), 0.f);
        nr = dx * dx + dy * dy + dz * dz < far_r2;
      }
      near[k] = __ballot_sync(0xffffffffu, nr);
    }
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      const int end = min(32 * (k + 1), m);
      int a = 32 * k;
      unsigned msk = near[k];
      while (a < end) {
        const int stop = msk ? 32 * k + __ffs(msk) - 1 : end;
#pragma unroll 4
        for (; a < stop; ++a) {       // far: the bracket is exactly -1
          const float4 A = tile[a];
#pragma unroll
          for (int j = 0; j < kPts; ++j) {
            const float dx = px[j] - A.x;
            const float dy = py[j] - A.y;
            const float dz = pz[j] - A.z;
            const float r2 = dx * dx + dy * dy + dz * dz;
            const float ir = rsqrt_normal(r2);
            const float w = A.w * -1.f * (ir * ir * ir);
            gx[j] += w * dx;
            gy[j] += w * dy;
            gz[j] += w * dz;
          }
        }
        if (a >= end) break;
        const float4 A = tile[a];     // near: the full formula
#pragma unroll
        for (int j = 0; j < kPts; ++j) {
          const float dx = px[j] - A.x;
          const float dy = py[j] - A.y;
          const float dz = pz[j] - A.z;
          const float r2 = dx * dx + dy * dy + dz * dz;
          const bool at = r2 < 1e-14f;
          const float ir = rsqrtf(at ? 1.f : r2);
          const float r = r2 * ir;
          const float rq = r * inv_rc;
          const float w = A.w * (two_inv_sqrtpi_rc * r * expf(-rq * rq)
                                 - erff(rq)) * (ir * ir * ir);
          const float wz = at ? 0.f : w;
          gx[j] += wz * dx;
          gy[j] += wz * dy;
          gz[j] += wz * dz;
        }
        ++a;
        msk &= msk - 1;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kPts; ++j) {
    if (p0 + j < n_pts) {
      out[3 * (p0 + j)] = gx[j];
      out[3 * (p0 + j) + 1] = gy[j];
      out[3 * (p0 + j) + 2] = gz[j];
    }
  }
}

}  // namespace

extern "C" int exact_gradient_f32(const void* pts, const void* atoms,
                                  void* out, long long n_pts, int n_atoms,
                                  float inv_rc, float two_inv_sqrtpi_rc,
                                  float far_r2, void* stream) {
  if (n_pts <= 0) return 0;
  const long long per_cta = static_cast<long long>(kThreads) * kPts;
  const long long blocks = (n_pts + per_cta - 1) / per_cta;
  if (blocks > 0x7fffffffLL) return -1;
  exact_gradient_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), static_cast<const float4*>(atoms),
      static_cast<float*>(out), n_pts, n_atoms, inv_rc, two_inv_sqrtpi_rc,
      far_r2);
  return static_cast<int>(cudaGetLastError());
}
