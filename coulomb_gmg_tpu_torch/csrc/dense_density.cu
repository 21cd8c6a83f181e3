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
// What bounds it on the H100: the FP32 issue rate.  A (point, atom) term
// costs an expf (about 8 instructions) and about 8 more; a point reads 16
// bytes of cell data and writes 4.  But most terms are exactly zero: once
// t = r^2 * inv_rc2 reaches ZERO_EXP (ops/density.py; measured on the card
// by an exhaustive float32 sweep, tests/test_torch_cuda.py), expf(-t) is +0,
// and at 8,000 atoms that holds for about 93% of the pairs.  A term whose
// expf is +0 leaves the sum bit for bit as it was: the FMA gives
// fma(q, +0, acc) == acc, and acc is never -0 (it starts at +0 and an exact
// zero sum rounds to +0).
//
// What the design does about it: it skips those terms exactly, by box
// tests, and evaluates the rest in atom order.  Each warp is on its own (no
// CTA barrier): it owns 32 * kPts consecutive points (kPts per thread, so a
// shared-memory read of an atom serves kPts pairs; at 8 points per cell,
// 4 * kPts cells in the forest's key order) and reduces their bounding box.
//   1. A pre-pass (group_boxes_kernel) stores the bounding box of every
//      group of 32 consecutive atoms.
//   2. Each lane tests one group in 32 against the warp's box; a group
//      whose squared distance to it is >= zero_r2 cannot change any of the
//      warp's points and is never loaded.  The lattice files list atoms in
//      site order, so their groups are compact; the result is exact for
//      atoms in any order, only slower.
//   3. For the remaining groups, kGroups at a time in ascending order, each
//      lane loads one atom of each (the loads issued together) and tests it
//      against the warp's box; a ballot and a prefix count per group compact
//      the survivors, in atom order, into the warp's slot of shared memory.
//   4. Every lane walks the survivors in that order and adds the term of
//      each of its points: same atoms, same order, same expressions as the
//      earlier kernel that evaluated every pair, so the same bits.
// zero_r2 = ZERO_EXP r_c^2 (1 + 1e-4) (ops/density.py:zero_r2): the box
// distance is computed by the same monotone roundings as a pair's r^2, and
// the margin covers the contraction and the rounding of inv_rc2, so a
// skipped pair always has a computed t >= ZERO_EXP.  zero_r2 = +inf keeps
// every pair (the tests' reference).  If n_pairs is not null, each warp adds
// the (live point, atom) pairs it evaluated.
//
// Rows past n_cells up to n_out are written as exact zeros (the
// padded-cell contract of the RHS assembly), so the output needs no
// separate clearing pass.  No atomics on the output: deterministic.
//
// The TPU kernel formed r^2 as |x|^2 + |X|^2 - 2 x.X for its matrix unit,
// which cancels in float32 at large coordinates; here r^2 comes from direct
// differences.  The point is built with __fmul_rn / __fadd_rn (no FMA
// contraction) so it rounds as the plain version and the JAX package do.
// Build without --use_fast_math so expf keeps its accuracy.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;         // 8 independent warps per CTA
constexpr int kWarps = kThreads / 32;
constexpr int kPts = 2;               // points per thread
constexpr int kGroups = 2;            // atom groups fetched per step
constexpr int kWarpPts = 32 * kPts;   // points per warp
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// gbox[2 g] = (min x, min y, min z, 0), gbox[2 g + 1] = (max ...) over the
// atoms 32 g .. 32 g + 31 that exist.
__global__ void group_boxes_kernel(const float4* __restrict__ atoms,
                                   float4* __restrict__ gbox, int n_atoms) {
  const int a = blockIdx.x * blockDim.x + threadIdx.x;
  const float inf = __int_as_float(0x7f800000);
  float lx = inf, ly = inf, lz = inf, hx = -inf, hy = -inf, hz = -inf;
  if (a < n_atoms) {
    const float4 A = atoms[a];
    lx = hx = A.x;
    ly = hy = A.y;
    lz = hz = A.z;
  }
  lx = warp_min(lx); ly = warp_min(ly); lz = warp_min(lz);
  hx = warp_max(hx); hy = warp_max(hy); hz = warp_max(hz);
  if ((threadIdx.x & 31) == 0 && a < n_atoms) {
    gbox[2 * (a >> 5)] = make_float4(lx, ly, lz, 0.f);
    gbox[2 * (a >> 5) + 1] = make_float4(hx, hy, hz, 0.f);
  }
}

__global__ void __launch_bounds__(kThreads)
dense_density_kernel(const float* __restrict__ lower,
                     const float* __restrict__ h,
                     const float* __restrict__ pref,
                     const float4* __restrict__ atoms,
                     const float4* __restrict__ gbox,
                     float* __restrict__ out, long long n_cells,
                     long long n_out, int n_q, int n_atoms, float inv_rc2,
                     float scale, float zero_r2,
                     unsigned long long* __restrict__ n_pairs) {
  __shared__ float4 cand[kWarps][32 * kGroups];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long n_live = n_cells * n_q;
  const long long n_all = n_out * n_q;
  const long long base =
      (static_cast<long long>(blockIdx.x) * kWarps + warp) * kWarpPts;
  if (base >= n_live) {               // padding rows only
#pragma unroll
    for (int j = 0; j < kPts; ++j) {
      const long long p = base + 32 * j + lane;
      if (p < n_all) out[p] = 0.f;
    }
    return;
  }

  float px[kPts], py[kPts], pz[kPts], acc[kPts];
#pragma unroll
  for (int j = 0; j < kPts; ++j) {
    // a point past the last live one repeats it: it keeps the box tight
    const long long p = min(base + 32 * j + lane, n_live - 1);
    const long long c = p / n_q;
    const int q = static_cast<int>(p - c * n_q);
    const float hc = h[c];
    px[j] = __fadd_rn(lower[3 * c], __fmul_rn(hc, pref[3 * q]));
    py[j] = __fadd_rn(lower[3 * c + 1], __fmul_rn(hc, pref[3 * q + 1]));
    pz[j] = __fadd_rn(lower[3 * c + 2], __fmul_rn(hc, pref[3 * q + 2]));
    acc[j] = 0.f;
  }
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

  float4* const mine = cand[warp];
  const int n_groups = (n_atoms + 31) >> 5;
  unsigned long long kept = 0;        // atoms evaluated by the warp
  for (int g0 = 0; g0 < n_groups; g0 += 32) {
    bool reach = false;               // 2. groups that can reach the box
    if (g0 + lane < n_groups) {
      const float4 L = gbox[2 * (g0 + lane)];
      const float4 H = gbox[2 * (g0 + lane) + 1];
      const float dx = fmaxf(fmaxf(L.x - hix, lox - H.x), 0.f);
      const float dy = fmaxf(fmaxf(L.y - hiy, loy - H.y), 0.f);
      const float dz = fmaxf(fmaxf(L.z - hiz, loz - H.z), 0.f);
      reach = dx * dx + dy * dy + dz * dz < zero_r2;
    }
    unsigned gm = __ballot_sync(kFull, reach);
    while (gm) {
      // 3. the atoms of the next kGroups reaching groups, in ascending
      // order; their loads are issued together, then each atom is tested
      // against the warp's box and the survivors are compacted in order
      float4 A[kGroups];
      bool keep[kGroups];
#pragma unroll
      for (int s = 0; s < kGroups; ++s) {
        const int a = gm ? 32 * (g0 + __ffs(gm) - 1) + lane : n_atoms;
        gm &= gm - 1;
        keep[s] = a < n_atoms;
        A[s] = keep[s] ? atoms[a] : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      int n = 0;
#pragma unroll
      for (int s = 0; s < kGroups; ++s) {
        const float dx = fmaxf(fmaxf(lox - A[s].x, A[s].x - hix), 0.f);
        const float dy = fmaxf(fmaxf(loy - A[s].y, A[s].y - hiy), 0.f);
        const float dz = fmaxf(fmaxf(loz - A[s].z, A[s].z - hiz), 0.f);
        keep[s] = keep[s] && dx * dx + dy * dy + dz * dz < zero_r2;
        const unsigned km = __ballot_sync(kFull, keep[s]);
        if (keep[s]) mine[n + __popc(km & ((1u << lane) - 1u))] = A[s];
        n += __popc(km);
      }
      __syncwarp();
      kept += n;
#pragma unroll 4
      for (int i = 0; i < n; ++i) {   // 4. the terms, in atom order
        const float4 C = mine[i];
#pragma unroll
        for (int j = 0; j < kPts; ++j) {
          const float dx = px[j] - C.x;
          const float dy = py[j] - C.y;
          const float dz = pz[j] - C.z;
          const float r2 = dx * dx + dy * dy + dz * dz;
          acc[j] += C.w * expf(-r2 * inv_rc2);
        }
      }
      __syncwarp();                   // mine is rewritten by the next step
    }
  }

  int live = 0;
#pragma unroll
  for (int j = 0; j < kPts; ++j) {
    const long long p = base + 32 * j + lane;
    live += p < n_live;
    if (p < n_all) out[p] = p < n_live ? acc[j] * scale : 0.f;
  }
  if (n_pairs != nullptr) {
    live = __reduce_add_sync(kFull, live);
    if (lane == 0) atomicAdd(n_pairs, kept * static_cast<unsigned>(live));
  }
}

}  // namespace

extern "C" int dense_density_f32(const void* lower, const void* h,
                                 const void* pref, const void* atoms,
                                 void* gbox, void* out, long long n_cells,
                                 long long n_out, int n_q, int n_atoms,
                                 float inv_rc2, float scale, float zero_r2,
                                 void* n_pairs, void* stream) {
  if (n_cells > n_out || n_q <= 0 || n_atoms < 0) return -1;
  const long long n_pts = n_out * n_q;
  if (n_pts <= 0) return 0;
  const long long per_cta = static_cast<long long>(kThreads) * kPts;
  const long long blocks = (n_pts + per_cta - 1) / per_cta;
  if (blocks > 0x7fffffffLL) return -1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_atoms > 0) {
    group_boxes_kernel<<<(n_atoms + kThreads - 1) / kThreads, kThreads, 0,
                         s>>>(static_cast<const float4*>(atoms),
                              static_cast<float4*>(gbox), n_atoms);
  }
  dense_density_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const float*>(lower), static_cast<const float*>(h),
      static_cast<const float*>(pref), static_cast<const float4*>(atoms),
      static_cast<const float4*>(gbox), static_cast<float*>(out), n_cells,
      n_out, n_q, n_atoms, inv_rc2, scale, zero_r2,
      static_cast<unsigned long long*>(n_pairs));
  return static_cast<int>(cudaGetLastError());
}

// expf(-t[i]) for the zero-threshold sweep: the expf that the density
// kernel inlines, compiled with the same flags.
namespace {
__global__ void expf_neg_kernel(const float* __restrict__ t,
                                float* __restrict__ out, long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  if (i < n) out[i] = expf(-t[i]);
}
}  // namespace

extern "C" int expf_neg_f32(const void* t, void* out, long long n,
                            void* stream) {
  if (n <= 0) return 0;
  const long long blocks = (n + 255) / 256;
  if (blocks > 0x7fffffffLL) return -1;
  expf_neg_kernel<<<static_cast<unsigned>(blocks), 256, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(t), static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
