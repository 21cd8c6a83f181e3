// Locality-cut Gaussian charge density at the RHS quadrature points.
//
// Replaces the Pallas kernel coulomb_gmg_tpu/ops/tile_density.py:_tile_kernel.
// For every quadrature point x of a cell block it computes
//
//     rho(x) = scale * sum_a q_a * exp(-|x - X_a|^2 * inv_rc2)
//
// over the atoms of the block's atom tiles, counting an atom only when its
// squared distance to the box of the cell's level-0 ancestor,
// sum_d min((X_d - L_d)^2, (X_d - L_d - h0)^2), is strictly below cut2.
//
// What bounds it on the H100: expf throughput and the per-pair FMAs, not
// bytes.  Each (point, atom) pair costs one exponential on the special
// function units and about 20 FP32 operations, while an atom tile of
// 4 * a_tile floats is read once per cell block and reused by every point
// of the block.
//
// What the design does about it: one CTA per cell block (cpb cells times
// n_q points, at most 512 points; 256 threads with two points each).  The
// CTA walks its own CSR range [blk_ptr[b], blk_ptr[b + 1]) of atom tiles,
// stages each tile's x, y, z and q in shared memory, and accumulates in
// float32 registers, so device memory traffic is one tile load per
// (block, tile) pair.  Each point is written exactly once, already scaled;
// a block with no tiles writes zeros.  There are no atomics, so the output
// is deterministic.
//
// The membership test is bit-exact against the reference: the TPU kernel
// and the host atom lists (coulomb_gmg_tpu/ops/neighbors.py) evaluate it
// with plain IEEE multiplies and adds, so it is written with __fsub_rn /
// __fmul_rn / __fadd_rn, which the compiler never contracts into FMAs.
// Build without --use_fast_math so expf keeps its IEEE rounding.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPointsPerThread = 2;

__global__ void tile_density_kernel(
    const int* __restrict__ blk_ptr, const int* __restrict__ atile,
    const float* __restrict__ pts,    // (3, n_cells * n_q) point coords
    const float* __restrict__ anc,    // (3, n_cells) level-0 ancestor corner
    const float* __restrict__ atoms,  // (4, a_pad): x, y, z, charge
    float* __restrict__ out,          // (n_out, n_q)
    long long n_pts, long long n_cells, int n_q, int cpb, int a_tile,
    long long a_pad, long long n_out, float inv_rc2, float cut2, float h0,
    float scale) {
  extern __shared__ float tile[];     // (4, a_tile)
  const int b = blockIdx.x;
  const int p_blk = cpb * n_q;

  float px[kPointsPerThread], py[kPointsPerThread], pz[kPointsPerThread];
  float lx[kPointsPerThread], ly[kPointsPerThread], lz[kPointsPerThread];
  float acc[kPointsPerThread];
  long long gp[kPointsPerThread];
#pragma unroll
  for (int j = 0; j < kPointsPerThread; ++j) {
    const int p = threadIdx.x + j * kThreads;
    gp[j] = (p < p_blk) ? static_cast<long long>(b) * p_blk + p : -1;
    acc[j] = 0.f;
    px[j] = py[j] = pz[j] = 0.f;
    lx[j] = ly[j] = lz[j] = 0.f;
    if (gp[j] >= 0) {
      const long long c = static_cast<long long>(b) * cpb + p / n_q;
      px[j] = pts[gp[j]];
      py[j] = pts[n_pts + gp[j]];
      pz[j] = pts[2 * n_pts + gp[j]];
      lx[j] = anc[c];
      ly[j] = anc[n_cells + c];
      lz[j] = anc[2 * n_cells + c];
    }
  }

  const int i0 = blk_ptr[b];
  const int i1 = blk_ptr[b + 1];
  for (int it = i0; it < i1; ++it) {
    const long long base = static_cast<long long>(atile[it]) * a_tile;
    __syncthreads();                  // previous tile fully consumed
    for (int j = threadIdx.x; j < a_tile; j += kThreads) {
      tile[j] = atoms[base + j];
      tile[a_tile + j] = atoms[a_pad + base + j];
      tile[2 * a_tile + j] = atoms[2 * a_pad + base + j];
      tile[3 * a_tile + j] = atoms[3 * a_pad + base + j];
    }
    __syncthreads();
    for (int a = 0; a < a_tile; ++a) {
      const float X = tile[a];
      const float Y = tile[a_tile + a];
      const float Z = tile[2 * a_tile + a];
      const float Q = tile[3 * a_tile + a];
#pragma unroll
      for (int j = 0; j < kPointsPerThread; ++j) {
        const float dx = X - px[j];
        const float dy = Y - py[j];
        const float dz = Z - pz[j];
        const float r2 = dx * dx + dy * dy + dz * dz;
        // exact membership: distance from the ancestor box, no contraction
        const float ax = __fsub_rn(X, lx[j]);
        const float bx = __fsub_rn(ax, h0);
        const float ay = __fsub_rn(Y, ly[j]);
        const float by = __fsub_rn(ay, h0);
        const float az = __fsub_rn(Z, lz[j]);
        const float bz = __fsub_rn(az, h0);
        const float mx = fminf(__fmul_rn(ax, ax), __fmul_rn(bx, bx));
        const float my = fminf(__fmul_rn(ay, ay), __fmul_rn(by, by));
        const float mz = fminf(__fmul_rn(az, az), __fmul_rn(bz, bz));
        const float m2 = __fadd_rn(__fadd_rn(mx, my), mz);
        const float e = expf(-r2 * inv_rc2);
        acc[j] += (m2 < cut2) ? Q * e : 0.f;
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kPointsPerThread; ++j) {
    if (gp[j] >= 0 && gp[j] < n_out * n_q) out[gp[j]] = acc[j] * scale;
  }
}

}  // namespace

extern "C" int tile_density_f32(
    const void* blk_ptr, const void* atile, const void* pts, const void* anc,
    const void* atoms, void* out, int n_blocks, int n_q, int cpb, int a_tile,
    long long a_pad, long long n_out, float inv_rc2, float cut2, float h0,
    float scale, void* stream) {
  if (cpb * n_q > kThreads * kPointsPerThread) return -1;
  if (n_blocks <= 0) return 0;
  const long long n_cells = static_cast<long long>(n_blocks) * cpb;
  const long long n_pts = n_cells * n_q;
  const size_t smem = sizeof(float) * 4 * static_cast<size_t>(a_tile);
  tile_density_kernel<<<n_blocks, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(blk_ptr), static_cast<const int*>(atile),
      static_cast<const float*>(pts), static_cast<const float*>(anc),
      static_cast<const float*>(atoms), static_cast<float*>(out), n_pts,
      n_cells, n_q, cpb, a_tile, a_pad, n_out, inv_rc2, cut2, h0, scale);
  return static_cast<int>(cudaGetLastError());
}
