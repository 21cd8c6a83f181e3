// Locality-cut Gaussian charge density at the RHS quadrature points.
//
// Replaces the Pallas kernel coulomb_gmg_tpu/ops/tile_density.py:_tile_kernel.
// For every quadrature point x of a cell block it computes
//
//     rho(x) = scale * sum_a q_a * exp(-|x - X_a|^2 * inv_rc2)
//
// over the atoms of the block's atom tiles, counting an atom only when its
// squared distance to the nearest vertex of the box of the cell's level-0
// ancestor, sum_d min((X_d - L_d)^2, (X_d - L_d - h0)^2), is strictly below
// cut2.
//
// What bounds it on the H100: the work that the data needs is small (about
// 1.2e8 member (point, atom) terms at 8,000 atoms, ~1.4 GFLOP, and ~72 MB of
// points, corners and output), so the bound is bytes.  What the earlier
// design spent its time on was candidates: it evaluated the membership test
// and expf for every (point, staged atom) pair, 7.25e9 of them, and dropped
// 98.4% with a select.
//
// What the design does about it: one CTA per cell block (cpb cells times
// n_q points, at most 512 points; one thread per point).  The CTA reads its
// cells' ancestor corners once, into shared memory, and reduces them to the
// block's box.  It then walks its CSR range [blk_ptr[b], blk_ptr[b + 1]) of
// atom tiles (64 atoms each; the plan's other tile widths are for its
// plain version only) in chunks of four tiles, 256 atoms, in four steps per
// chunk, three barriers:
//   1. stage: each of 256 threads loads one atom, fetched one chunk ahead so
//      that the load overlaps the work of the chunk before, and keeps it only
//      if it lies within the cutoff of the block's box (about a quarter of
//      the staged atoms at 8,000 atoms; a superset of every cell's members);
//   2. compact: a ballot per warp and a prefix over the warps write the kept
//      atoms, in staged order, to a candidate list in shared memory;
//   3. test: each warp tests (cell, candidate) membership for a set of
//      cells, 32 candidates per ballot, and stores each cell's member bits:
//      the test runs once per cell, not once per point of the cell;
//   4. walk: each thread walks the set bits of its own cell in ascending
//      candidate order (__ffs) and evaluates r^2, expf and the product only
//      for members.
// Each point accumulates in a float32 register and is written once, already
// scaled; there are no atomics, so the output is deterministic.
//
// The members of a point and their order (tiles in CSR order, atoms in
// ascending order inside a tile) are those of the earlier kernel, which
// added +0.0f for every non-member, and each term is computed by the same
// expressions (the product rounded with __fmul_rn before the add, as the
// earlier select forced), so the output is bit-identical to it.
//
// The membership test is bit-exact against the reference: the TPU kernel
// and the host atom lists (ops/neighbors.py) evaluate it with plain IEEE
// multiplies and adds, so it is written with __fsub_rn / __fmul_rn /
// __fadd_rn, which the compiler never contracts into FMAs.  Build without
// --use_fast_math so expf keeps its IEEE rounding.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;         // one point per thread
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;             // atoms per plan tile
constexpr int kChunk = 256;           // atoms staged per step
constexpr int kWords = kChunk / 32;   // member words per cell and chunk
constexpr float kBig = 3.0e38f;       // above any coordinate

__device__ __forceinline__ bool member(float X, float Y, float Z, float lx,
                                       float ly, float lz, float h0,
                                       float cut2) {
  // exact membership: nearest vertex of the ancestor box, no contraction
  const float ax = __fsub_rn(X, lx);
  const float bx = __fsub_rn(ax, h0);
  const float ay = __fsub_rn(Y, ly);
  const float by = __fsub_rn(ay, h0);
  const float az = __fsub_rn(Z, lz);
  const float bz = __fsub_rn(az, h0);
  const float mx = fminf(__fmul_rn(ax, ax), __fmul_rn(bx, bx));
  const float my = fminf(__fmul_rn(ay, ay), __fmul_rn(by, by));
  const float mz = fminf(__fmul_rn(az, az), __fmul_rn(bz, bz));
  return __fadd_rn(__fadd_rn(mx, my), mz) < cut2;
}

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

// Staged atom t of the chunk that starts at tile s0 of the block; *ok is
// false past its tiles.
__device__ __forceinline__ float4 fetch(const int* __restrict__ atile,
                                        const float* __restrict__ atoms,
                                        int i0, int n_tiles, long long a_pad,
                                        int s0, int t, bool* ok) {
  const int s = s0 + t / kTile;
  *ok = s < n_tiles;
  if (!*ok) return make_float4(0.f, 0.f, 0.f, 0.f);
  const long long a = static_cast<long long>(atile[i0 + s]) * kTile
                      + t % kTile;
  return make_float4(atoms[a], atoms[a_pad + a], atoms[2 * a_pad + a],
                     atoms[3 * a_pad + a]);
}

__global__ void __launch_bounds__(kThreads)
tile_density_kernel(
    const int* __restrict__ blk_ptr, const int* __restrict__ atile,
    const float* __restrict__ pts,    // (3, n_cells * n_q) point coords
    const float* __restrict__ anc,    // (3, n_cells) level-0 ancestor corner
    const float* __restrict__ atoms,  // (4, a_pad): x, y, z, charge
    float* __restrict__ out,          // (n_out, n_q)
    long long n_pts, long long n_cells, int n_q, int cpb, long long a_pad, long long n_out, float inv_rc2, float cut2, float h0,
    float scale) {
  extern __shared__ unsigned smem[];
  unsigned* masks = smem;                                   // (cpb, kWords)
  float* sanc = reinterpret_cast<float*>(smem + cpb * kWords);  // (3, cpb)
  __shared__ float4 cand[kChunk];
  __shared__ float red[kWarps][6];
  __shared__ int wcount[kChunk / 32];

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int p_blk = cpb * n_q;
  const bool live = t < p_blk;
  const long long c0 = static_cast<long long>(b) * cpb;
  const long long gp = static_cast<long long>(b) * p_blk + t;
  const int my_cell = live ? t / n_q : 0;

  float px = 0.f, py = 0.f, pz = 0.f;
  if (live) {
    px = pts[gp];
    py = pts[n_pts + gp];
    pz = pts[2 * n_pts + gp];
  }

  // the cells' ancestor corners, and the block's box around them
  float lo[3] = {kBig, kBig, kBig}, hi[3] = {-kBig, -kBig, -kBig};
  for (int c = t; c < cpb; c += kThreads) {
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float v = anc[d * n_cells + c0 + c];
      sanc[d * cpb + c] = v;
      lo[d] = fminf(lo[d], v);
      hi[d] = fmaxf(hi[d], v);
    }
  }
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    lo[d] = warp_min(lo[d]);
    hi[d] = warp_max(hi[d]);
  }
  if (lane == 0) {
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      red[warp][d] = lo[d];
      red[warp][3 + d] = hi[d];
    }
  }
  __syncthreads();
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    for (int w = 0; w < kWarps; ++w) {
      lo[d] = fminf(lo[d], red[w][d]);
      hi[d] = fmaxf(hi[d], red[w][3 + d]);
    }
    hi[d] += h0;
  }
  // a member lies within cut of a vertex, so within cut of the box; the
  // margin covers the rounding of this coarse test
  const float pre2 = cut2 * 1.0001f;

  const int i0 = blk_ptr[b];
  const int n_tiles = blk_ptr[b + 1] - i0;
  bool ok_next = false;
  float4 next = make_float4(0.f, 0.f, 0.f, 0.f);
  if (t < kChunk)
    next = fetch(atile, atoms, i0, n_tiles, a_pad, 0, t, &ok_next);
  float acc = 0.f;
  for (int s0 = 0; s0 < n_tiles; s0 += kChunk / kTile) {
    const float4 A = next;
    bool keep = ok_next;
    if (t < kChunk && s0 + kChunk / kTile < n_tiles)
      next = fetch(atile, atoms, i0, n_tiles, a_pad, s0 + kChunk / kTile, t,
                   &ok_next);
    else
      ok_next = false;
    if (keep) {                       // 1. stage: near the block's box?
      const float dx = fmaxf(fmaxf(lo[0] - A.x, A.x - hi[0]), 0.f);
      const float dy = fmaxf(fmaxf(lo[1] - A.y, A.y - hi[1]), 0.f);
      const float dz = fmaxf(fmaxf(lo[2] - A.z, A.z - hi[2]), 0.f);
      keep = dx * dx + dy * dy + dz * dz < pre2;
    }
    // wcount was last read before two barriers of the previous chunk, and
    // cand and masks are written after a barrier that its walk precedes
    const unsigned bal = __ballot_sync(0xffffffffu, keep);
    if (lane == 0 && warp < kChunk / 32) wcount[warp] = __popc(bal);
    __syncthreads();
    int base = 0, n_c = 0;            // 2. compact, in staged order
#pragma unroll
    for (int w = 0; w < kChunk / 32; ++w) {
      const int n = wcount[w];
      base += w < warp ? n : 0;
      n_c += n;
    }
    if (keep) cand[base + __popc(bal & ((1u << lane) - 1u))] = A;
    __syncthreads();
    const int n_w = (n_c + 31) >> 5;  // 3. test (cell, candidate)
    for (int c = warp; c < cpb; c += kWarps) {
      const float lx = sanc[c], ly = sanc[cpb + c], lz = sanc[2 * cpb + c];
      for (int w = 0; w < n_w; ++w) {
        const int i = 32 * w + lane;
        bool mem = false;
        if (i < n_c) {
          const float4 C = cand[i];
          mem = member(C.x, C.y, C.z, lx, ly, lz, h0, cut2);
        }
        const unsigned m = __ballot_sync(0xffffffffu, mem);
        if (lane == 0) masks[c * kWords + w] = m;
      }
    }
    __syncthreads();
    if (live) {                       // 4. walk this cell's members
      for (int w = 0; w < n_w; ++w) {
        unsigned m = masks[my_cell * kWords + w];
        while (m) {
          const float4 C = cand[32 * w + __ffs(m) - 1];
          m &= m - 1;
          const float dx = C.x - px;
          const float dy = C.y - py;
          const float dz = C.z - pz;
          const float r2 = dx * dx + dy * dy + dz * dz;
          const float e = expf(-r2 * inv_rc2);
          acc += __fmul_rn(C.w, e);
        }
      }
    }
  }

  if (live && gp < n_out * n_q) out[gp] = acc * scale;
}

}  // namespace

extern "C" int tile_density_f32(
    const void* blk_ptr, const void* atile, const void* pts, const void* anc,
    const void* atoms, void* out, int n_blocks, int n_q, int cpb, int a_tile,
    long long a_pad, long long n_out, float inv_rc2, float cut2, float h0,
    float scale, void* stream) {
  if (cpb * n_q > kThreads || a_tile != kTile || a_pad % kTile) return -1;
  if (n_blocks <= 0) return 0;
  const long long n_cells = static_cast<long long>(n_blocks) * cpb;
  const long long n_pts = n_cells * n_q;
  const size_t smem = (sizeof(unsigned) * kWords + sizeof(float) * 3)
                      * static_cast<size_t>(cpb);
  tile_density_kernel<<<n_blocks, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(blk_ptr), static_cast<const int*>(atile),
      static_cast<const float*>(pts), static_cast<const float*>(anc),
      static_cast<const float*>(atoms), static_cast<float*>(out), n_pts,
      n_cells, n_q, cpb, a_pad, n_out, inv_rc2, cut2, h0, scale);
  return static_cast<int>(cudaGetLastError());
}
