// The backward of the fused aggregate -> update datapath (aggregate_fused.cu)
// for the "pallas_fused" backend. Two entry points:
//
// fused_bwd — replaces src/repro/kernels/aggregate.py:_fused_bwd_kernel
//   (called by _fused_bwd_call). With z = A @ h [+ s] recomputed per
//   destination block (it was never saved) and dy = g * act'(z @ w [+ b])
//   (dy = g for act none), returns dw = z^T dy (F, N), db = sum_rows dy
//   (N,) when there is a bias, and dy (n_dstb*128, N) when act is not none.
//   The TPU grid ran its destination blocks in order and carried dw from
//   one to the next in VMEM; CUDA blocks run in no order, so the sum is
//   split in a fixed way instead:
//     1. (act not none only) fused_dy_kernel, one block per (destination
//        block, 128 output columns), forms y as the forward does and
//        writes dy;
//     2. fused_dw_kernel, one thread block per (group, slab of z columns,
//        128 output columns), sums z_i^T dy_i over its group's destination
//        blocks, in order, into registers and writes one (F, N) partial per
//        group (and a db partial);
//     3. fused_reduce_kernel adds the partials in group order, skipping
//        the groups the plan gave no block (they wrote nothing).
//   No float atomics: dw has one summation order on every run.
//
// fused_bwd_merged — replaces src/repro/kernels/aggregate.py:
//   _fused_bwd_merged_kernel (called by _fused_bwd_merged_call), the case of
//   one destination block, act none and F <= 256: dw = z^T g, db =
//   sum_rows g and dh = A^T @ dz in one launch of 256-thread blocks in two
//   roles (see merged::dw_role and fused_bwd_merged_kernel below).
//
// What bounds fused_bwd_merged: at the GIN layer it serves (128 targets,
// 1,153 edges each way, h 3,328 x 128, N 41) it moves 2.4 MB, a bound of
// 0.7 us at 3.35 TB/s, below the cost of one launch: it is latency-bound,
// a chain of dependent loads, barriers and one cross-block sum. So the
// design spreads each role over enough thread blocks that no chain is
// long, in one launch (the unfused composition it replaces takes 4-5):
//   * dh role: the row groups of each source block of A^T that
//     kernels/aggregate.py: fused_bwd_merged_shape sizes as
//     aggregate_edges_shape does, each aggregate_edges' thread block
//     (edge_rows.cuh: block) over the transposed segments with dz as h, so
//     dh is bit for bit what aggregate_edges over A^T gives. A source block
//     that no slot of cols[0] names has no transposed edge (every
//     transposed edge's block is named by its forward slot), so it writes
//     +0.0 and leaves as any empty block does: no scan of cols;
//   * dw role, the launch's first cluster of 16 thread blocks (all blocks
//     run in clusters of 16, the dh ones padded to whole clusters): each
//     rank takes 8 rows of the destination block, walks their edges with
//     the same row walk into a zeroed z tile in shared memory (s and the
//     rows' g land by cp.async meanwhile), forms its partial z_R^T g_R on
//     mma.sync m16n8k8 with the 3xTF32 split (mma_tf32.cuh), A = z + s, one
//     A fragment for up to 8 n tiles, and stores it to device memory in
//     fragment order, whole lines (a partial of sum_rows g_R beside it);
//     after a cluster barrier, whose release and acquire order those
//     stores before the loads, each rank adds its share of the elements
//     over the 16 partials in rank order. No float atomics and no state
//     kept between launches: the same bits on every run.
//
// On an H100 the dw role's chain sets the time (PERF.md): its first
// barrier, resolving the block's edges and walking its rows take most of
// it, then the product, the barrier and the sum; the dh role ends long
// before.
//
// What bounds fused_bwd on an H100: the recompute reads the h rows the edges
// name and the segments, as the forward does, plus g, and writes dw; the
// products are 2 * rows * F * N flops over the rows that hold an edge or a
// self term (twice that with an activation, which forms y first). At layer
// 0 of the paper batch that is 74 MB and 1.0 GFLOP: bound by bytes
// (0.022 ms at 3.35 TB/s). chip_smoke.py recomputes the bounds from the
// batch it runs.
//
// fused_dw_kernel's design. At layer 0 of the paper batch only 52 of the
// 208 destination blocks hold an edge (~1,142 each), and each edge names
// a 2.4 KB h row: the rows the edges gather come to 143 MB, 2.5x the
// 57.8 MB of distinct rows the bound counts, and gathering them takes
// about half the time (the rest is resolving edges, staging and the
// product; PERF.md has the split):
//   * the plan (kernels/aggregate.py: fused_bwd_shape, fused_bwd_plan)
//     cuts the destination blocks into contiguous groups of about equal
//     work on the device, and sizes the grid at one 512-thread block per
//     SM from the shapes; a block with no edge and no s (and no db to add
//     to) is skipped before any load;
//   * a thread block covers a slab of S = 128 or 32 z columns (the plan
//     narrows it where a layer has few destination blocks), so it
//     resolves each edge of a block once for S columns and walks it once
//     (fused_walk.cuh, shared with the forward in aggregate_fused.cu:
//     edges sorted by row without atomics on the order, each row summed
//     by one warp in edge order, 16 / (S / 32) h rows in flight a lane;
//     more ran no faster) into the z tile, which holds s (or zeros);
//   * s and the block's dy tile are staged by cp.async while the edges are
//     resolved and walked;
//   * z_slab^T dy runs on mma.sync m16n8k8 with the 3xTF32 split
//     (mma_tf32.cuh: split_tf32_fast, each step of 8 rows summed from zero
//     and joined to the fp32 accumulator by a rounded add), 16 warps as
//     (S / 32) x (16 / (S / 32)), each owning 32 z columns and a share of
//     the 128 output columns in registers across the group's blocks.

#include <stdint.h>

#include <cooperative_groups.h>

#include <algorithm>

#include "edge_rows.cuh"
#include "fused_update.cuh"
#include "fused_walk.cuh"
#include "mma_tf32.cuh"

namespace {

using namespace fused;

__global__ void __launch_bounds__(THREADS)
fused_dy_kernel(const int* __restrict__ tile_off,
                const float* __restrict__ val, const int* __restrict__ seg,
                const int* __restrict__ cols, const float* __restrict__ h,
                const float* __restrict__ w, const float* __restrict__ b,
                const float* __restrict__ s, const float* __restrict__ g,
                float* __restrict__ dy, int max_blk, long long n_src, int F,
                int N, int act) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  dy_block(tile_off, val, seg, cols, h, w, b, s, g, dy, blockIdx.x,
           blockIdx.y * NB, max_blk, n_src, F, N, act, smem_raw);
}

namespace dwk {

using fused_walk::CHUNK;
using fused_walk::Smem;
using fused_walk::THREADS;
using fused_walk::WARPS;
using fused_walk::resolve;
using fused_walk::stage_any;
using fused_walk::vec_width;
using fused_walk::walk;
constexpr int LDY = NB + 8;             // dy tile row stride (B rows: 8 mod 32)

// the product over a slab of S z columns
template <int S>
struct Slab {
  static constexpr int LDZ = S + 8;          // z tile row stride
  static constexpr int MW = S / 32;          // product: warps along z
  static constexpr int NW = WARPS / MW;      // ... and along dy columns
  static constexpr int NT = NB / NW / 8;     // n8 tiles of a warp
};

__host__ __device__ inline size_t smem_bytes(int slab) {
  return fused_walk::smem_bytes((size_t)BLK * (slab + 8), (size_t)BLK * LDY);
}

// part_dw[grp][f0 .. f0+S, n0 .. n0+NB] = sum over the group's destination
// blocks i, in order, of z_i[:, slab]^T dy_i[:, n0 ..]; with part_db (the
// first slab's thread blocks) also the sum of dy_i's rows.
template <int S>
__global__ void __launch_bounds__(THREADS, 1)
fused_dw_kernel(const int* __restrict__ tile_off,
                const float* __restrict__ val, const int* __restrict__ seg,
                const int* __restrict__ cols, const float* __restrict__ h,
                const float* __restrict__ s, const float* __restrict__ dy,
                const long long* __restrict__ bounds,
                float* __restrict__ part_dw, float* __restrict__ part_db,
                int max_blk, long long n_src, int F, int N) {
  using P = Slab<S>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int grp = blockIdx.x;
  const int i_begin = (int)bounds[grp], i_end = (int)bounds[grp + 1];
  if (i_begin >= i_end) return;  // the plan gave this group no block
  const int f0 = blockIdx.y * S, n0 = blockIdx.z * NB;
  const bool with_db = part_db != nullptr && blockIdx.y == 0;
  const Smem sm = fused_walk::carve(smem_raw, BLK * P::LDZ, BLK * LDY);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // product: warp (wm, wn) owns z columns 32 wm .. and dy columns
  // NT*8 wn ..; g and t index the mma fragments (mma_tf32.cuh)
  const int wm = warp % P::MW, wn = warp / P::MW;
  const int g = lane >> 2, t = lane & 3;
  const bool warp_cols = n0 + wn * P::NT * 8 < N;  // any column to form
  const int v_s = s != nullptr ? vec_width(s, F) : 1;
  const int v_dy = vec_width(dy, N);

  float acc[2][P::NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < P::NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  float db_acc = 0.f;
  for (int x = tid; x < WARPS * BLK; x += THREADS) sm.wcnt[x] = 0;

  for (int i = i_begin; i < i_end; ++i) {
    const long long slot0 = (long long)i * max_blk;
    const int e_begin = seg[slot0], e_end = seg[slot0 + max_blk];
    const bool need_z = e_end > e_begin || s != nullptr;
    if (!need_z && !with_db) continue;
    const long long row0 = (long long)i * BLK;
    // z's base (s, or zeros) and the dy tile land while the edges resolve
    if (s != nullptr) {
      stage_any<S>(sm.zt, P::LDZ, s, F, row0, BLK, f0, F, v_s);
    } else {
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int x = tid; x < BLK * S / 4; x += THREADS)
        *reinterpret_cast<float4*>(sm.zt + (x / (S / 4)) * P::LDZ
                                   + (x % (S / 4)) * 4) = zero;
    }
    mma_tf32::cp_async_commit();
    stage_any<NB>(sm.op, LDY, dy, N, row0, BLK, n0, N, v_dy);
    mma_tf32::cp_async_commit();
    if (e_end > e_begin) {
      for (int c0 = e_begin; c0 < e_end; c0 += CHUNK) {
        const int n = min(CHUNK, e_end - c0);
        if (tid < BLK) sm.cur[tid] = 0;  // the last user synced after it
        resolve(tile_off, val, seg + slot0, cols + slot0, c0, n, max_blk,
                n_src, sm);
        if (c0 == e_begin) {
          mma_tf32::cp_async_wait<1>();  // z's base landed
          __syncthreads();
        }
        walk<S, P::LDZ>(h, n, F, f0, sm);
        __syncthreads();
      }
    }
    mma_tf32::cp_async_wait<0>();
    __syncthreads();
    if (need_z && warp_cols) {
      // z^T dy over the block's 128 rows, 8 at a time: A = z^T (the z tile
      // read transposed), B = dy, 3xTF32 (mma_tf32.cuh)
      const float* za = sm.zt + wm * 32;
      const float* yb = sm.op + wn * P::NT * 8;
#pragma unroll 1
      for (int k0 = 0; k0 < BLK; k0 += 8) {
        uint32_t a_hi[2][4], a_lo[2][4], b_hi[P::NT][2], b_lo[P::NT][2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          mma_tf32::load_a_t(za + k0 * P::LDZ + mt * 16, P::LDZ, g, t,
                             a_hi[mt], a_lo[mt]);
#pragma unroll
        for (int nt = 0; nt < P::NT; ++nt)
          mma_tf32::load_b(yb + k0 * LDY + nt * 8, LDY, g, t, b_hi[nt],
                           b_lo[nt]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < P::NT; ++nt)
            mma_tf32::mma_step(acc[mt][nt], a_hi[mt], a_lo[mt], b_hi[nt],
                               b_lo[nt]);
      }
    }
    if (with_db && tid < NB)
      for (int r = 0; r < BLK; ++r) db_acc += sm.op[r * LDY + tid];
    __syncthreads();  // z, dy and the staging are free for the next block
  }

  float* out = part_dw + (long long)grp * F * N;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int f = f0 + wm * 32 + mt * 16 + g + 8 * half;
      if (f >= F) continue;
#pragma unroll
      for (int nt = 0; nt < P::NT; ++nt) {
        const int n = n0 + wn * P::NT * 8 + nt * 8 + 2 * t;
        float* o = out + (long long)f * N + n;
        if (n < N) o[0] = acc[mt][nt][2 * half];
        if (n + 1 < N) o[1] = acc[mt][nt][2 * half + 1];
      }
    }
  if (with_db && tid < NB && n0 + tid < N)
    part_db[(long long)grp * N + n0 + tid] = db_acc;
}

template <int S>
cudaError_t launch_dw(const int* tile_off, const float* val, const int* seg,
                      const int* cols, const float* h, const float* s,
                      const float* dy, const long long* bounds,
                      float* part_dw, float* part_db, int n_groups,
                      int max_blk, long long n_src, int F, int N,
                      cudaStream_t st) {
  const size_t smem = smem_bytes(S);
  cudaError_t err = allow_smem(fused_dw_kernel<S>, smem);
  if (err != cudaSuccess) return err;
  fused_dw_kernel<S><<<dim3(n_groups, (F + S - 1) / S, (N + NB - 1) / NB),
                       THREADS, smem, st>>>(
      tile_off, val, seg, cols, h, s, dy, bounds, part_dw, part_db, max_blk,
      n_src, F, N);
  return cudaGetLastError();
}

}  // namespace dwk

// dw[x] = sum over the groups the plan gave a block, in group order, of
// part_dw[grp][x]; then db likewise. Only those groups wrote a partial; a
// warp lists them in shared memory (n_groups ints) first.
__global__ void __launch_bounds__(THREADS)
fused_reduce_kernel(const float* __restrict__ part_dw,
                    const float* __restrict__ part_db,
                    const long long* __restrict__ bounds,
                    float* __restrict__ dw, float* __restrict__ db,
                    int n_groups, long long FN, int N) {
  extern __shared__ int written[];
  __shared__ int n_written;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int n = 0;
    for (int g0 = 0; g0 < n_groups; g0 += 32) {
      const int grp = g0 + lane;
      const bool wrote = grp < n_groups && bounds[grp] < bounds[grp + 1];
      const unsigned m = __ballot_sync(0xffffffffu, wrote);
      if (wrote) written[n + __popc(m & ((1u << lane) - 1u))] = grp;
      n += __popc(m);
    }
    if (lane == 0) n_written = n;
  }
  __syncthreads();
  const int nw = n_written;
  const long long x = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (x < FN) {
    float acc = 0.f;
#pragma unroll 4
    for (int k = 0; k < nw; ++k) acc += part_dw[written[k] * FN + x];
    dw[x] = acc;
  } else if (part_db != nullptr && x < FN + N) {
    const long long n = x - FN;
    float acc = 0.f;
#pragma unroll 4
    for (int k = 0; k < nw; ++k)
      acc += part_db[(long long)written[k] * N + n];
    db[n] = acc;
  }
}

namespace merged {

namespace cg = cooperative_groups;
using edge_rows::BLK;
using edge_rows::CHUNK;
using edge_rows::Smem;
using edge_rows::THREADS;
using edge_rows::WARPS;
using edge_rows::resolve;
using edge_rows::walk;

constexpr int NB = 128;          // output columns of one product pass
constexpr int LDG = NB + 8;      // g tile row stride (B rows: 8 mod 32)
constexpr int MAX_RANKS = 16;    // the largest cluster (non-portable)
constexpr int NTC = 8;           // 8-column tiles a warp multiplies at once

// z and s tile row stride: F rounded up to 32, plus 8 (z^T is read as A by
// rows of z: 8 mod 32), a multiple of 4 floats for the walk's stores
__host__ __device__ inline int ldz(int F) { return (F + 31) / 32 * 32 + 8; }

// dynamic shared memory of the dw role: the z and s tiles (R x ldz each)
// and the g tile (R x LDG), R = BLK / dw_groups
__host__ __device__ inline size_t dw_smem_bytes(int F, int dw_groups) {
  const size_t R = BLK / dw_groups;
  return sizeof(float) * R * (2 * (size_t)ldz(F) + LDG);
}

// dst[r * ldd + c] = src[(row0 + r) * lds + c0 + c] for r < rows and the
// columns c < width below cols - c0 rounded up to 8 (those at or past cols
// zero-filled), by cp.async of the widest copy src's row stride and base
// allow
template <int V>
__device__ inline void stage_v(float* dst, int ldd, const float* src,
                               long long lds, int row0, int rows, int c0,
                               int cols, int width) {
  const int per_row = min(width, (cols - c0 + 7) & ~7) / V;
  for (int x = threadIdx.x; x < rows * per_row; x += THREADS) {
    const int r = x / per_row, c = (x % per_row) * V;
    const int left = cols - (c0 + c);
    const int n = left >= V ? V : (left > 0 ? left : 0);
    mma_tf32::cp_async<4 * V>(dst + r * ldd + c,
                              n > 0 ? src + (row0 + r) * lds + c0 + c : src,
                              4 * n);
  }
}

__device__ inline void stage(float* dst, int ldd, const float* src,
                             long long lds, int row0, int rows, int c0,
                             int cols, int width) {
  const int v = fused_walk::vec_width(src, lds);
  if (v == 4) stage_v<4>(dst, ldd, src, lds, row0, rows, c0, cols, width);
  else if (v == 2) stage_v<2>(dst, ldd, src, lds, row0, rows, c0, cols, width);
  else stage_v<1>(dst, ldd, src, lds, row0, rows, c0, cols, width);
}

// dw = the sum over the ranks' partials, in rank order from zero, for
// rank `rank`'s share of the fragments: each partial holds, for every
// (16 x 8) tile (mt, nt) of dw padded to whole tiles, the 32 lanes' D
// fragments, four floats a lane (mma_tf32.cuh: d0 D[g][2t], d1 D[g][2t+1],
// d2 D[g+8][2t], d3 D[g+8][2t+1]), so a rank stores whole lines; here each
// thread loads one float from every partial at once, past L1
__device__ inline void sum_fragments(const float* part, float* dw, int F,
                                     int N, int rank, int ranks) {
  const int NT_ALL = (N + 7) / 8;
  const long long n1 = (long long)(F + 15) / 16 * NT_ALL * 128;
  const long long hi = n1 * (rank + 1) / ranks;
  for (long long x = n1 * rank / ranks + threadIdx.x; x < hi; x += THREADS) {
    float v[MAX_RANKS];
#pragma unroll
    for (int k = 0; k < MAX_RANKS; ++k)
      if (k < ranks) v[k] = __ldcg(part + k * n1 + x);
    float a = 0.f;
#pragma unroll
    for (int k = 0; k < MAX_RANKS; ++k)
      if (k < ranks) a += v[k];
    const int tile = (int)(x / 128), lane = (int)(x / 4 % 32);
    const int e = (int)(x % 4);
    const int f = tile / NT_ALL * 16 + (lane >> 2) + 8 * (e >> 1);
    const int n = tile % NT_ALL * 8 + 2 * (lane & 3) + (e & 1);
    if (f < F && n < N) dw[(long long)f * N + n] = a;
  }
}

// The dw role, rank `rank` of the launch's first cluster of `ranks` thread
// blocks: rows r0 .. r0+R of the one destination block, R = BLK / ranks.
// Walks z_R = A_R @ h into its zeroed shared-memory tile with the shared
// row walk (s's rows and 128 columns of g land by cp.async meanwhile),
// forms its partial z_R^T g_R (z + s read as A) on mma.sync 3xTF32 into
// part_dw[rank], in fragment order, and sum_rows g_R into part_db[rank];
// once every rank's partials are written (a cluster barrier), sums its
// share of dw's (and db's) elements over the partials in rank order. No
// float atomics: the same bits on every run.
template <int V>
__device__ void dw_role(const int* __restrict__ tile_off,
                        const float* __restrict__ val,
                        const int* __restrict__ seg,
                        const int* __restrict__ cols,
                        const float* __restrict__ h,
                        const float* __restrict__ s,
                        const float* __restrict__ g,
                        float* __restrict__ part_dw,
                        float* __restrict__ part_db, float* __restrict__ dw,
                        float* __restrict__ db, int max_blk,
                        long long n_src, int F, int N, Smem& sm,
                        float* dyn) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int ranks = (int)cluster.num_blocks();
  const int R = BLK / ranks, r0 = rank * R;
  const int LDZ = ldz(F);
  float* zt = dyn;             // R x LDZ: z
  float* st = zt + R * LDZ;    // R x LDZ: s
  float* gt = st + R * LDZ;    // R x LDG: 128 columns of g
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (s != nullptr) stage(st, LDZ, s, F, r0, R, 0, F, LDZ);
  stage(gt, LDG, g, N, r0, R, 0, N, NB);
  mma_tf32::cp_async_commit();
  // z starts at zero: the walk stores each row that has an edge
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int x = tid; x < R * LDZ / 4; x += THREADS)
    reinterpret_cast<float4*>(zt)[x] = zero;
  const int e_begin = __ldg(seg), e_end = __ldg(seg + max_blk);
  if (tid < R) sm.started[tid] = 0;
  if (tid <= R) sm.start[tid] = 0;
  __syncthreads();
  for (int c0 = e_begin; c0 < e_end; c0 += CHUNK) {
    const int n = min(CHUNK, e_end - c0);
    resolve(tile_off, val, seg, cols, c0, n, max_blk, n_src, r0, R, sm);
    walk<V>(h, zt, LDZ, F, R, sm);
  }
  mma_tf32::cp_async_wait<0>();
  __syncthreads();
  // z_R^T g_R, 128 columns of N a pass: warp w takes the 16-row tiles w,
  // w + WARPS, ... of F, and up to NTC 8-column tiles of the pass at once,
  // so one A fragment serves NTC independent products; each is summed over
  // the R rows 8 at a time. A[f][r] = z[r][f] + s[r][f] (mma_tf32.cuh:
  // load_a_t's fragment)
  const int gq = lane >> 2, tq = lane & 3;
  const int MT = (F + 15) / 16, NT_ALL = (N + 7) / 8;
  float4* pdw = reinterpret_cast<float4*>(part_dw) +
                (long long)rank * MT * NT_ALL * 32;
  auto a_at = [&](int r, int f) {
    const float z = zt[r * LDZ + f];
    return s != nullptr && f < F ? z + st[r * LDZ + f] : z;
  };
  for (int n0 = 0; n0 < N; n0 += NB) {
    if (n0 > 0) {
      __syncthreads();  // every warp is done with the last g columns
      stage(gt, LDG, g, N, r0, R, n0, N, NB);
      mma_tf32::cp_async_commit();
      mma_tf32::cp_async_wait<0>();
      __syncthreads();
    }
    const int NT = (min(NB, N - n0) + 7) / 8;
    for (int mt = warp; mt < MT; mt += WARPS) {
      const int f = mt * 16 + gq;
      for (int nt0 = 0; nt0 < NT; nt0 += NTC) {
        float acc[NTC][4];
#pragma unroll
        for (int j = 0; j < NTC; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
        for (int k0 = 0; k0 < R; k0 += 8) {
          uint32_t a_hi[4], a_lo[4];
          mma_tf32::split_tf32_fast(a_at(k0 + tq, f), a_hi[0], a_lo[0]);
          mma_tf32::split_tf32_fast(a_at(k0 + tq, f + 8), a_hi[1], a_lo[1]);
          mma_tf32::split_tf32_fast(a_at(k0 + tq + 4, f), a_hi[2], a_lo[2]);
          mma_tf32::split_tf32_fast(a_at(k0 + tq + 4, f + 8), a_hi[3],
                                    a_lo[3]);
#pragma unroll
          for (int j = 0; j < NTC; ++j) {
            if (nt0 + j >= NT) break;  // the same for the whole warp
            uint32_t b_hi[2], b_lo[2];
            mma_tf32::load_b(gt + k0 * LDG + (nt0 + j) * 8, LDG, gq, tq,
                             b_hi, b_lo);
            mma_tf32::mma_step(acc[j], a_hi, a_lo, b_hi, b_lo);
          }
        }
        // the D fragments as they lie in the lanes, a float4 a lane
#pragma unroll
        for (int j = 0; j < NTC; ++j) {
          if (nt0 + j >= NT) break;
          pdw[((long long)mt * NT_ALL + n0 / 8 + nt0 + j) * 32 + lane] =
              make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
        }
      }
    }
    if (part_db != nullptr && tid < NB && n0 + tid < N) {
      float d = 0.f;
      for (int r = 0; r < R; ++r) d += gt[r * LDG + tid];
      part_db[(long long)rank * N + n0 + tid] = d;
    }
  }
  // every rank's partials are in device memory: the barrier's arrive has
  // release and its wait acquire semantics at cluster scope, so the stores
  // before it are seen by the loads after it
  cluster.sync();
  sum_fragments(part_dw, dw, F, N, rank, ranks);
  if (part_db != nullptr) {  // db likewise, rank `rank`'s share of N
    for (int n = N * rank / ranks + tid; n < N * (rank + 1) / ranks;
         n += THREADS) {
      float v[MAX_RANKS];
#pragma unroll
      for (int k = 0; k < MAX_RANKS; ++k)
        if (k < ranks) v[k] = __ldcg(part_db + (long long)k * N + n);
      float d = 0.f;
#pragma unroll
      for (int k = 0; k < MAX_RANKS; ++k)
        if (k < ranks) d += v[k];
      db[n] = d;
    }
  }
}

template <int V>
__global__ void __launch_bounds__(THREADS, 2)
fused_bwd_merged_kernel(const int* __restrict__ tile_off,
                        const float* __restrict__ val,
                        const int* __restrict__ seg,
                        const int* __restrict__ cols,
                        const int* __restrict__ tile_off_t,
                        const float* __restrict__ val_t,
                        const int* __restrict__ seg_t,
                        const int* __restrict__ cols_t,
                        const float* __restrict__ h,
                        const float* __restrict__ g,
                        const float* __restrict__ dz,
                        const float* __restrict__ s,
                        float* __restrict__ dw, float* __restrict__ db,
                        float* __restrict__ dh, float* __restrict__ part_dw,
                        float* __restrict__ part_db, int max_blk,
                        int max_blk_t, long long n_src, int F, int N,
                        int dh_groups, int dw_groups) {
  __shared__ Smem sm;
  extern __shared__ __align__(16) float dyn[];
  if ((int)blockIdx.x < dw_groups) {  // the first cluster
    dw_role<V>(tile_off, val, seg, cols, h, s, g, part_dw, part_db, dw, db,
               max_blk, n_src, F, N, sm, dyn);
    return;
  }
  // dh role: row group grp of source block j, aggregate_edges' thread
  // block over A^T, whose one source block is dz; the blocks past the
  // last source block pad the grid to whole clusters
  const int k = blockIdx.x - dw_groups;
  const int j = k / dh_groups, grp = k % dh_groups;
  if ((long long)j * BLK >= n_src) return;
  const int R = BLK / dh_groups, r0 = grp * R;
  const long long slot0 = (long long)j * max_blk_t;
  edge_rows::block<V>(tile_off_t, val_t, seg_t + slot0, cols_t + slot0, dz,
                      dh + ((long long)j * BLK + r0) * F, max_blk_t, BLK, F,
                      r0, R, sm);
}

template <int V>
cudaError_t launch(const int* tile_off, const float* val, const int* seg,
                   const int* cols, const int* tile_off_t, const float* val_t,
                   const int* seg_t, const int* cols_t, const float* h,
                   const float* g, const float* dz, const float* s, float* dw,
                   float* db, float* dh, float* part_dw, float* part_db,
                   int max_blk, int max_blk_t, long long n_src, int F, int N,
                   int dh_groups, int dw_groups, cudaStream_t st) {
  auto kernel = fused_bwd_merged_kernel<V>;
  const size_t smem = dw_smem_bytes(F, dw_groups);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && dw_groups > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  // the dw cluster, then the dh row groups in whole clusters
  const long long n_dh = n_src / BLK * dh_groups;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(dw_groups + (n_dh + dw_groups - 1)
                                / dw_groups * dw_groups));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = dw_groups;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, tile_off, val, seg, cols,
                            tile_off_t, val_t, seg_t, cols_t, h, g, dz, s,
                            dw, db, dh, part_dw, part_db, max_blk, max_blk_t,
                            n_src, F, N, dh_groups, dw_groups);
}

}  // namespace merged

}  // namespace

extern "C" {

// Dynamic shared memory of fused_bwd's largest thread block, for a layout
// with max_blk slots per destination block and the plan's slab.
long long fused_bwd_smem_bytes(int max_blk, int slab) {
  return (long long)std::max(update_smem_bytes(max_blk),
                             dwk::smem_bytes(slab));
}

// Launches fused_bwd's kernels on `stream` (see the top of this file);
// returns the CUDA status after the last launch (0 = launched). g is read
// as dy when act is none, and dy may then be null; bounds (n_groups + 1)
// are the plan's groups (kernels/aggregate.py: fused_bwd_plan), slab its
// z columns per thread block (128 or 32); part_dw holds n_groups
// (F, N) partials and part_db n_groups (N,) ones (null without a bias).
// Does not synchronise and allocates nothing.
int fused_bwd_launch(const int* tile_off, const float* val, const int* seg,
                     const int* cols, const float* h, const float* g,
                     const float* w, const float* b, const float* s,
                     const long long* bounds, float* dw, float* db,
                     float* dy, float* part_dw, float* part_db, int n_dstb,
                     int max_blk,
                     long long n_src, int F, int N, int act, int n_groups,
                     int slab, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const float* dy_in = g;
  if (act != ACT_NONE) {
    const size_t smem = update_smem_bytes(max_blk);
    cudaError_t err = allow_smem(fused_dy_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    fused_dy_kernel<<<dim3(n_dstb, (N + NB - 1) / NB), THREADS, smem, st>>>(
        tile_off, val, seg, cols, h, w, b, s, g, dy, max_blk, n_src, F, N,
        act);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    dy_in = dy;
  }
  float* pdb = b != nullptr ? part_db : nullptr;
  auto dw_pass = [&](auto launch) {
    return launch(tile_off, val, seg, cols, h, s, dy_in, bounds, part_dw,
                  pdb, n_groups, max_blk, n_src, F, N, st);
  };
  cudaError_t err;
  switch (slab) {
    case 128: err = dw_pass(dwk::launch_dw<128>); break;
    case 32: err = dw_pass(dwk::launch_dw<32>); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  const long long FN = (long long)F * N;
  const long long total = FN + (b != nullptr ? N : 0);
  const size_t list = sizeof(int) * (size_t)n_groups;
  err = allow_smem(fused_reduce_kernel, list);
  if (err != cudaSuccess) return (int)err;
  fused_reduce_kernel<<<(unsigned)((total + THREADS - 1) / THREADS), THREADS,
                        list, st>>>(part_dw, pdb, bounds, dw, db, n_groups,
                                    FN, N);
  return (int)cudaGetLastError();
}

// Launches fused_bwd_merged on `stream` (see the top of this file): h is
// (n_src, F) with n_src = n_srcb*128 = the rows of dh, g (128, N), dz
// (128, F), s (128, F) or null, db and part_db null without a bias;
// part_dw holds dw_groups partials of (F rounded up to 16) x (N rounded
// up to 8) floats and part_db dw_groups (N,) ones.
// dh_groups row
// groups a source block (a divisor of 128; kernels/aggregate.py:
// fused_bwd_merged_shape), dw_groups for the destination block and the
// size of the launch's clusters (2, 4, 8 or 16), loads of `vec` floats (4,
// 2 or 1; F and the bases of h and dz must allow it). Returns the CUDA
// status of the launch (0 = launched). Does not synchronise and allocates
// nothing.
int fused_bwd_merged_launch(const int* tile_off, const float* val,
                            const int* seg, const int* cols,
                            const int* tile_off_t, const float* val_t,
                            const int* seg_t, const int* cols_t,
                            const float* h, const float* g, const float* dz,
                            const float* s, float* dw, float* db, float* dh,
                            float* part_dw, float* part_db, int max_blk,
                            int max_blk_t, long long n_src, int F, int N,
                            int dh_groups, int dw_groups, int vec,
                            void* stream) {
  const uintptr_t align = 4 * (uintptr_t)vec;
  if (dh_groups < 1 || dh_groups > BLK || BLK % dh_groups != 0 ||
      dw_groups < 2 || dw_groups > 16 || BLK % dw_groups != 0 ||
      F < 1 || F > 256 || N < 0 || n_src < BLK || n_src % BLK != 0 ||
      max_blk < 1 || max_blk_t < 1 ||
      (vec != 4 && vec != 2 && vec != 1) || F % vec != 0 ||
      reinterpret_cast<uintptr_t>(h) % align != 0 ||
      reinterpret_cast<uintptr_t>(dz) % align != 0 ||
      (db == nullptr) != (part_db == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  auto go = [&](auto launch) {
    return (int)launch(tile_off, val, seg, cols, tile_off_t, val_t, seg_t,
                       cols_t, h, g, dz, s, dw, db, dh, part_dw, part_db,
                       max_blk, max_blk_t, n_src, F, N, dh_groups, dw_groups,
                       st);
  };
  switch (vec) {
    case 4: return go(merged::launch<4>);
    case 2: return go(merged::launch<2>);
    default: return go(merged::launch<1>);
  }
}

const char* aggregate_fused_bwd_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

}  // extern "C"
