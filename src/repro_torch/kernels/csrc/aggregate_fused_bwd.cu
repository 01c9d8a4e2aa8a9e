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
//   one destination block, act none and F <= 256. One launch: blocks of
//   the first kind each take (source block j, 64-column slice) and write
//   dh = A^T @ dz for block j from the transposed segments (+0.0 when no
//   slot of cols[0] names j, as the reference masks it); blocks of the
//   second kind each take (64-column slice of F, 128 output columns) and
//   write dw = z^T g and db = sum_rows g straight, since one destination
//   block leaves nothing to reduce.
//
// What bounds them on an H100: the recompute reads the h rows the edges
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

#include <algorithm>

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

size_t merged_dh_smem_bytes(int max_blk_t) {
  return sizeof(float) * (size_t)BLK * FB + staging_bytes(max_blk_t);
}

__global__ void __launch_bounds__(THREADS)
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
                        float* __restrict__ dh, int max_blk, int max_blk_t,
                        long long n_src, int F, int N, int n_dh_blocks) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n_fs = (F + FB - 1) / FB;
  if ((int)blockIdx.x >= n_dh_blocks) {
    // dw / db role: the one destination block, slice fs, columns n0..
    const int k = blockIdx.x - n_dh_blocks;
    const int fs = k % n_fs;
    dw_block(tile_off, val, seg, cols, h, s, g, dw,
             fs == 0 ? db : nullptr, 0, 1, fs * FB, (k / n_fs) * NB,
             max_blk, n_src, F, N, smem_raw);
    return;
  }
  // dh role: source block j, columns f0 .. f0+FB
  const int j = blockIdx.x / n_fs;
  const int f0 = (blockIdx.x % n_fs) * FB;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  bool named = false;
  for (int k = threadIdx.x; k < max_blk; k += THREADS)
    named |= cols[k] == j;
  const bool covered = __syncthreads_or(named);
  float* acc = reinterpret_cast<float*>(smem_raw);   // BLK x FB
  zero(acc, BLK * FB);
  if (covered) {
    const Staging st = carve_staging(
        reinterpret_cast<unsigned char*>(acc + BLK * FB), max_blk_t);
    load_seg(seg_t, j, max_blk_t, st);
    __syncthreads();
    // A^T's destination block j gathers rows of dz, which has one block
    walk_edges(tile_off_t, val_t, cols_t + (long long)j * max_blk_t, dz, acc,
               max_blk_t, BLK, F, f0, st);
  }
  __syncthreads();
  for (int r = warp; r < BLK; r += WARPS) {
    float* orow = dh + ((long long)j * BLK + r) * F;
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      const int f = f0 + v * 32 + lane;
      if (f < F) orow[f] = acc[r * FB + v * 32 + lane];
    }
  }
}

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

// Dynamic shared memory of a fused_bwd_merged thread block.
long long fused_bwd_merged_smem_bytes(int max_blk, int max_blk_t) {
  return (long long)std::max(dw_smem_bytes(max_blk),
                             merged_dh_smem_bytes(max_blk_t));
}

// Launches fused_bwd_merged on `stream`: h is (n_src, F) with
// n_src = n_srcb*128 = the rows of dh, g (128, N), dz (128, F), s (128, F)
// or null, db null without a bias. Returns the CUDA status after the
// launch (0 = launched). Does not synchronise and allocates nothing.
int fused_bwd_merged_launch(const int* tile_off, const float* val,
                            const int* seg, const int* cols,
                            const int* tile_off_t, const float* val_t,
                            const int* seg_t, const int* cols_t,
                            const float* h, const float* g, const float* dz,
                            const float* s, float* dw, float* db, float* dh,
                            int max_blk, int max_blk_t, long long n_src,
                            int F, int N, void* stream) {
  const size_t smem = (size_t)fused_bwd_merged_smem_bytes(max_blk,
                                                          max_blk_t);
  cudaError_t err = allow_smem(fused_bwd_merged_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_fs = (F + FB - 1) / FB;
  const int n_dh_blocks = (int)(n_src / BLK) * n_fs;
  const int n_dw_blocks = n_fs * ((N + NB - 1) / NB);
  fused_bwd_merged_kernel<<<n_dh_blocks + n_dw_blocks, THREADS, smem,
                            (cudaStream_t)stream>>>(
      tile_off, val, seg, cols, tile_off_t, val_t, seg_t, cols_t, h, g, dz,
      s, dw, db, dh, max_blk, max_blk_t, n_src, F, N, n_dh_blocks);
  return (int)cudaGetLastError();
}

const char* aggregate_fused_bwd_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

}  // extern "C"
