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
//     2. fused_dw_partial_kernel, one block per (group of contiguous
//        destination blocks, 64-column slice of F, 128 output columns),
//        recomputes each z slice of its group in shared memory and sums
//        z^T dy over the group, in order, into registers; it writes one
//        (F, N) partial per group (and a db partial);
//     3. fused_reduce_kernel adds the partials in group order.
//   No float atomics: dw has one summation order on every run. The groups
//   (kernels/aggregate.py:fused_bwd_groups) give the grid about 264 blocks
//   and keep the partials under 8 MB; at layer 0 of the paper batch that is
//   26 groups of 8 blocks, 8.0 MB, against the 64 MB aggregate the fused
//   datapath keeps out of device memory.
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
// Design: a simple kernel that is right. Plain fp32 FMA loops over
// register tiles (fused_update.cuh); wgmma, TMA and a wider grid for small
// layers are later work.

#include <algorithm>

#include "fused_update.cuh"

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
  update_block<true>(tile_off, val, seg, cols, h, w, b, s, g, dy, blockIdx.x,
                     blockIdx.y * NB, max_blk, n_src, F, N, act, smem_raw);
}

__global__ void __launch_bounds__(THREADS)
fused_dw_partial_kernel(const int* __restrict__ tile_off,
                        const float* __restrict__ val,
                        const int* __restrict__ seg,
                        const int* __restrict__ cols,
                        const float* __restrict__ h,
                        const float* __restrict__ s,
                        const float* __restrict__ dy,
                        float* __restrict__ part_dw,
                        float* __restrict__ part_db, int n_dstb,
                        int group_size, int max_blk, long long n_src, int F,
                        int N) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int grp = blockIdx.x;
  const int i_begin = grp * group_size;
  const int i_end = min(n_dstb, i_begin + group_size);
  float* db_out = (part_db != nullptr && blockIdx.y == 0)
                      ? part_db + (long long)grp * N : nullptr;
  dw_block(tile_off, val, seg, cols, h, s, dy,
           part_dw + (long long)grp * F * N, db_out, i_begin, i_end,
           blockIdx.y * FB, blockIdx.z * NB, max_blk, n_src, F, N, smem_raw);
}

// dw[x] = sum over groups, in order, of part_dw[grp][x]; then db likewise.
__global__ void __launch_bounds__(THREADS)
fused_reduce_kernel(const float* __restrict__ part_dw,
                    const float* __restrict__ part_db,
                    float* __restrict__ dw, float* __restrict__ db,
                    int n_groups, long long FN, int N) {
  const long long x = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (x < FN) {
    float acc = 0.f;
    for (int grp = 0; grp < n_groups; ++grp) acc += part_dw[grp * FN + x];
    dw[x] = acc;
  } else if (part_db != nullptr && x < FN + N) {
    const long long n = x - FN;
    float acc = 0.f;
    for (int grp = 0; grp < n_groups; ++grp)
      acc += part_db[(long long)grp * N + n];
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

// Dynamic shared memory of fused_bwd's largest thread block.
long long fused_bwd_smem_bytes(int max_blk) {
  return (long long)std::max(update_smem_bytes(max_blk),
                             dw_smem_bytes(max_blk));
}

// Launches fused_bwd's kernels on `stream` (see the top of this file);
// returns the CUDA status after the last launch (0 = launched). g is read
// as dy when act is none, and dy may then be null; part_dw holds n_groups
// (F, N) partials and part_db n_groups (N,) ones (null without a bias).
// Does not synchronise and allocates nothing.
int fused_bwd_launch(const int* tile_off, const float* val, const int* seg,
                     const int* cols, const float* h, const float* g,
                     const float* w, const float* b, const float* s,
                     float* dw, float* db, float* dy, float* part_dw,
                     float* part_db, int n_dstb, int max_blk,
                     long long n_src, int F, int N, int act, int group_size,
                     int n_groups, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int n_nb = (N + NB - 1) / NB;
  const float* dy_in = g;
  if (act != ACT_NONE) {
    const size_t smem = update_smem_bytes(max_blk);
    cudaError_t err = allow_smem(fused_dy_kernel, smem);
    if (err != cudaSuccess) return (int)err;
    fused_dy_kernel<<<dim3(n_dstb, n_nb), THREADS, smem, st>>>(
        tile_off, val, seg, cols, h, w, b, s, g, dy, max_blk, n_src, F, N,
        act);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    dy_in = dy;
  }
  const size_t smem = dw_smem_bytes(max_blk);
  cudaError_t err = allow_smem(fused_dw_partial_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  fused_dw_partial_kernel<<<dim3(n_groups, (F + FB - 1) / FB, n_nb),
                            THREADS, smem, st>>>(
      tile_off, val, seg, cols, h, s, dy_in, part_dw,
      b != nullptr ? part_db : nullptr, n_dstb, group_size, max_blk, n_src,
      F, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long FN = (long long)F * N;
  const long long total = FN + (b != nullptr ? N : 0);
  fused_reduce_kernel<<<(unsigned)((total + THREADS - 1) / THREADS), THREADS,
                        0, st>>>(part_dw, b != nullptr ? part_db : nullptr,
                                 dw, db, n_groups, FN, N);
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
