// aggregate_edges: out = A @ h, with the sampled adjacency A given as
// per-tile edge segments over 128x128 tiles (kernels/layout.py).
//
// Replaces the Pallas TPU kernel src/repro/kernels/aggregate.py:_edges_kernel
// (called by aggregate_edges; through aggregate_edges_vjp the same kernel
// over the transposed segments is the backward, dh = A^T @ g).
//
// Inputs, for one layer with n_dstb destination blocks of BLK rows:
//   tile_off (E,)                  int32  cell offset row*128 + col in the tile
//   val      (E,)                  f32    edge weight (1/deg for a mean)
//   seg      (n_dstb*max_blk + 1,) int32  CSR offsets over the tile slots; the
//                                         edges of slot t are [seg[t], seg[t+1])
//                                         and masked edges lie past seg[-1]
//   cols     (n_dstb, max_blk)     int32  source block of each slot
//   h        (n_src, F)            f32    source features, n_src = n_srcb*128
// Output: out (n_dstb*128, F) f32; rows without edges are written as +0.0.
//
// The TPU kernel densified every 128x128 tile slot in VMEM and multiplied it
// into the feature block on the MXU. On a sampled batch only a few percent of
// the slots hold an edge (4% at layer 0 of the paper's GraphSAGE batch, ~5.6
// edges per non-empty tile), so that would be almost all multiplications by
// zero. This kernel touches only the edges: it is a gather-accumulate whose
// work is 2*E*F flops and whose traffic is the h rows the edges reference
// plus the output, so on an H100 it is bound by memory (3.35 TB/s), not
// arithmetic. At layer 0 of the paper batch (59,370 edges, 23,998 distinct
// source rows x 602 f32 read, 26,624 x 602 f32 written) that is 124.5 MB:
// a bound of 37 us at an H100 SXM's published 3.35 TB/s (700 W limit). The
// layer-1 launches move 3.5 and 14.1 MB, bounds of 1 and 4 us, below the
// cost of a launch. chip_smoke.py recomputes these bounds from the batch it
// runs; PERF.md has the measured times beside them.
//
// Design (the thread block's body is edge_rows.cuh, which
// aggregate_fused_bwd.cu's fused_bwd_merged shares for its dh and dw
// roles):
//   * the grid is (row group, destination block): a thread block of 256
//     threads owns R = 128 / groups rows of one destination block and every
//     column of them, at most 128 registers a thread so that two fit an SM;
//     kernels/aggregate.py: aggregate_edges_shape picks groups from the
//     shapes alone (no host sync): 32 rows at F = 602, so the paper batch's
//     52 busy layer-0 blocks become 208 thread blocks the card holds at
//     once, and enough groups elsewhere for four thread blocks an SM (16 of
//     8 rows at layer 1's 8 destination blocks);
//   * a destination block with no edge writes its group's rows as zeros by
//     float4 stores and leaves: it stages nothing;
//   * a busy block resolves its block's edges once, CHUNK at a time, for
//     every column: the thread of a slot writes the slot's source block
//     into its edges' places (no search per edge), and the edges of the
//     group's rows go into row order by a stable counting sort, each warp
//     ranking its share of the chunk with __match_any_sync (no atomics), so
//     each row keeps its edges in segment order;
//   * one warp takes a run of whole rows with about equal edges, its lanes
//     over the columns with the widest load the row stride and h's base
//     allow (float4 at F = 128, float2 at F = 602), 128 columns and
//     UNROLL h rows in flight at a time. Each row is summed in registers in
//     edge order, by fma from zero as the shared-memory tile of the earlier
//     design summed it (the same bits), and stored once; a row whose edges
//     span two chunks resumes from the sum it stored. No float atomics, no
//     shared-memory accumulator: the same bits on every run;
//   * h is indexed with 64-bit offsets (row * F reaches 1.8e8 at layer 0),
//     and a cell offset or source row out of range traps.
//
// On the paper batch layer 0 takes about 1.8x its bound: its edges gather
// 143 MB of h rows, 2.5x the distinct rows the bound counts (PERF.md).

#include <stdint.h>

#include "edge_rows.cuh"

namespace {

using edge_rows::BLK;
using edge_rows::Smem;
using edge_rows::THREADS;

// the grid is (row group, destination block); edge_rows.cuh holds the
// thread block's whole body
template <int V>
__global__ void __launch_bounds__(THREADS, 2)
aggregate_edges_kernel(const int* __restrict__ tile_off,
                       const float* __restrict__ val,
                       const int* __restrict__ seg,
                       const int* __restrict__ cols,
                       const float* __restrict__ h, float* __restrict__ out,
                       int max_blk, long long n_src, int F) {
  __shared__ Smem sm;
  const int R = BLK / gridDim.x;
  const int r0 = blockIdx.x * R;
  const long long slot0 = (long long)blockIdx.y * max_blk;
  edge_rows::block<V>(tile_off, val, seg + slot0, cols + slot0, h,
                      out + ((long long)blockIdx.y * BLK + r0) * F, max_blk,
                      n_src, F, r0, R, sm);
}

template <int V>
cudaError_t launch(const int* tile_off, const float* val, const int* seg,
                   const int* cols, const float* h, float* out, int n_dstb,
                   int max_blk, long long n_src, int F, int groups,
                   cudaStream_t st) {
  aggregate_edges_kernel<V><<<dim3(groups, n_dstb), THREADS, 0, st>>>(
      tile_off, val, seg, cols, h, out, max_blk, n_src, F);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` with `groups` row groups a destination block (a
// divisor of 128; kernels/aggregate.py: aggregate_edges_shape) and loads of
// `vec` floats (4, 2 or 1; aggregate_edges_vec: F and h's base must allow
// it); returns the CUDA status right after the launch (0 = launched). Does
// not synchronise and allocates nothing.
int aggregate_edges_launch(const int* tile_off, const float* val,
                           const int* seg, const int* cols, const float* h,
                           float* out, int n_dstb, int max_blk,
                           long long n_src, int F, int groups, int vec,
                           void* stream) {
  if (groups < 1 || groups > BLK || BLK % groups != 0 || n_dstb < 1 ||
      F < 1 || (vec != 4 && vec != 2 && vec != 1) || F % vec != 0 ||
      reinterpret_cast<uintptr_t>(h) % (4 * (uintptr_t)vec) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (vec) {
    case 4: return (int)launch<4>(tile_off, val, seg, cols, h, out, n_dstb,
                                  max_blk, n_src, F, groups, st);
    case 2: return (int)launch<2>(tile_off, val, seg, cols, h, out, n_dstb,
                                  max_blk, n_src, F, groups, st);
    default: return (int)launch<1>(tile_off, val, seg, cols, h, out, n_dstb,
                                   max_blk, n_src, F, groups, st);
  }
}

const char* aggregate_edges_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

}  // extern "C"
