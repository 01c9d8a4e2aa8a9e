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
// Output: out (n_dstb*128, F) f32; rows without edges are written as zeros.
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
// Design (a simple kernel that is right; tensor cores, TMA and cp.async are
// later work):
//   * one thread block per (destination block i, slice of FB = 64 feature
//     columns);
//   * edge_walk.cuh's walk_edges sums the block's edges into an fp32
//     accumulator of 128 rows x FB columns in shared memory: the edges are
//     staged in chunks, each row is summed by one warp in segment order (no
//     atomics, the same result on every run), and the h row loads are
//     coalesced, several in flight;
//   * the accumulator is written once; columns past F are masked (no
//     padding of F).

#include "edge_walk.cuh"

namespace {

using namespace edge_walk;

size_t smem_bytes(int max_blk) {
  return sizeof(float) * (size_t)BLK * FB + staging_bytes(max_blk);
}

__global__ void __launch_bounds__(THREADS)
aggregate_edges_kernel(const int* __restrict__ tile_off,
                       const float* __restrict__ val,
                       const int* __restrict__ seg,
                       const int* __restrict__ cols,
                       const float* __restrict__ h,
                       float* __restrict__ out,
                       int max_blk, long long n_src, int F) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* acc = reinterpret_cast<float*>(smem_raw);        // BLK * FB
  const Staging st = carve_staging(
      reinterpret_cast<unsigned char*>(acc + BLK * FB), max_blk);

  const int i = blockIdx.x;
  const int f0 = blockIdx.y * FB;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  zero(acc, BLK * FB);
  load_seg(seg, i, max_blk, st);
  __syncthreads();
  walk_edges(tile_off, val, cols + (long long)i * max_blk, h, acc, max_blk,
             n_src, F, f0, st);

  for (int r = warp; r < BLK; r += WARPS) {
    float* orow = out + ((long long)i * BLK + r) * F;
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      const int f = f0 + v * 32 + lane;
      if (f < F) orow[f] = acc[r * FB + v * 32 + lane];
    }
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory one launch needs for a layout with max_blk slots
// per destination block.
long long aggregate_edges_smem_bytes(int max_blk) {
  return (long long)smem_bytes(max_blk);
}

// Launches on `stream`; returns the CUDA status right after the launch
// (0 = launched). Does not synchronise and allocates nothing.
int aggregate_edges_launch(const int* tile_off, const float* val,
                           const int* seg, const int* cols, const float* h,
                           float* out, int n_dstb, int max_blk,
                           long long n_src, int F, void* stream) {
  const size_t smem = smem_bytes(max_blk);
  cudaError_t err = allow_smem(aggregate_edges_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(n_dstb, (F + FB - 1) / FB);
  aggregate_edges_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      tile_off, val, seg, cols, h, out, max_blk, n_src, F);
  return (int)cudaGetLastError();
}

const char* aggregate_edges_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

}  // extern "C"
