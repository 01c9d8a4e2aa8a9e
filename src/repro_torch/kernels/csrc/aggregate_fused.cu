// aggregate_fused: out = act((A @ h [+ s]) @ w [+ b]) with the sampled
// adjacency A given as per-tile edge segments (edge_walk.cuh), the
// aggregate A @ h never written to device memory.
//
// Replaces the Pallas TPU kernel src/repro/kernels/aggregate.py:_fused_kernel
// (called by aggregate_fused, with _stream_densify_tile; the forward of
// aggregate_fused_vjp, the "pallas_fused" datapath).
//
// Inputs, for one layer with n_dstb destination blocks of 128 rows:
//   tile_off, val, seg, cols   the segments, as for aggregate_edges
//   h  (n_src, F)        f32  source features, n_src = n_srcb*128
//   w  (F, N)            f32  update weights, unpadded
//   b  (N,)              f32  bias, or null
//   s  (n_dstb*128, F)   f32  additive self term folded in before w (GCN's
//                             agg + h_self, GIN's (1+eps) h_self + agg), or
//                             null
//   act                       0 none, 1 relu, 2 gelu (tanh form)
// Output: out (n_dstb*128, N) f32, every padded row written.
//
// What bounds it on an H100: at layer 0 of the paper's GraphSAGE batch
// (208 destination blocks, F = 602, N = 128, 59,370 edges) it must read the
// 23,998 distinct h rows the edges name (57.8 MB), the segments and w, and
// write the 13.6 MB output: 74 MB, 0.022 ms at 3.35 TB/s. Only the 6,340
// rows that hold an edge need the update product, 1.0 GFLOP, 0.016 ms at
// the 67 TFLOP/s of fp32 outside the tensor cores; over all 26,624 padded
// rows it would be 4.2 GFLOP, 0.062 ms. So for this batch it is bound by
// bytes, and the unfused path it replaces also writes and reads back a
// 64 MB aggregate. chip_smoke.py recomputes these bounds from the batch it
// runs; PERF.md has the measured times beside them.
//
// Design (a simple kernel that is right; wgmma, TMA and cp.async staging
// are later work):
//   * one thread block per (destination block i, range of NB = 128 output
//     columns), no float atomics;
//   * the aggregate is formed 64 feature columns at a time into a 128 x 64
//     shared-memory tile (the TPU kernel held all of F in VMEM, which does
//     not fit a block's 227 KB at F = 602), s is added, and the tile is
//     multiplied at once into the matching 64 rows of w, staged beside it,
//     so (A @ h) @ w = sum over slices of (A @ h[:, fs]) @ w[fs, :];
//   * the 128 x 128 result lives in registers (8 x 8 per thread) across the
//     slices; the epilogue adds b, applies act and writes only (128, N).

#include "fused_update.cuh"

namespace {

using namespace fused;

__global__ void __launch_bounds__(THREADS)
aggregate_fused_kernel(const int* __restrict__ tile_off,
                       const float* __restrict__ val,
                       const int* __restrict__ seg,
                       const int* __restrict__ cols,
                       const float* __restrict__ h,
                       const float* __restrict__ w,
                       const float* __restrict__ b,
                       const float* __restrict__ s,
                       float* __restrict__ out, int max_blk, long long n_src,
                       int F, int N, int act) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  update_block<false>(tile_off, val, seg, cols, h, w, b, s, nullptr, out,
                      blockIdx.x, blockIdx.y * NB, max_blk, n_src, F, N, act,
                      smem_raw);
}

}  // namespace

extern "C" {

// Dynamic shared memory of one thread block for a layout with max_blk
// slots per destination block.
long long aggregate_fused_smem_bytes(int max_blk) {
  return (long long)update_smem_bytes(max_blk);
}

// Launches on `stream`; returns the CUDA status right after the launch
// (0 = launched). Does not synchronise and allocates nothing.
int aggregate_fused_launch(const int* tile_off, const float* val,
                           const int* seg, const int* cols, const float* h,
                           const float* w, const float* b, const float* s,
                           float* out, int n_dstb, int max_blk,
                           long long n_src, int F, int N, int act,
                           void* stream) {
  const size_t smem = update_smem_bytes(max_blk);
  cudaError_t err = allow_smem(aggregate_fused_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(n_dstb, (N + NB - 1) / NB);
  aggregate_fused_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      tile_off, val, seg, cols, h, w, b, s, out, max_blk, n_src, F, N, act);
  return (int)cudaGetLastError();
}

const char* aggregate_fused_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

}  // extern "C"
