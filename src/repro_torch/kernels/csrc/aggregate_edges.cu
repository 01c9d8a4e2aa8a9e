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
//   * one thread block per (destination block i, slice of FB feature
//     columns); the edges of block i are the contiguous range
//     seg[i*max_blk] .. seg[(i+1)*max_blk];
//   * the block's seg slice sits in shared memory; the edges are staged in
//     chunks, each thread resolving one edge's tile slot by binary search
//     and writing its destination row, source row cols[i,k]*128 + col, and
//     weight to shared memory;
//   * an fp32 accumulator of 128 rows x FB columns lives in shared memory.
//     Warp w owns the rows r with r % WARPS == w and walks the staged edges
//     in order, so every row is summed by one warp in edge order: no
//     atomics, and the result is the same on every run. Lanes run over the
//     feature columns, so each h row load is coalesced; up to 4 edges'
//     loads are issued before their adds to keep loads in flight;
//   * the accumulator is written once; columns past F are masked (no
//     padding of F), and 64-bit offsets index h and out (row*F reaches
//     1.8e8 at layer 0).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLK = 128;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int VEC = 2;            // feature columns per lane
constexpr int FB = 32 * VEC;      // feature columns per thread block
constexpr int CHUNK = 1024;       // edges staged in shared memory per pass
constexpr int UNROLL = 4;         // edges whose loads are in flight together

size_t smem_bytes(int max_blk) {
  return sizeof(float) * (size_t)BLK * FB          // accumulator
         + sizeof(int) * ((size_t)max_blk + 1)     // seg slice
         + (sizeof(int) * 2 + sizeof(float)) * CHUNK;  // staged edges
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
  int* s_seg = reinterpret_cast<int*>(acc + BLK * FB);    // max_blk + 1
  int* s_row = s_seg + (max_blk + 1);                     // CHUNK
  int* s_src = s_row + CHUNK;                             // CHUNK
  float* s_val = reinterpret_cast<float*>(s_src + CHUNK); // CHUNK

  const int i = blockIdx.x;
  const int f0 = blockIdx.y * FB;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  for (int x = threadIdx.x; x < BLK * FB; x += THREADS) acc[x] = 0.f;
  const int* seg_i = seg + (long long)i * max_blk;
  const int* cols_i = cols + (long long)i * max_blk;
  for (int x = threadIdx.x; x <= max_blk; x += THREADS) s_seg[x] = seg_i[x];
  __syncthreads();

  const int e_begin = s_seg[0];
  const int e_end = s_seg[max_blk];
  for (int c0 = e_begin; c0 < e_end; c0 += CHUNK) {
    const int n = min(CHUNK, e_end - c0);
    for (int x = threadIdx.x; x < n; x += THREADS) {
      const int e = c0 + x;
      // the edge's slot: the last k in [0, max_blk) with s_seg[k] <= e
      int lo = 0, hi = max_blk - 1;
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (s_seg[mid] <= e) lo = mid; else hi = mid - 1;
      }
      const int off = tile_off[e];
      const long long src = (long long)cols_i[lo] * BLK + (off & (BLK - 1));
      if (src >= n_src || off < 0 || off >= BLK * BLK) __trap();
      s_row[x] = off >> 7;
      s_src[x] = (int)src;
      s_val[x] = val[e];
    }
    __syncthreads();
    for (int b = 0; b < n; b += 32) {
      const int x = b + lane;
      const bool mine = x < n && (s_row[x] % WARPS) == warp;
      unsigned mask = __ballot_sync(0xffffffffu, mine);
      while (mask) {
        int xs[UNROLL];
        float hv[UNROLL][VEC];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          xs[u] = -1;
          if (mask) {
            xs[u] = b + __ffs(mask) - 1;
            mask &= mask - 1;
          }
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          if (xs[u] >= 0) {
            const float* hrow = h + (long long)s_src[xs[u]] * F;
#pragma unroll
            for (int v = 0; v < VEC; ++v) {
              const int f = f0 + v * 32 + lane;
              hv[u][v] = f < F ? __ldg(hrow + f) : 0.f;
            }
          }
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          if (xs[u] >= 0) {
            float* arow = acc + s_row[xs[u]] * FB;
            const float w = s_val[xs[u]];
#pragma unroll
            for (int v = 0; v < VEC; ++v) arow[v * 32 + lane] += w * hv[u][v];
          }
        }
      }
    }
    __syncthreads();
  }

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
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        aggregate_edges_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(n_dstb, (F + FB - 1) / FB);
  aggregate_edges_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      tile_off, val, seg, cols, h, out, max_blk, n_src, F);
  return (int)cudaGetLastError();
}

const char* aggregate_edges_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

}  // extern "C"
