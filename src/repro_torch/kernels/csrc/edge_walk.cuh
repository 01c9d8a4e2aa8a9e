// edge_walk.cuh: the pieces the edge-segment kernels share
// (aggregate_edges.cu, aggregate_fused.cu, aggregate_fused_bwd.cu).
//
// A sampled layer's adjacency A arrives as per-tile edge segments over
// 128x128 tiles (kernels/layout.py): tile_off (E,) int32 holds each edge's
// cell row*128 + col inside its tile, val (E,) f32 its weight, seg
// (n_dstb*max_blk + 1,) int32 the CSR offsets over the tile slots (the
// edges of slot t are [seg[t], seg[t+1]); masked edges lie past seg[-1]),
// and cols (n_dstb, max_blk) int32 the source block of each slot. The edges
// of destination block i are the contiguous range
// seg[i*max_blk] .. seg[(i+1)*max_blk].
//
// walk_edges (now serving only fused_update.cuh's dy pass) adds columns
// f0 .. f0+FB of A_i @ h into a 128 x FB fp32 tile in shared memory. The
// block's edges are staged in chunks, each thread resolving one edge's
// tile slot by binary search over the seg slice in shared memory. Warp w owns the rows r with r % WARPS == w and walks the
// staged edges in order, so every row is summed by one warp in segment
// order: no atomics, and the same result on every run. Lanes run over the
// columns, so each h row load is coalesced, and up to UNROLL edges' loads
// are issued before their adds. Columns past F are masked (F is not
// padded), and 64-bit offsets index h (row * F reaches 1.8e8 at layer 0 of
// the paper's batch).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace edge_walk {

constexpr int BLK = 128;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int VEC = 2;            // feature columns per lane
constexpr int FB = 32 * VEC;      // feature columns of one walk
constexpr int CHUNK = 1024;       // edges staged in shared memory per pass
constexpr int UNROLL = 4;         // edges whose loads are in flight together

// shared memory of walk_edges' staging: the seg slice and one chunk
__host__ __device__ inline size_t staging_bytes(int max_blk) {
  return sizeof(int) * ((size_t)max_blk + 1)
         + (sizeof(int) * 2 + sizeof(float)) * CHUNK;
}

struct Staging {
  int* seg;     // max_blk + 1
  int* row;     // CHUNK
  int* src;     // CHUNK
  float* val;   // CHUNK
};

__device__ inline Staging carve_staging(unsigned char* p, int max_blk) {
  Staging s;
  s.seg = reinterpret_cast<int*>(p);
  s.row = s.seg + (max_blk + 1);
  s.src = s.row + CHUNK;
  s.val = reinterpret_cast<float*>(s.src + CHUNK);
  return s;
}

// Copy the seg slice of destination block i into shared memory. The caller
// synchronises before walk_edges reads it.
__device__ inline void load_seg(const int* __restrict__ seg, int i,
                                int max_blk, const Staging& st) {
  const int* seg_i = seg + (long long)i * max_blk;
  for (int x = threadIdx.x; x <= max_blk; x += THREADS) st.seg[x] = seg_i[x];
}

// acc[r * FB + c] += sum over the edges e of block i with destination row r
// of val[e] * h[src(e), f0 + c]. acc must be zeroed and st.seg loaded, and
// both visible to every thread (a __syncthreads() before the call); acc is
// complete and visible to every thread when this returns.
__device__ inline void walk_edges(const int* __restrict__ tile_off,
                                  const float* __restrict__ val,
                                  const int* __restrict__ cols_i,
                                  const float* __restrict__ h, float* acc,
                                  int max_blk, long long n_src, int F, int f0,
                                  const Staging& st) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int e_begin = st.seg[0];
  const int e_end = st.seg[max_blk];
  for (int c0 = e_begin; c0 < e_end; c0 += CHUNK) {
    const int n = min(CHUNK, e_end - c0);
    for (int x = threadIdx.x; x < n; x += THREADS) {
      const int e = c0 + x;
      // the edge's slot: the last k in [0, max_blk) with seg[k] <= e
      int lo = 0, hi = max_blk - 1;
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (st.seg[mid] <= e) lo = mid; else hi = mid - 1;
      }
      const int off = tile_off[e];
      const long long src = (long long)cols_i[lo] * BLK + (off & (BLK - 1));
      if (src >= n_src || off < 0 || off >= BLK * BLK) __trap();
      st.row[x] = off >> 7;
      st.src[x] = (int)src;
      st.val[x] = val[e];
    }
    __syncthreads();
    for (int b = 0; b < n; b += 32) {
      const int x = b + lane;
      const bool mine = x < n && (st.row[x] % WARPS) == warp;
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
            const float* hrow = h + (long long)st.src[xs[u]] * F;
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
            float* arow = acc + st.row[xs[u]] * FB;
            const float w = st.val[xs[u]];
#pragma unroll
            for (int v = 0; v < VEC; ++v) arow[v * 32 + lane] += w * hv[u][v];
          }
        }
      }
    }
    __syncthreads();
  }
}

__device__ inline void zero(float* p, int n) {
  for (int x = threadIdx.x; x < n; x += THREADS) p[x] = 0.f;
}

// Sets a kernel's dynamic shared memory limit when it needs more than the
// default 48 KB; returns the CUDA status.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace edge_walk
