// fused_update.cuh: the block-level piece of the fused backward
// (aggregate_fused_bwd.cu) that still forms z a 64-column slice at a time.
//
// dy_block recomputes, for one destination block i, z_i = A_i @ h [+ s_i]
// one slice of FB = 64 feature columns at a time into a 128 x 64 fp32 tile
// in shared memory (edge_walk.cuh's walk_edges) and consumes each slice
// before the next is formed, so the aggregate never reaches device memory
// and the tile fits whatever F is (a whole 128-row z tile at F = 602 would
// be 308 KB, more than the 227 KB of shared memory a block may have): y =
// sum over slices of z[:, fs] @ w[fs, n0:n0+NB], held in registers, then
// dy = g * act'(y + b) (fused_dy_kernel).
//
// The product is a plain fp32 FMA loop over register tiles (each thread
// owns an 8 x 8 tile and reads its operands from shared memory). w, b and
// s come unpadded: rows of w past F and columns past N are staged as
// zeros, and stores past N are masked. The forward (aggregate_fused.cu)
// and the dw pass walk edges once a slab instead (fused_walk.cuh), and
// fused_bwd_merged by aggregate_edges' row walk (edge_rows.cuh).

#pragma once

#include "activation.cuh"
#include "edge_walk.cuh"

namespace fused {

using namespace activation;
using namespace edge_walk;

constexpr int NB = 128;             // output columns per thread block
constexpr int TX = 16, TY = 16;     // threads of a block as a TY x TX grid
constexpr int TM = BLK / TY;        // dy_block: rows per thread (8)
constexpr int TN = NB / TX;         // columns per thread (8)
static_assert(TX * TY == THREADS, "one register tile per thread");

__host__ __device__ inline size_t update_smem_bytes(int max_blk) {
  return sizeof(float) * ((size_t)BLK * FB + (size_t)FB * NB)
         + staging_bytes(max_blk);
}

// z tile of destination block i, columns f0 .. f0+FB: zt = A_i @ h [+ s].
// st.seg must hold block i's seg slice and zt be zeroed, both visible to
// every thread; zt is complete and visible to every thread on return.
__device__ inline void form_z(const int* __restrict__ tile_off,
                              const float* __restrict__ val,
                              const int* __restrict__ cols,
                              const float* __restrict__ h,
                              const float* __restrict__ s, float* zt, int i,
                              int max_blk, long long n_src, int F, int f0,
                              const Staging& st) {
  walk_edges(tile_off, val, cols + (long long)i * max_blk, h, zt, max_blk,
             n_src, F, f0, st);
  if (s != nullptr) {
    const long long row0 = (long long)i * BLK;
    for (int x = threadIdx.x; x < BLK * FB; x += THREADS) {
      const int f = f0 + x % FB;
      if (f < F) zt[x] += s[(row0 + x / FB) * F + f];
    }
    __syncthreads();
  }
}

// Destination block i, output columns n0 .. n0+NB:
// y = (A_i @ h [+ s_i]) @ w + b; writes out = g * act'(y), the backward's
// dy, (n_dstb*128, N) row-major.
__device__ void dy_block(const int* __restrict__ tile_off,
                         const float* __restrict__ val,
                         const int* __restrict__ seg,
                         const int* __restrict__ cols,
                         const float* __restrict__ h,
                         const float* __restrict__ w,
                         const float* __restrict__ b,
                         const float* __restrict__ s,
                         const float* __restrict__ g,
                         float* __restrict__ out, int i, int n0,
                         int max_blk, long long n_src, int F, int N,
                         int act, unsigned char* smem) {
  float* zt = reinterpret_cast<float*>(smem);   // BLK x FB
  float* ws = zt + BLK * FB;                    // FB x NB
  const Staging st = carve_staging(
      reinterpret_cast<unsigned char*>(ws + FB * NB), max_blk);
  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;

  float acc[TM][TN];
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[m][j] = 0.f;

  load_seg(seg, i, max_blk, st);
  for (int f0 = 0; f0 < F; f0 += FB) {
    zero(zt, BLK * FB);
    for (int x = threadIdx.x; x < FB * NB; x += THREADS) {
      const int f = f0 + x / NB, n = n0 + x % NB;
      ws[x] = (f < F && n < N) ? w[(long long)f * N + n] : 0.f;
    }
    __syncthreads();
    form_z(tile_off, val, cols, h, s, zt, i, max_blk, n_src, F, f0, st);
#pragma unroll 4
    for (int k = 0; k < FB; ++k) {
      float a[TM], bv[TN];
#pragma unroll
      for (int m = 0; m < TM; ++m) a[m] = zt[(ty + TY * m) * FB + k];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = ws[k * NB + tx + TX * j];
#pragma unroll
      for (int m = 0; m < TM; ++m)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[m][j] = fmaf(a[m], bv[j], acc[m][j]);
    }
    __syncthreads();  // every thread is done with zt and ws
  }

  const long long row0 = (long long)i * BLK;
#pragma unroll
  for (int m = 0; m < TM; ++m) {
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + TX * j;
      if (n >= N) continue;
      const float y = acc[m][j] + (b != nullptr ? b[n] : 0.f);
      const long long o = (row0 + ty + TY * m) * N + n;
      out[o] = g[o] * act_grad(y, act);
    }
  }
}

}  // namespace fused
