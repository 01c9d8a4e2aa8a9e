// edge_rows.cuh: aggregate_edges' row walk, shared by aggregate_edges.cu
// (out = A @ h) and aggregate_fused_bwd.cu's fused_bwd_merged (dh = A^T @ dz
// through block(), and the rows of z = A @ h its dw role multiplies).
//
// A thread block of THREADS owns R rows r0 .. r0+R of one destination
// block. resolve() takes the block's edges CHUNK at a time: the thread of
// each slot writes the slot's source block into its edges' places (no
// search per edge), and a stable counting sort puts the edges of the R rows
// into row order, each warp ranking its share with __match_any_sync (no
// atomics). walk<V>() then gives each warp a run of whole rows with about
// equal edges; its lanes hold V columns each (loads of V floats), SPAN
// columns and UNROLL h rows in flight at a time, and each row is summed in
// registers by fma from zero in edge order and stored once (a row whose
// edges span two chunks resumes from the sum it stored). The output is a
// pointer and a row stride, so the rows land in device memory or in a
// shared-memory tile alike. No float atomics: the same bits on every run.
// See aggregate_edges.cu for the inputs and the design's reasons.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "edge_walk.cuh"

namespace edge_rows {

using edge_walk::BLK;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = 2048;              // edges resolved at once
constexpr int STEPS = CHUNK / THREADS;   // 32-edge steps of a warp's share
constexpr int SLOTS = 4;                 // slots a thread resolves at once
constexpr int UNROLL = 16;               // h rows in flight a warp
constexpr int SPAN = 128;                // columns a warp walks at once

struct Smem {
  int base[CHUNK];           // by edge: its slot's source block * BLK
  int src[CHUNK];            // the group's edges in row order: h row,
  float wt[CHUNK];           //   weight
  unsigned char row[CHUNK];  //   and row in the group
  int wcnt[WARPS][BLK];      // a warp's edges of each row; then their offset
  int start[BLK + 1];        // each row's first place in row order
  unsigned char started[BLK];  // the row had edges in an earlier chunk
};

template <int V>
__device__ inline void load_vec(float (&d)[V], const float* p) {
  if constexpr (V == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    d[0] = t.x; d[1] = t.y; d[2] = t.z; d[3] = t.w;
  } else if constexpr (V == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    d[0] = t.x; d[1] = t.y;
  } else {
    d[0] = __ldg(p);
  }
}

// a sum this block stored earlier (a plain load: out is written here)
template <int V>
__device__ inline void reload_vec(float (&d)[V], const float* p) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    d[0] = t.x; d[1] = t.y; d[2] = t.z; d[3] = t.w;
  } else if constexpr (V == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    d[0] = t.x; d[1] = t.y;
  } else {
    d[0] = *p;
  }
}

template <int V>
__device__ inline void store_vec(float* p, const float (&s)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(s[0], s[1], s[2], s[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(s[0], s[1]);
  } else {
    *p = s[0];
  }
}

// p[0 .. n) = +0.0 by threads t, t + nt, ...: float4 stores past the first
// 16-byte boundary
__device__ inline void zero_fill(float* p, long long n, int t, int nt) {
  const long long head = min(
      (long long)(((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15) / 4), n);
  for (long long x = t; x < head; x += nt) p[x] = 0.f;
  float4* q = reinterpret_cast<float4*>(p + head);
  const long long n4 = (n - head) / 4;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (long long x = t; x < n4; x += nt) q[x] = zero;
  for (long long x = head + 4 * n4 + t; x < n; x += nt) p[x] = 0.f;
}

// Resolves the edges c0 .. c0+n of destination block i (seg_i, cols_i its
// rows of seg and cols) and puts those of rows r0 .. r0+R into row order:
// sm.src / sm.wt / sm.row hold them, row r at sm.start[r] .. sm.start[r+1],
// each row's edges in edge order. Warp w ranks the edges of its share
// [w * share, (w+1) * share) of the chunk, 32 at a time; a row's place is
// its start, plus its edges in earlier warps, plus those earlier in the
// warp. Before overwriting sm.start, marks in sm.started the rows the last
// chunk gave edges (sm.start is zero before the first). Everything is
// visible to every thread on return.
__device__ void resolve(const int* __restrict__ tile_off,
                        const float* __restrict__ val,
                        const int* __restrict__ seg_i,
                        const int* __restrict__ cols_i, int c0, int n,
                        int max_blk, long long n_src, int r0, int R,
                        Smem& sm) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int share = (n + 32 * WARPS - 1) / (32 * WARPS) * 32;
  const int x0 = warp * share;
  // the warp's edges, their loads issued first
  int off[STEPS];
  float wv[STEPS];
#pragma unroll
  for (int j = 0; j < STEPS; ++j) {
    const int x = x0 + 32 * j + lane;
    if (32 * j < share && x < n) {
      off[j] = __ldg(tile_off + c0 + x);
      wv[j] = __ldg(val + c0 + x);
    }
  }
  // the slots, SLOTS a thread at a time, their seg and cols loads issued
  // together: each writes its source block into the places of its edges in
  // the chunk
  for (int k0 = 0; k0 < max_blk; k0 += SLOTS * THREADS) {
    int a[SLOTS], b[SLOTS], base[SLOTS];
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) {
      const int k = k0 + tid + j * THREADS;
      const bool in = k < max_blk;
      a[j] = in ? max(__ldg(seg_i + k), c0) : 0;
      b[j] = in ? min(__ldg(seg_i + k + 1), c0 + n) : 0;
      base[j] = in ? __ldg(cols_i + k) * BLK : 0;
    }
#pragma unroll
    for (int j = 0; j < SLOTS; ++j)
      for (int e = a[j]; e < b[j]; ++e) sm.base[e - c0] = base[j];
  }
  // count the warp's edges of each row, keeping each edge's rank among
  // them; the warp's counts were last read before the previous barrier
  for (int r = lane; r < R; r += 32) sm.wcnt[warp][r] = 0;
  __syncwarp();
  int rk[STEPS], lp[STEPS];
#pragma unroll
  for (int j = 0; j < STEPS; ++j) {
    rk[j] = -1;
    if (32 * j >= share) continue;  // the same for the whole warp
    if (x0 + 32 * j + lane < n) {
      if (off[j] < 0 || off[j] >= BLK * BLK) __trap();
      const int r = (off[j] >> 7) - r0;
      if (r >= 0 && r < R) rk[j] = r;
    }
    const unsigned peers = __match_any_sync(0xffffffffu, rk[j]);
    const int rank = __popc(peers & ((1u << lane) - 1u));
    const int before = rk[j] >= 0 ? sm.wcnt[warp][rk[j]] : 0;
    __syncwarp();
    if (rk[j] >= 0 && rank == 0) sm.wcnt[warp][rk[j]] = before + __popc(peers);
    __syncwarp();
    lp[j] = before + rank;
  }
  __syncthreads();
  if (warp == 0) {  // lane l takes rows 4l .. 4l+3
    constexpr int RPL = BLK / 32;
    int tot[RPL], sum = 0;
#pragma unroll
    for (int q = 0; q < RPL; ++q) {
      const int r = lane * RPL + q;
      int t = 0;
      if (r < R) {
        if (sm.start[r + 1] > sm.start[r]) sm.started[r] = 1;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) {
          const int c = sm.wcnt[w][r];
          sm.wcnt[w][r] = t;
          t += c;
        }
      }
      tot[q] = t;
      sum += t;
    }
    int incl = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += y;
    }
    __syncwarp();  // every lane has read sm.start
    int run = incl - sum;
#pragma unroll
    for (int q = 0; q < RPL; ++q) {
      const int r = lane * RPL + q;
      if (r < R) sm.start[r] = run;
      run += tot[q];
    }
    if (lane == 31) sm.start[R] = incl;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < STEPS; ++j) {
    if (rk[j] < 0) continue;
    const int x = x0 + 32 * j + lane;
    const int p = sm.start[rk[j]] + sm.wcnt[warp][rk[j]] + lp[j];
    const long long src = (long long)sm.base[x] + (off[j] & (BLK - 1));
    if (src < 0 || src >= n_src) __trap();
    sm.src[p] = (int)src;
    sm.wt[p] = wv[j];
    sm.row[p] = (unsigned char)rk[j];
  }
  __syncthreads();
}

// out_g[r * ldo, :F] = the sum over the resolved edges of row r, in edge
// order, of weight * h[src, :] (resumed from out_g's row r where the row
// had edges in an earlier chunk), out_g the group's first row and ldo its
// row stride. Warp w takes the whole rows whose places start from
// w/WARPS of the edges on. Lane l holds V columns at f0 + V (32 c + l) for
// c < CPL, V * CPL = 4.
template <int V>
__device__ void walk(const float* __restrict__ h, float* out_g,
                     long long ldo, int F, int R, const Smem& sm) {
  constexpr int CPL = 4 / V;
  static_assert(32 * V * CPL == SPAN, "a warp walks SPAN columns");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m = sm.start[R];
  auto first_row = [&](int target) {  // the first row starting at target+
    int lo = 0, hi = R;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (sm.start[mid] >= target) hi = mid; else lo = mid + 1;
    }
    return lo;
  };
  const int r_lo = first_row(warp * m / WARPS);
  const int r_hi = warp == WARPS - 1 ? R : first_row((warp + 1) * m / WARPS);
  const int p_lo = sm.start[r_lo], p_hi = sm.start[r_hi];
  for (int f0 = 0; f0 < F && p_lo < p_hi; f0 += SPAN) {
    const float* hcol = h + f0 + V * lane;
    float* ocol = out_g + f0 + V * lane;
    int cur = -1;
    float acc[CPL][V];
    auto flush = [&]() {
      float* o = ocol + (long long)cur * ldo;
#pragma unroll
      for (int c = 0; c < CPL; ++c)
        if (f0 + V * (32 * c + lane) < F) store_vec<V>(o + 32 * V * c, acc[c]);
    };
    for (int p0 = p_lo; p0 < p_hi; p0 += UNROLL) {
      float hv[UNROLL][CPL][V];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (p0 + u >= p_hi) break;
        const float* hr = hcol + (long long)sm.src[p0 + u] * F;
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          if (f0 + V * (32 * c + lane) < F) {
            load_vec<V>(hv[u][c], hr + 32 * V * c);
          } else {
#pragma unroll
            for (int v = 0; v < V; ++v) hv[u][c][v] = 0.f;
          }
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (p0 + u >= p_hi) break;
        const int r = sm.row[p0 + u];
        if (r != cur) {
          if (cur >= 0) flush();
          cur = r;
          const bool resume = sm.started[r];
          const float* o = ocol + (long long)r * ldo;
#pragma unroll
          for (int c = 0; c < CPL; ++c) {
            if (resume && f0 + V * (32 * c + lane) < F) {
              reload_vec<V>(acc[c], o + 32 * V * c);
            } else {
#pragma unroll
              for (int v = 0; v < V; ++v) acc[c][v] = 0.f;
            }
          }
        }
        const float w = sm.wt[p0 + u];
#pragma unroll
        for (int c = 0; c < CPL; ++c)
#pragma unroll
          for (int v = 0; v < V; ++v)
            acc[c][v] = __fmaf_rn(w, hv[u][c][v], acc[c][v]);
      }
    }
    flush();
  }
}

// Rows r0 .. r0+R of destination block i of out = A @ h, out_g the first
// of them (row stride F): the whole of one aggregate_edges thread block,
// seg_i and cols_i block i's rows of seg and cols. A block with no edge
// writes zeros and stages nothing; so do the rows no chunk gave an edge.
template <int V>
__device__ void block(const int* __restrict__ tile_off,
                      const float* __restrict__ val,
                      const int* __restrict__ seg_i,
                      const int* __restrict__ cols_i,
                      const float* __restrict__ h, float* out_g,
                      int max_blk, long long n_src, int F, int r0, int R,
                      Smem& sm) {
  const int tid = threadIdx.x;
  const int e_begin = __ldg(seg_i), e_end = __ldg(seg_i + max_blk);
  if (e_begin == e_end) {  // no edge: zeros, nothing staged
    zero_fill(out_g, (long long)R * F, tid, THREADS);
    return;
  }
  if (tid < R) sm.started[tid] = 0;
  if (tid <= R) sm.start[tid] = 0;
  __syncthreads();
  for (int c0 = e_begin; c0 < e_end; c0 += CHUNK) {
    const int n = min(CHUNK, e_end - c0);
    resolve(tile_off, val, seg_i, cols_i, c0, n, max_blk, n_src, r0, R, sm);
    walk<V>(h, out_g, F, F, R, sm);
  }
  __syncthreads();
  // the rows no chunk gave an edge: zeros, a warp a row
  const int warp = tid >> 5, lane = tid & 31;
  for (int r = warp; r < R; r += WARPS)
    if (!sm.started[r] && sm.start[r + 1] == sm.start[r])
      zero_fill(out_g + (long long)r * F, F, lane, 32);
}

}  // namespace edge_rows
