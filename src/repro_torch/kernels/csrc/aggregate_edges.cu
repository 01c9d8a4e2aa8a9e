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
// Design:
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

#include "edge_walk.cuh"

namespace {

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

// out_g[r, :] = the sum over the resolved edges of row r, in edge order,
// of weight * h[src, :] (resumed from out_g[r, :] where the row had edges
// in an earlier chunk), out_g the group's first row. Warp w takes the
// whole rows whose places start from w/WARPS of the edges on. Lane l
// holds V columns at f0 + V (32 c + l) for c < CPL, V * CPL = 4.
template <int V>
__device__ void walk(const float* __restrict__ h, float* out_g, int F, int R,
                     const Smem& sm) {
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
      float* o = ocol + (long long)cur * F;
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
          const float* o = ocol + (long long)r * F;
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
  const int tid = threadIdx.x;
  const long long slot0 = (long long)blockIdx.y * max_blk;
  float* out_g = out + ((long long)blockIdx.y * BLK + r0) * F;
  const int e_begin = __ldg(seg + slot0), e_end = __ldg(seg + slot0 + max_blk);
  if (e_begin == e_end) {  // no edge: zeros, nothing staged
    zero_fill(out_g, (long long)R * F, tid, THREADS);
    return;
  }
  if (tid < R) sm.started[tid] = 0;
  if (tid <= R) sm.start[tid] = 0;
  __syncthreads();
  for (int c0 = e_begin; c0 < e_end; c0 += CHUNK) {
    const int n = min(CHUNK, e_end - c0);
    resolve(tile_off, val, seg + slot0, cols + slot0, c0, n, max_blk, n_src,
            r0, R, sm);
    walk<V>(h, out_g, F, R, sm);
  }
  __syncthreads();
  // the rows no chunk gave an edge: zeros, a warp a row
  const int warp = tid >> 5, lane = tid & 31;
  for (int r = warp; r < R; r += WARPS)
    if (!sm.started[r] && sm.start[r + 1] == sm.start[r])
      zero_fill(out_g + (long long)r * F, F, lane, 32);
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
