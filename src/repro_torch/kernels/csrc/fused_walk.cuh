// fused_walk.cuh: the edge walk of the fused kernels that form z = A_i @ h
// [+ s_i] a slab of S z columns at a time in shared memory
// (aggregate_fused.cu's forward, aggregate_fused_bwd.cu's dw pass).
//
// A thread block of THREADS resolves the edges of destination block i once
// per chunk of CHUNK edges (resolve): each slot's thread writes the slot's
// source block into the places of its edges (no edge searches for its
// slot), each edge's (row, source row, weight) goes to shared memory, and a
// counting sort puts the edges in row order, ranking them with
// __match_any_sync rather than atomics, so every run takes one order. The
// walk (walk<S>) gives each warp a run of whole rows with about equal
// edges; a warp streams its edges with 16 / (S / 32) h rows in flight a
// lane, sums each row in registers in edge order and adds it once to the z
// tile, which holds s (or zeros). One resolve serves every slab a block
// walks while its edges fit one chunk.
//
// The caller's second tile (dy for the dw pass, the w slab for the forward)
// sits beside the z tile; stage() fills either by cp.async.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "edge_walk.cuh"
#include "mma_tf32.cuh"

namespace fused_walk {

using edge_walk::BLK;
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = 2048;             // edges resolved at once
constexpr int PER_THREAD = CHUNK / THREADS;
constexpr int SLOTS = 4;                // slots a thread resolves at once

// the walk over a slab of S z columns
template <int S>
struct Walk {
  static constexpr int CPL = S / 32;         // columns per lane
  static constexpr int UNROLL = 16 / CPL;    // h rows in flight
};

// shared memory of the z tile (z_floats), the caller's tile (op_floats)
// and the resolved edges
__host__ __device__ inline size_t smem_bytes(size_t z_floats,
                                             size_t op_floats) {
  return sizeof(float) * (z_floats + op_floats)
         + (sizeof(int) + sizeof(float)) * CHUNK          // src, weight
         + sizeof(int) * (2 * BLK + 1 + WARPS * BLK)      // row counts
         + (sizeof(unsigned short) + 1) * CHUNK;          // order, row
}

struct Smem {
  float* zt;        // z of the slab, BLK rows
  float* op;        // the caller's tile
  int* src;         // CHUNK: an edge's h row
  float* wt;        // CHUNK: its weight
  int* start;       // BLK + 1: each row's first place in `order`
  int* cur;         // BLK: the next free place of each row
  int* wcnt;        // WARPS x BLK: a pass's edges per (warp, row)
  unsigned short* order;   // CHUNK: the chunk's edges by row
  unsigned char* row;      // CHUNK: an edge's destination row
};

__device__ inline Smem carve(unsigned char* p, int z_floats, int op_floats) {
  Smem m;
  m.zt = reinterpret_cast<float*>(p);
  m.op = m.zt + z_floats;
  m.src = reinterpret_cast<int*>(m.op + op_floats);
  m.wt = reinterpret_cast<float*>(m.src + CHUNK);
  m.start = reinterpret_cast<int*>(m.wt + CHUNK);
  m.cur = m.start + BLK + 1;
  m.wcnt = m.cur + BLK;
  m.order = reinterpret_cast<unsigned short*>(m.wcnt + WARPS * BLK);
  m.row = reinterpret_cast<unsigned char*>(m.order + CHUNK);
  return m;
}

// dst[r * ldd + c] = src[(row0 + r) * lds + c0 + c] for the rows r < rows
// and the columns c < WIDTH that lie below `cols` rounded up to 8 (those at
// or past `cols` zero-filled), by cp.async of V floats; the columns past
// that are left as they are (no stored output, and no term of a product,
// reads them)
template <int V, int WIDTH>
__device__ inline void stage(float* dst, int ldd, const float* src,
                             long long lds, long long row0, int rows, int c0,
                             int cols) {
  constexpr int PER_ROW = WIDTH / V;
  const int used = min(WIDTH, (cols - c0 + 7) & ~7);
  for (int x = threadIdx.x; x < rows * PER_ROW; x += THREADS) {
    const int r = x / PER_ROW, c = (x % PER_ROW) * V;
    if (c >= used) continue;
    const int left = cols - (c0 + c);
    const int n = left >= V ? V : (left > 0 ? left : 0);
    mma_tf32::cp_async<4 * V>(dst + r * ldd + c,
                              n > 0 ? src + (row0 + r) * lds + c0 + c : src,
                              4 * n);
  }
}

// the widest copy the row stride and the base allow (4, 2 or 1 floats)
__device__ inline int vec_width(const float* p, long long ld) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if (ld % 4 == 0 && (a & 15) == 0) return 4;
  if (ld % 2 == 0 && (a & 7) == 0) return 2;
  return 1;
}

template <int WIDTH>
__device__ inline void stage_any(float* dst, int ldd, const float* src,
                                 long long lds, long long row0, int rows,
                                 int c0, int cols, int v) {
  if (v == 4) stage<4, WIDTH>(dst, ldd, src, lds, row0, rows, c0, cols);
  else if (v == 2) stage<2, WIDTH>(dst, ldd, src, lds, row0, rows, c0, cols);
  else stage<1, WIDTH>(dst, ldd, src, lds, row0, rows, c0, cols);
}

// Resolves the edges c0 .. c0+n of destination block i (seg_i and cols_i
// its seg and cols rows) into sm.src / sm.wt / sm.row, and puts their
// indices in row order into sm.order, each row's edges in edge order;
// sm.start[r] .. sm.start[r+1] are row r's places. sm.cur and sm.wcnt must
// be zero (resolve leaves wcnt zero). Everything is visible to every
// thread on return. Each slot's thread writes its source block into its
// edges' places, so no edge searches for its slot.
__device__ void resolve(const int* __restrict__ tile_off,
                        const float* __restrict__ val,
                        const int* __restrict__ seg_i,
                        const int* __restrict__ cols_i, int c0, int n,
                        int max_blk, long long n_src, const Smem& sm) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // a thread's edges tid, tid + THREADS, ..., their loads issued first
  int off[PER_THREAD];
  float wt[PER_THREAD];
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    const int x = tid + j * THREADS;
    if (x < n) {
      off[j] = __ldg(tile_off + c0 + x);
      wt[j] = __ldg(val + c0 + x);
    }
  }
  // the slots, SLOTS a thread at a time, their loads issued together
  for (int k0 = 0; k0 < max_blk; k0 += SLOTS * THREADS) {
    int a[SLOTS], b[SLOTS], base[SLOTS];
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) {
      const int k = k0 + tid + j * THREADS;
      a[j] = k < max_blk ? max(__ldg(seg_i + k), c0) : 0;
      b[j] = k < max_blk ? min(__ldg(seg_i + k + 1), c0 + n) : 0;
    }
#pragma unroll
    for (int j = 0; j < SLOTS; ++j)
      base[j] = a[j] < b[j] ? __ldg(cols_i + k0 + tid + j * THREADS) * BLK
                            : 0;
#pragma unroll
    for (int j = 0; j < SLOTS; ++j)
      for (int e = a[j]; e < b[j]; ++e) sm.src[e - c0] = base[j];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    const int x = tid + j * THREADS;
    if (x < n) {
      const long long src = (long long)sm.src[x] + (off[j] & (BLK - 1));
      if (src >= n_src || off[j] < 0 || off[j] >= BLK * BLK) __trap();
      sm.src[x] = (int)src;
      sm.wt[x] = wt[j];
      sm.row[x] = (unsigned char)(off[j] >> 7);
      atomicAdd(sm.cur + (off[j] >> 7), 1);  // a count: the same every run
    }
  }
  __syncthreads();
  if (warp == 0) {  // start = the exclusive scan of the counts; cur = start
    int c[BLK / 32], sum = 0;
#pragma unroll
    for (int j = 0; j < BLK / 32; ++j) {
      c[j] = sm.cur[lane * (BLK / 32) + j];
      sum += c[j];
    }
    int incl = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += y;
    }
    int run = incl - sum;
#pragma unroll
    for (int j = 0; j < BLK / 32; ++j) {
      sm.start[lane * (BLK / 32) + j] = run;
      sm.cur[lane * (BLK / 32) + j] = run;
      run += c[j];
    }
    if (lane == 31) sm.start[BLK] = incl;
  }
  __syncthreads();
  // passes of THREADS edges in edge order: an edge's place is its row's
  // next free place, plus the edges of its row in earlier warps of the
  // pass, plus those in earlier lanes of its warp
  for (int p0 = 0; p0 < n; p0 += THREADS) {
    const int x = p0 + tid;
    const int r = x < n ? sm.row[x] : BLK;
    const unsigned peers = __match_any_sync(0xffffffffu, r);
    const int rank = __popc(peers & ((1u << lane) - 1u));
    if (r < BLK && rank == 0) sm.wcnt[warp * BLK + r] = __popc(peers);
    __syncthreads();
    if (r < BLK) {
      int at = sm.cur[r] + rank;
      for (int w = 0; w < warp; ++w) at += sm.wcnt[w * BLK + r];
      sm.order[at] = (unsigned short)x;
    }
    __syncthreads();
    if (tid < BLK) {
      int add = 0;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        add += sm.wcnt[w * BLK + tid];
        sm.wcnt[w * BLK + tid] = 0;
      }
      sm.cur[tid] += add;
    }
    __syncthreads();
  }
}

// z[r, :] += sum over the resolved edges of row r, in edge order, of
// weight * h[src, f0 ..], z the BLK x S tile sm.zt with row stride LDZ.
// Warp w takes the whole rows whose places start from w/WARPS of the
// chunk's edges on, so the warps get about equal edges and every row is
// summed by one warp. Columns at or past F add zeros.
template <int S, int LDZ>
__device__ void walk(const float* __restrict__ h, int n, int F, int f0,
                     const Smem& sm) {
  using P = Walk<S>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  auto first_row = [&](int target) {  // the first row starting at target+
    int lo = 0, hi = BLK;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (sm.start[mid] >= target) hi = mid; else lo = mid + 1;
    }
    return lo;
  };
  const int r_lo = first_row(warp * n / WARPS);
  const int r_hi = warp == WARPS - 1 ? BLK : first_row((warp + 1) * n / WARPS);
  const int p_end = sm.start[r_hi];
  const float* hcol = h + f0 + lane;
  int cur = -1;
  float acc[P::CPL];
#pragma unroll
  for (int c = 0; c < P::CPL; ++c) acc[c] = 0.f;
  for (int p0 = sm.start[r_lo]; p0 < p_end; p0 += P::UNROLL) {
    int xs[P::UNROLL];
    float hv[P::UNROLL][P::CPL];
#pragma unroll
    for (int u = 0; u < P::UNROLL; ++u) {
      xs[u] = p0 + u < p_end ? sm.order[p0 + u] : -1;
      if (xs[u] >= 0) {
        const float* hr = hcol + (long long)sm.src[xs[u]] * F;
#pragma unroll
        for (int c = 0; c < P::CPL; ++c)
          hv[u][c] = f0 + lane + 32 * c < F ? __ldg(hr + 32 * c) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < P::UNROLL; ++u) {
      if (xs[u] < 0) continue;
      const int r = sm.row[xs[u]];
      if (r != cur) {
        if (cur >= 0) {
#pragma unroll
          for (int c = 0; c < P::CPL; ++c) {
            sm.zt[cur * LDZ + lane + 32 * c] += acc[c];
            acc[c] = 0.f;
          }
        }
        cur = r;
      }
      const float w = sm.wt[xs[u]];
#pragma unroll
      for (int c = 0; c < P::CPL; ++c) acc[c] += w * hv[u][c];
    }
  }
  if (cur >= 0) {
#pragma unroll
    for (int c = 0; c < P::CPL; ++c)
      sm.zt[cur * LDZ + lane + 32 * c] += acc[c];
  }
}

}  // namespace fused_walk
