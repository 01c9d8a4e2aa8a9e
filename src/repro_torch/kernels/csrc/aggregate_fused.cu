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
// Design. Only 52 of layer 0's 208 destination blocks hold an edge, and a
// whole 128-row z tile at F = 602 (308 KB) does not fit a block's 227 KB:
//   * the grid is (rank in a cluster, destination block, 128 output
//     columns); kernels/aggregate.py: aggregate_fused_shape picks, from
//     the shapes alone, a slab of S = 160 or 128 z columns (32 where that
//     would busy fewer than half the SMs) and a cluster of C = min(F / S
//     rounded up, 8) thread blocks; rank r takes the slabs r, r + C, ...
//     (one each up to 8 slabs, in an instantiation that holds no partial
//     in registers across the walk). 160 is taken where it needs fewer
//     slabs than 128: at F = 602 a cluster of 4, and an H100 runs 30
//     clusters of 4 of these blocks at once against 22 of 5;
//   * a destination block with no edge and no s writes its rows as act(b)
//     and leaves before any load;
//   * each thread block resolves its block's edges once and walks them
//     once a slab into a 128 x S z tile (fused_walk.cuh, the dw pass's
//     walk), while w[slab, n0 ..] and s land by cp.async, then adds
//     z_slab @ w_slab into a 128 x 128 fp32 partial held in registers, on
//     mma.sync m16n8k8 with the 3xTF32 split (mma_tf32.cuh:
//     split_tf32_fast, each step of 8 z columns summed from zero and
//     joined to the fp32 accumulator by a rounded add), 16 warps as 4 x 4,
//     each owning 32 rows and 32 output columns;
//   * the partials meet in distributed shared memory: after a cluster
//     barrier, rank r sums its share of the rows over every rank's partial
//     in rank order, adds b, applies act and writes those rows. No float
//     atomics: one summation order on every run.

#include <cooperative_groups.h>

#include "activation.cuh"
#include "edge_walk.cuh"
#include "fused_walk.cuh"
#include "mma_tf32.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace fused_walk;
using activation::act_apply;

constexpr int NB = 128;            // output columns per thread block
constexpr int LDW = NB + 8;        // w slab row stride (B rows: 8 mod 32)
constexpr int LDP = NB + 8;        // partial row stride (D rows: 8 mod 32)
constexpr int WM = BLK / 32;       // product: warps along rows (4) ...
constexpr int WN = NB / 32;        // ... and along output columns (4)
static_assert(WM * WN == WARPS, "one 32 x 32 output tile a warp");
constexpr int MAX_CLUSTER = 8;     // the portable cluster size

// a slab of S z columns
template <int S>
struct Fwd {
  static constexpr int LDZ = S + 4;   // z tile row stride (A rows: 4 mod 32)
};

__host__ __device__ inline size_t smem_bytes(int slab) {
  const size_t walk =
      fused_walk::smem_bytes((size_t)BLK * (slab + 4), (size_t)slab * LDW);
  const size_t part = sizeof(float) * BLK * LDP;
  return walk > part ? walk : part;
}

// MULTI: a rank may take more than one slab
template <int S, bool MULTI>
__global__ void __launch_bounds__(THREADS, 1)
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
  using P = Fwd<S>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int C = (int)cluster.num_blocks();
  const int i = blockIdx.y, n0 = blockIdx.z * NB;
  const int n_cols = min(NB, N - n0);
  const int tid = threadIdx.x;
  const long long slot0 = (long long)i * max_blk;
  const long long row0 = (long long)i * BLK;
  const int e_begin = seg[slot0], e_end = seg[slot0 + max_blk];

  if (e_end == e_begin && s == nullptr) {
    // z is zero: the rows are act(b); rank r writes rows r, r + C, ...
    const int rows = (BLK - rank + C - 1) / C;
    for (int x = tid; x < rows * n_cols; x += THREADS) {
      const int r = rank + C * (x / n_cols), n = n0 + x % n_cols;
      out[(row0 + r) * N + n] = act_apply(b != nullptr ? b[n] : 0.f, act);
    }
    return;  // the whole cluster leaves here: its blocks share i
  }

  const Smem sm = carve(smem_raw, BLK * P::LDZ, S * LDW);
  float* ws = sm.op;
  const int v_s = s != nullptr ? vec_width(s, F) : 1;
  const int v_w = vec_width(w, N);
  const int n_slabs = (F + S - 1) / S;
  const bool one_chunk = e_end - e_begin <= CHUNK;
  // product: warp (wm, wn) owns rows 32 wm .. and output columns
  // 32 wn ..; g and t index the mma fragments (mma_tf32.cuh)
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WM, wn = warp / WM;
  const int g = lane >> 2, t = lane & 3;
  const bool warp_cols = n0 + 32 * wn < N;  // any column to form
  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  for (int x = tid; x < WARPS * BLK; x += THREADS) sm.wcnt[x] = 0;

  for (int k = rank; k < n_slabs; k += C) {
    const int f0 = k * S;
    const int kmax = min(S, F - f0);       // z columns of the slab
    // z's base (s, or zeros) and w's rows f0 .. f0+kmax land while the
    // edges resolve; w's rows up to kmax rounded to 8 are zeroed
    if (s != nullptr) {
      stage_any<S>(sm.zt, P::LDZ, s, F, row0, BLK, f0, F, v_s);
    } else {
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int x = tid; x < BLK * S / 4; x += THREADS)
        *reinterpret_cast<float4*>(sm.zt + (x / (S / 4)) * P::LDZ
                                   + (x % (S / 4)) * 4) = zero;
    }
    stage_any<NB>(ws, LDW, w, N, f0, kmax, n0, N, v_w);
    mma_tf32::cp_async_commit();
    for (int x = tid; x < (((kmax + 7) & ~7) - kmax) * NB; x += THREADS)
      ws[(kmax + x / NB) * LDW + x % NB] = 0.f;
    for (int c0 = e_begin; c0 < e_end; c0 += CHUNK) {
      const int n = min(CHUNK, e_end - c0);
      if (!one_chunk || k == rank) {  // one chunk: resolved for every slab
        if (tid < BLK) sm.cur[tid] = 0;  // the last user synced after it
        resolve(tile_off, val, seg + slot0, cols + slot0, c0, n, max_blk,
                n_src, sm);
      }
      if (c0 == e_begin) {
        mma_tf32::cp_async_wait<0>();  // z's base landed
        __syncthreads();
      }
      walk<S, P::LDZ>(h, n, F, f0, sm);
      __syncthreads();
    }
    mma_tf32::cp_async_wait<0>();
    __syncthreads();
    if (warp_cols) {
      // acc += z_slab @ w_slab, 8 z columns a step, 3xTF32: the columns
      // and w rows from kmax up to the next 8 hold zeros
      const float* za = sm.zt + 32 * wm * P::LDZ;
      const float* wb = ws + 32 * wn;
#pragma unroll 1
      for (int k0 = 0; k0 < kmax; k0 += 8) {
        uint32_t a_hi[2][4], a_lo[2][4], b_hi[4][2], b_lo[4][2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          mma_tf32::load_a(za + mt * 16 * P::LDZ + k0, P::LDZ, g, t,
                           a_hi[mt], a_lo[mt]);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_tf32::load_b(wb + k0 * LDW + nt * 8, LDW, g, t, b_hi[nt],
                           b_lo[nt]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            mma_tf32::mma_step(acc[mt][nt], a_hi[mt], a_lo[mt], b_hi[nt],
                               b_lo[nt]);
      }
    }
    __syncthreads();  // z and w are free for the next slab or the partial
    if (!MULTI) break;
  }

  // the partial over z and w's place, then every rank's in rank order
  float* part = reinterpret_cast<float*>(smem_raw);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float* prow = part + (32 * wm + 16 * mt + g + 8 * half) * LDP
                    + 32 * wn + 2 * t;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        *reinterpret_cast<float2*>(prow + 8 * nt) =
            make_float2(acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);
    }
  cluster.sync();
  const int share = (BLK + C - 1) / C;
  const int r_lo = rank * share, r_hi = min(BLK, r_lo + share);
  const int q4 = (n_cols + 3) / 4;
  for (int x = tid; x < (r_hi - r_lo) * q4; x += THREADS) {
    const int r = r_lo + x / q4, c = (x % q4) * 4;
    float4 y = *reinterpret_cast<const float4*>(
        cluster.map_shared_rank(part, 0) + r * LDP + c);
    for (int q = 1; q < C; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(part, q) + r * LDP + c);
      y.x += v.x;
      y.y += v.y;
      y.z += v.z;
      y.w += v.w;
    }
    const float ys[4] = {y.x, y.y, y.z, y.w};
    float* orow = out + (row0 + r) * N + n0 + c;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (c + e < n_cols)
        orow[e] = act_apply(ys[e] + (b != nullptr ? b[n0 + c + e] : 0.f),
                            act);
  }
  cluster.sync();  // no block leaves while another reads its partial
}

template <int S>
cudaLaunchConfig_t config(int cluster, int n_dstb, int N, cudaStream_t st,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, n_dstb, (N + NB - 1) / NB);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem_bytes(S);
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int S>
cudaError_t launch(const int* tile_off, const float* val, const int* seg,
                   const int* cols, const float* h, const float* w,
                   const float* b, const float* s, float* out, int n_dstb,
                   int max_blk, long long n_src, int F, int N, int act,
                   int cluster, cudaStream_t st) {
  const bool multi = (F + S - 1) / S > cluster;
  auto kernel = multi ? aggregate_fused_kernel<S, true>
                      : aggregate_fused_kernel<S, false>;
  cudaError_t err = edge_walk::allow_smem(kernel, smem_bytes(S));
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config<S>(cluster, n_dstb, N, st, &attr);
  err = cudaLaunchKernelEx(&cfg, kernel, tile_off, val, seg, cols, h, w, b,
                           s, out, max_blk, n_src, F, N, act);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int S>
int max_clusters(int cluster) {
  auto kernel = aggregate_fused_kernel<S, false>;
  if (edge_walk::allow_smem(kernel, smem_bytes(S)) != cudaSuccess) return -1;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config<S>(cluster, 1, 1, 0, &attr);
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess)
    return -1;
  return n;
}

}  // namespace

extern "C" {

// The most clusters of `cluster` thread blocks that the card runs at once
// for a slab of `slab` z columns (-1 if the runtime cannot say).
int aggregate_fused_max_clusters(int slab, int cluster) {
  switch (slab) {
    case 160: return max_clusters<160>(cluster);
    case 128: return max_clusters<128>(cluster);
    case 32: return max_clusters<32>(cluster);
    default: return -1;
  }
}

// Dynamic shared memory of one thread block for a slab of `slab` z columns.
long long aggregate_fused_smem_bytes(int slab) {
  return (long long)smem_bytes(slab);
}

// Launches on `stream` with the shape of kernels/aggregate.py:
// aggregate_fused_shape (slab 128 or 32 z columns, cluster 1 .. 8 thread
// blocks); returns the CUDA status right after the launch (0 = launched).
// Does not synchronise and allocates nothing.
int aggregate_fused_launch(const int* tile_off, const float* val,
                           const int* seg, const int* cols, const float* h,
                           const float* w, const float* b, const float* s,
                           float* out, int n_dstb, int max_blk,
                           long long n_src, int F, int N, int act, int slab,
                           int cluster, void* stream) {
  if (cluster < 1 || cluster > MAX_CLUSTER)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (slab) {
    case 160:
      return (int)launch<160>(tile_off, val, seg, cols, h, w, b, s, out,
                              n_dstb, max_blk, n_src, F, N, act, cluster, st);
    case 128:
      return (int)launch<128>(tile_off, val, seg, cols, h, w, b, s, out,
                              n_dstb, max_blk, n_src, F, N, act, cluster, st);
    case 32:
      return (int)launch<32>(tile_off, val, seg, cols, h, w, b, s, out,
                             n_dstb, max_blk, n_src, F, N, act, cluster, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* aggregate_fused_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

}  // extern "C"
