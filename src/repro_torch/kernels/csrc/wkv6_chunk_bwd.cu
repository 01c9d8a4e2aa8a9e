// wkv6_chunk_bwd: the backward of the RWKV-6 (Finch) WKV recurrence in
// chunks of 16 tokens, the time-mix core of RWKV-6's training step.
//
// Replaces no TPU kernel: the reference takes this gradient by JAX autodiff
// of its plain-JAX wkv6_chunked (src/repro/nn/rwkv6.py), whose chunk scan
// is under jax.checkpoint. It is the backward of csrc/wkv6_chunk.cu's
// function (the forward kernel is left as it is):
//     y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
//     S_t = diag(exp(lw_t)) S_{t-1} + k_t v_t^T
// per (batch b, head h), K = V = head size. Given dy (B, S, H, V) and the
// final state's cotangent ds_out (B, H, K, V) or null (zeros), it returns
// dr, dk, dv (B, S, H, K) in r's type, dlw (B, S, H, K) float32, du
// float32 ((H, K) summed over the batch, or (B, H, K)) and ds0 (B, H, K, V)
// float32, the initial state's cotangent. Inside a chunk of L = 16 tokens,
// with c the inclusive cumsum of lw, ce = c - lw, S the state at the
// chunk's start, dS the cotangent of the state at its end, A and the bonus
// b = sum_k r_k u_k k_k as in the forward and G_tj = dy_t . v_j:
//     dv_j  = sum_{t>j} A_tj dy_t + b_j dy_j + (k_j e^(c_L - c_j)) dS
//     dr'_t = e^ce_t (S dy_t) + sum_{j<t} G_tj k_j e^(ce_t - c_j)
//     dk'_j = sum_{t>j} G_tj r_t e^(ce_t - c_j) + e^(c_L - c_j) (dS v_j)
//     dr_t = dr'_t + G_tt u k_t,  dk_j = dk'_j + G_jj u r_j
//     du  += sum_t G_tt r_t k_t
//     dlw_i = sum_{t>i} r_t dr'_t - sum_{j>=i} k_j dk'_j + rowsum(dS * S_end)
//     dS <- e^c_L dS + (r e^ce)^T dy     (the chunk before's dS)
// with S_end = e^c_L S + (k e^(c_L - c))^T v the state at the chunk's end.
// dlw's last term is the gradient of a decay put on the state between two
// chunks, so every sum of dlw stays inside its chunk (no reverse sum over
// the whole sequence, which could cancel). Every exponent is <= 0. A ragged
// last chunk loads zeros past S (lw = 0), which adds nothing.
//
// What bounds it on an H100: at RWKV-6-3B's training shape (1 x 4,096
// tokens, 40 heads of 64, bf16) it must read r, k, v and dy (bf16) and lw
// (fp32) and write dr, dk, dv (bf16) and dlw (fp32): 231 MB, 0.069 ms at
// 3.35 TB/s. Its products (S dy, dS v, k~ dS and the rank-16 updates of the
// state and of its cotangent, 6.7 GFLOP) would take 0.014 ms at the TF32
// rate, its pairwise flops 0.016 ms at 67 TFLOP/s and its exponentials
// 0.026 ms on the SFUs: bound by bytes. But each head's state and
// cotangent are chains along the sequence, and the design below moves
// their values at span boundaries through device memory (2 x 42 MB written
// and read at that shape) and reads the inputs twice (the walks, then the
// span pass).
//
// Design: spans of M = 64 tokens (four chunks) and three kernels, no float
// atomics, so two launches give the same bits; every product is mma.sync
// m16n8k8 TF32 with the 3xTF32 split of mma_tf32.cuh (each step of 8 terms
// summed from zero, joined to the fp32 accumulator by a rounded add),
// except that a bfloat16 input (r, k, v, dy), exact in TF32, has no small
// part and its products with one are left out (they are zero); nothing
// inside is rounded to bf16 or to a single TF32 value:
//   * wkv6_bwd_walk, the serial part: the state walks forward over the
//     spans and records S at each span's start (`states`), the cotangent
//     walks backward from ds_out and records dS at each span's end
//     (`dstates`), the dS left after span 0 going to ds0. A step takes a
//     whole span: S <- e^C S + (k e^D)^T v with D_t the sum of lw after t
//     in the span (C the span's sum), dS <- e^C dS + (r e^E)^T dy with E_t
//     the sum before t; each is summed in its own direction (a thread
//     sums eight tokens of a column in order, and the segments' totals
//     come from the seven neighbouring lanes), so every partial sum lies
//     inside the exponent it builds and no difference of two long cumsums
//     cancels. The decayed columns are split into their TF32 parts once,
//     by the scan, and the rank-64 update is a 16 x K x 64 product per
//     block on the tensor cores, the state rows in mma accumulators. Row i
//     of S needs only column i of k (or r) and lw, so each walk splits into
//     K / 16 blocks of 16 rows (4 warps): 2 B H K / 16 blocks, 320 at the
//     training shape, all resident (36,416 bytes of shared memory in
//     bf16, 104 registers). While a span computes, the next one's v (or
//     dy) rows arrive by cp.async into a second buffer and its columns of
//     k (or r) and lw into registers, stored a column's tokens to a row
//     when its step begins. 64 serial steps at 4,096 tokens (a 16-token
//     walk took 256);
//   * wkv6_bwd_span, one block of 256 threads per (head, span): B H S / 64
//     blocks, 2,560 at the training shape, all independent. It rebuilds the
//     chunk boundaries inside its span on the tensor cores (S forward from
//     the span's start into three shared-memory slots, dS backward from the
//     span's end in mma accumulators) and then takes the span's chunks last
//     to first. Per chunk: column cumsums (two threads a column, one
//     shuffle), G = dy v^T and the bonus; the pairs' terms with each
//     e^(ce_t - c_j) formed once per (pair, channel) and used for A, dr' and
//     dk' alike: four warp pairs take the pairs (rows 0-7 among themselves,
//     8-15 among themselves, rows 8-11 and 12-15 against 0-7; 28-32 pairs
//     each, known at compile time, no search), a lane a channel, A's sums
//     over the channels by a 32-slot transpose-reduce of shuffles, the dr'
//     and dk' parts of two groups joined in a fixed order through shared
//     memory; then the products, each warp on one product over several
//     column tiles so that it forms each A fragment once (S dy and dS v
//     with their k pairs loaded together), dr, dk and dv stored from the
//     product warps; dlw's 16-row suffix sums over four threads a column,
//     its rowsum(dS * S_j) from all warps; the dS update; du's part of the
//     span summed in chunk order. 107,264 bytes of shared memory in bf16
//     (115,456 in fp32) at K = 64 and 128 registers: two blocks an SM;
//   * wkv6_bwd_du: sums du's parts over the spans (and over the batch for
//     a shared u) in a fixed order, eight interleaved sums a column added
//     in order.
//
// What limits it now (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py phase
// 11b, PERF.md row 10): 0.658 ms a launch at the training shape, 9.6x its
// bound; the span pass takes 75% of it, the walks 25%, du 1%. The span
// pass runs two blocks an SM at 128 registers with 76 bytes of spills and
// is bound by the SM's instruction issue more than by latency: its
// fragment loads, 3xTF32 splits, the pairs' loads and shuffles, the row
// copies and seven barriers a chunk are the work to cut next. The walks are
// 64 dependent steps, about half of each the 16 x K x 64 product and a
// quarter each the next span's copies and the scan. Tried and slower: one
// span block an SM without the register cap, the next chunk's rows copied
// while the chunk before finished, and dr and dk stored from the dlw phase;
// without gain: a deeper or shallower unroll of the products or of the
// walk's update, and the span's rows prefetched into L2.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "mma_tf32.cuh"
#include "typed_io.cuh"

namespace {

using namespace mma_tf32;
using namespace typed_io;

constexpr int L = 16;                 // chunk length
constexpr int M = 64;                 // span length: a walk's step, a block
constexpr int CPS = M / L;            // chunks a span
constexpr int R = 16;                 // state rows a walk block carries
constexpr int WALK_THREADS = 128;
constexpr int SPAN_THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;
constexpr float LOG2E = 1.4426950408889634f;

constexpr int cmax(int a, int b) { return a > b ? a : b; }

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// An operand element's TF32 parts: an element exact in TF32 (a bfloat16
// input has 8 significant bits) is its own big part and has no small one;
// any other is split (split_tf32_fast)
template <bool X>
__device__ __forceinline__ void parts(float x, uint32_t& hi, uint32_t& lo) {
  if constexpr (X) {
    hi = __float_as_uint(x);
    lo = 0u;
  } else {
    split_tf32_fast(x, hi, lo);
  }
}

// The fragments of one m16n8k8 step (layouts in mma_tf32.cuh) from element
// functions: a(m, k) = A[m][k] (16 x 8), b(k, n) = B[k][n] (8 x 8); X: the
// elements are exact in TF32
template <bool X = false, typename F>
__device__ __forceinline__ void frag_a(F a, int g, int t, uint32_t* hi,
                                       uint32_t* lo) {
  parts<X>(a(g, t), hi[0], lo[0]);
  parts<X>(a(g + 8, t), hi[1], lo[1]);
  parts<X>(a(g, t + 4), hi[2], lo[2]);
  parts<X>(a(g + 8, t + 4), hi[3], lo[3]);
}
template <bool X = false, typename F>
__device__ __forceinline__ void frag_b(F b, int g, int t, uint32_t* hi,
                                       uint32_t* lo) {
  parts<X>(b(t, g), hi[0], lo[0]);
  parts<X>(b(t + 4, g), hi[1], lo[1]);
}

// two neighbouring elements as floats (8-byte aligned floats, 4-byte
// aligned bfloat16)
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Fragments whose step takes its eight k in pairs: the registers of k
// positions t and t + 4 hold columns 2t and 2t + 1, so each pair is one
// load (a product is the same sum over k in any order, if A's and B's
// fragments take the same one). A from a row-major A (16 rows), B given
// by its transpose bt (8 rows of k); X: exact in TF32
template <bool X, typename T>
__device__ __forceinline__ void frag_a_pk(const T* a, int lda, int g, int t,
                                          uint32_t* hi, uint32_t* lo) {
  const float2 x0 = load2(a + g * lda + 2 * t);
  const float2 x1 = load2(a + (g + 8) * lda + 2 * t);
  parts<X>(x0.x, hi[0], lo[0]);
  parts<X>(x1.x, hi[1], lo[1]);
  parts<X>(x0.y, hi[2], lo[2]);
  parts<X>(x1.y, hi[3], lo[3]);
}
template <bool X, typename T>
__device__ __forceinline__ void frag_bt_pk(const T* bt, int ldb, int g,
                                           int t, uint32_t* hi,
                                           uint32_t* lo) {
  const float2 x = load2(bt + g * ldb + 2 * t);
  parts<X>(x.x, hi[0], lo[0]);
  parts<X>(x.y, hi[1], lo[1]);
}

// the elements of T in 16 bytes, as floats
__device__ __forceinline__ void unpack(const uint4& u, float (&x)[4]) {
  x[0] = __uint_as_float(u.x), x[1] = __uint_as_float(u.y);
  x[2] = __uint_as_float(u.z), x[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&x)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {   // a bfloat16 is a float's top half
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// acc += a b for one step of 8 terms, 3xTF32 as mma_tf32.cuh's mma_step
// (small terms first, summed from zero, one rounded fp32 add), leaving out
// the products of a small part that an exact operand (AX, BX) does not
// have: they are exactly zero
template <bool AX, bool BX>
__device__ __forceinline__ void mma_x(float* acc, const uint32_t* a_hi,
                                      const uint32_t* a_lo,
                                      const uint32_t* b_hi,
                                      const uint32_t* b_lo) {
  float step[4];
  if constexpr (AX && BX) {
    mma_tf32_zero(step, a_hi, b_hi);
  } else if constexpr (AX) {
    mma_tf32_zero(step, a_hi, b_lo);
    mma_tf32::mma_tf32(step, a_hi, b_hi);
  } else if constexpr (BX) {
    mma_tf32_zero(step, a_lo, b_hi);
    mma_tf32::mma_tf32(step, a_hi, b_hi);
  } else {
    mma_tf32_zero(step, a_lo, b_hi);
    mma_tf32::mma_tf32(step, a_hi, b_lo);
    mma_tf32::mma_tf32(step, a_hi, b_hi);
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += step[e];
}

// two consecutive outputs to global memory in one store
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// cp.async of `rows` token rows (K elements of T each, from `tok0` on) of a
// (B, S, H, K) tensor at `head` into dst (row stride ld elements), 16 bytes
// a copy over THREADS threads; zeros past S
template <typename T, int K, int THREADS>
__device__ __forceinline__ void copy_rows(T* dst, int ld, const T* src,
                                          long long head, long long ss,
                                          int tok0, int rows, int S,
                                          int tid) {
  constexpr int PT = K * (int)sizeof(T) / 16, ET = 16 / (int)sizeof(T);
  for (int e = tid; e < rows * PT; e += THREADS) {
    const int row = e / PT, col = (e % PT) * ET;
    const bool in = tok0 + row < S;
    cp_async<16>(dst + row * ld + col,
                 in ? src + head + (long long)(tok0 + row) * ss + col : src,
                 in ? 16 : 0);
  }
}

// One step of a transpose-reduce over a warp: lanes D apart swap halves of
// their 2 H live slots, each keeping the half its bit D names and adding
// its partner's. (Written out per step: a loop over D would leave part[]
// in local memory.)
template <int H, int D, int N>
__device__ __forceinline__ void tr_step(float (&part)[N], int lane) {
  const bool upper = (lane & D) != 0;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = upper ? part[i] : part[i + H];
    const float keep = upper ? part[i + H] : part[i];
    part[i] = keep + __shfl_xor_sync(FULL, send, D);
  }
}

// ---------------------------------------------------------------------------
// Pass 1: the walks
// ---------------------------------------------------------------------------

template <typename T, int K>
struct WalkLayout {
  static constexpr int XP = K + 16 / (int)sizeof(T);  // v or dy rows (T)
  static constexpr int CP = M + 4;    // a column's tokens (lw, k or r)
  static constexpr int DP = M + 8;    // the decayed columns' TF32 parts
  static constexpr int XBYTES = M * XP * (int)sizeof(T);
  static constexpr int BYTES = 2 * XBYTES + 4 * (2 * R * CP + 2 * R * DP + R);
};

// Block (walk, head hb, row block rb): rows rb R .. rb R + 15 of head hb's
// state (walk 0, forward) or cotangent (walk 1, backward), a span a step.
// `a` is k or r, `x` is v or dy; each step first records the block's rows,
// then
//   state walk:      S  <- e^C S  + (k e^D)^T v,   D_t = sum_{s>t} lw_s
//   cotangent walk:  dS <- e^C dS + (r e^E)^T dy,  E_t = sum_{s<t} lw_s
template <typename T, int K>
__global__ void __launch_bounds__(WALK_THREADS, 3)
wkv6_bwd_walk(const T* __restrict__ r, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dy,
              const float* __restrict__ lw, const float* __restrict__ s_in,
              const float* __restrict__ ds_in, float* __restrict__ states,
              float* __restrict__ dstates, float* __restrict__ ds0, int B,
              int S, int H, int nsp) {
  using Lay = WalkLayout<T, K>;
  constexpr int XP = Lay::XP, CP = Lay::CP, DP = Lay::DP;
  constexpr bool XT = sizeof(T) == 2;        // bf16 rows: exact in TF32
  constexpr int NT = K / 8;                  // 8-column tiles of the rows
  constexpr int WT = NT >= 4 ? NT / 4 : 1;   // tiles a warp
  constexpr int RB = K / R;                  // row blocks a walk
  constexpr int EA = 16 / (int)sizeof(T);    // a's columns a 16-byte piece
  constexpr int NA = M * R / EA / WALK_THREADS;   // a's pieces a thread
  constexpr int NL = M * R / 4 / WALK_THREADS;    // lw's pieces a thread
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);                           // [2][M][XP]
  float* lc = reinterpret_cast<float*>(smem + 2 * Lay::XBYTES);  // [R][CP]
  float* ac = lc + R * CP;                                       // [R][CP]
  uint32_t* adh = reinterpret_cast<uint32_t*>(ac + R * CP);      // [R][DP]
  uint32_t* adl = adh + R * DP;   // the decayed k or r, transposed, split
  float* wls = reinterpret_cast<float*>(adl + R * DP);           // [R] e^C

  const int heads = B * H;
  const int rb = blockIdx.x % RB, wb = blockIdx.x / RB;
  const bool cot = wb >= heads;
  const int hb = cot ? wb - heads : wb;
  const int h = hb % H, b = hb / H;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int i0 = rb * R;
  const long long ss = (long long)H * K;    // token stride
  const long long head = (long long)b * S * ss + (long long)h * K;
  const long long mat = (long long)hb * K * K;
  const T* ag = cot ? r : k;
  const T* xg = cot ? dy : v;
  const float* init = cot ? ds_in : s_in;
  float* rec = (cot ? dstates : states) + (long long)hb * nsp * K * K;

  // span n's block columns of a and lw, 16 bytes a piece, into registers a
  // step ahead (zeros past S); then into lc and ac, a column's tokens in a
  // row, a as floats
  uint4 pa[NA];
  float4 pl[NL];
  auto fetch_cols = [&](int n) {
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const int e = tid + i * WALK_THREADS, t = e / (R / EA);
      const int tok = n * M + t;
      pa[i] = tok < S ? *reinterpret_cast<const uint4*>(
                            ag + head + (long long)tok * ss + i0
                            + (e % (R / EA)) * EA)
                      : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      const int e = tid + i * WALK_THREADS, t = e / (R / 4);
      const int tok = n * M + t;
      pl[i] = tok < S ? *reinterpret_cast<const float4*>(
                            lw + head + (long long)tok * ss + i0
                            + (e % (R / 4)) * 4)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto stage_cols = [&]() {
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const int e = tid + i * WALK_THREADS, t = e / (R / EA);
      const int c0 = (e % (R / EA)) * EA;
      float x[EA];
      unpack(pa[i], x);
#pragma unroll
      for (int c = 0; c < EA; ++c) ac[(c0 + c) * CP + t] = x[c];
    }
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      const int e = tid + i * WALK_THREADS, t = e / (R / 4);
      const int c0 = (e % (R / 4)) * 4;
      lc[c0 * CP + t] = pl[i].x;
      lc[(c0 + 1) * CP + t] = pl[i].y;
      lc[(c0 + 2) * CP + t] = pl[i].z;
      lc[(c0 + 3) * CP + t] = pl[i].w;
    }
  };

  // the block's rows of the matrix: warp `warp`'s tiles, in D layout
  float m[WT][4];
#pragma unroll
  for (int q = 0; q < WT; ++q) {
    const int nn = warp * WT + q;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = i0 + g + 8 * (e / 2), col = nn * 8 + 2 * t4 + e % 2;
      m[q][e] = init != nullptr && nn < NT
                    ? init[mat + (long long)row * K + col] : 0.f;
    }
  }

  // the scan's share: column ci of the block, tokens 8 sg .. 8 sg + 7 of a
  // span (the eight segments of a column are eight neighbouring lanes)
  const int ci = tid / 8, sg = tid % 8;
  const int first = cot ? nsp - 1 : 0;
  copy_rows<T, K, WALK_THREADS>(xs, XP, xg, head, ss, first * M, M, S, tid);
  cp_async_commit();
  fetch_cols(first);

  for (int it = 0; it < nsp; ++it) {
    const int n = cot ? nsp - 1 - it : it, buf = it & 1;
    stage_cols();
    if (it + 1 < nsp) {   // the next span, in flight meanwhile
      const int nx = cot ? n - 1 : n + 1;
      copy_rows<T, K, WALK_THREADS>(xs + (buf ^ 1) * M * XP, XP, xg, head,
                                    ss, nx * M, M, S, tid);
      fetch_cols(nx);
    }
    cp_async_commit();
    // record the rows as they stand at the span's start (state) or end
    // (cotangent)
#pragma unroll
    for (int q = 0; q < WT; ++q) {
      const int nn = warp * WT + q;
      if (nn >= NT) break;
      float* p = rec + (long long)n * K * K + (long long)(i0 + g) * K + nn * 8
                 + 2 * t4;
      *reinterpret_cast<float2*>(p) = make_float2(m[q][0], m[q][1]);
      *reinterpret_cast<float2*>(p + 8 * K) = make_float2(m[q][2], m[q][3]);
    }
    cp_async_wait<1>();   // this thread's copies of span n
    __syncthreads();

    // column ci's exponents (log2 units), each sum in its own direction:
    // the segment's own tokens in order, then the segments before (or
    // after) from the neighbouring lanes
    {
      float x[8], av[8];
      const float* lcol = lc + ci * CP + 8 * sg;
      const float* acol = ac + ci * CP + 8 * sg;
      const float4 l0 = *reinterpret_cast<const float4*>(lcol);
      const float4 l1 = *reinterpret_cast<const float4*>(lcol + 4);
      const float4 a0 = *reinterpret_cast<const float4*>(acol);
      const float4 a1 = *reinterpret_cast<const float4*>(acol + 4);
      x[0] = l0.x, x[1] = l0.y, x[2] = l0.z, x[3] = l0.w;
      x[4] = l1.x, x[5] = l1.y, x[6] = l1.z, x[7] = l1.w;
      av[0] = a0.x, av[1] = a0.y, av[2] = a0.z, av[3] = a0.w;
      av[4] = a1.x, av[5] = a1.y, av[6] = a1.z, av[7] = a1.w;
      float tot = 0.f, inc, off, all;
      if (cot) {   // E: the tokens before in the segment, then the segments
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float le = x[e] * LOG2E;
          x[e] = tot;
          tot += le;
        }
        inc = tot;
#pragma unroll
        for (int d = 1; d < 8; d *= 2) {
          const float y = __shfl_up_sync(FULL, inc, d, 8);
          if (sg >= d) inc += y;
        }
        off = __shfl_up_sync(FULL, inc, 1, 8);
        if (sg == 0) off = 0.f;
        all = __shfl_sync(FULL, inc, 7, 8);
      } else {     // D: the tokens after in the segment, then the segments
#pragma unroll
        for (int e = 7; e >= 0; --e) {
          const float le = x[e] * LOG2E;
          x[e] = tot;
          tot += le;
        }
        inc = tot;
#pragma unroll
        for (int d = 1; d < 8; d *= 2) {
          const float y = __shfl_down_sync(FULL, inc, d, 8);
          if (sg + d < 8) inc += y;
        }
        off = __shfl_down_sync(FULL, inc, 1, 8);
        if (sg == 7) off = 0.f;
        all = __shfl_sync(FULL, inc, 0, 8);
      }
      if (sg == 0) wls[ci] = ex2(all);
      uint32_t hi[8], lo[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        split_tf32_fast(av[e] * ex2(off + x[e]), hi[e], lo[e]);
      uint4* ph = reinterpret_cast<uint4*>(adh + ci * DP + 8 * sg);
      uint4* pw = reinterpret_cast<uint4*>(adl + ci * DP + 8 * sg);
      ph[0] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      ph[1] = make_uint4(hi[4], hi[5], hi[6], hi[7]);
      pw[0] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      pw[1] = make_uint4(lo[4], lo[5], lo[6], lo[7]);
    }
    __syncthreads();

    const float w0 = wls[g], w1 = wls[g + 8];
    const T* xb = xs + buf * M * XP;
#pragma unroll
    for (int q = 0; q < WT; ++q) {
      m[q][0] *= w0, m[q][1] *= w0, m[q][2] *= w1, m[q][3] *= w1;
    }
#pragma unroll 4
    for (int ks = 0; ks < M / 8; ++ks) {   // tokens in pairs (frag_a_pk)
      uint32_t ah[4], al[4];
      const int r0 = g * DP + ks * 8 + 2 * t4;
      const uint2 h0 = *reinterpret_cast<const uint2*>(adh + r0);
      const uint2 h1 = *reinterpret_cast<const uint2*>(adh + r0 + 8 * DP);
      const uint2 l0 = *reinterpret_cast<const uint2*>(adl + r0);
      const uint2 l1 = *reinterpret_cast<const uint2*>(adl + r0 + 8 * DP);
      ah[0] = h0.x, ah[1] = h1.x, ah[2] = h0.y, ah[3] = h1.y;
      al[0] = l0.x, al[1] = l1.x, al[2] = l0.y, al[3] = l1.y;
#pragma unroll
      for (int q = 0; q < WT; ++q) {
        const int nn = warp * WT + q;
        if (nn >= NT) break;
        uint32_t bh[2], bl[2];
        const T* xr = xb + (ks * 8 + 2 * t4) * XP + nn * 8 + g;
        parts<XT>(load(xr), bh[0], bl[0]);
        parts<XT>(load(xr + XP), bh[1], bl[1]);
        mma_x<false, XT>(m[q], ah, al, bh, bl);
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();   // no copy outlives the block
  if (cot && ds0 != nullptr) {
#pragma unroll
    for (int q = 0; q < WT; ++q) {
      const int nn = warp * WT + q;
      if (nn >= NT) break;
      float* p = ds0 + mat + (long long)(i0 + g) * K + nn * 8 + 2 * t4;
      *reinterpret_cast<float2*>(p) = make_float2(m[q][0], m[q][1]);
      *reinterpret_cast<float2*>(p + 8 * K) = make_float2(m[q][2], m[q][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// Pass 2: one block per (head, span)
// ---------------------------------------------------------------------------

// shared memory of a pass-2 block: float offsets, then the raw rows in T
template <typename T, int K>
struct SpanLayout {
  static constexpr int KS = K + 8;    // (K, K) matrix rows
  static constexpr int KT = K + 16 / (int)sizeof(T);   // r, k, v, dy rows
  static constexpr int KC = K + 8;    // the chunk's float rows
  static constexpr int GA = L + 8;    // A's rows
  static constexpr int TILES = (K / 16) * (K / 8);
  static constexpr int TPW = TILES >= 8 ? TILES / 8 : 1;   // tiles a warp
  static constexpr int NP = (K / 8) / TPW;   // warps across a matrix row
  static constexpr int SST = 0;              // 3 x [K][KS] S_j, slot j % 3
  static constexpr int DSM = SST + 3 * K * KS;     // [K][KS] dS (first the
                                                   // pairs' partial sums)
  static constexpr int CC = DSM + cmax(K * KS, 3 * 8 * K);  // [L][KC] c, then
                                                            // e^(c_L - c)
  static constexpr int CE = CC + L * KC;     // [L][KC] ce, then e^ce
  static constexpr int DRP = CE + L * KC;    // [L][KC] dr' pairs, then r dr'
  static constexpr int DKP = DRP + L * KC;   // [L][KC] dk' pairs, then k dk'
  static constexpr int GM = DKP + L * KC;    // [L][L] G
  static constexpr int AP = GM + L * L;      // [2][L][GA] A, by halves of K
  static constexpr int US = AP + 2 * L * GA;  // [K] u
  static constexpr int WL = US + K;          // [K] e^c_L
  static constexpr int CL = WL + K;          // [K] c_L
  static constexpr int QSC = CL + K;         // [K] sum_t k e^(c_L - c) (dS v)
  static constexpr int DU = QSC + K;         // [K] du's part of the span
  static constexpr int RS = DU + K;          // [NP][K] rowsum(dS * S) parts
  static constexpr int FLOATS = RS + NP * K;
  static constexpr int ROWS = 4 * FLOATS;    // bytes to the raw rows
  static constexpr int RAW = L * KT * (int)sizeof(T);
  static constexpr int BYTES = ROWS + 4 * RAW;   // r, k, v, dy
};

// The pairs (t, j), t in [TR, TR + NR), j in [TC, TC + NC) (j < t when TRI)
// of a chunk for channel q (lane q % 32 of its warp): each e^(ce_t - c_j)
// is formed once and used for A's part (summed over the warp's 32 channels
// by a transpose-reduce into a_half[t][j]), dr'_t and dk'_j (written to
// drp_dst rows t - TR and dkp_dst rows j - TC, column q).
template <typename T, int K, int TR, int NR, int TC, int NC, bool TRI>
__device__ __forceinline__ void chunk_pairs(
    const T* rr, const T* kr, const float* cc, const float* ce,
    const float* Gm, int q, bool active, int lane, float* a_half,
    float* drp_dst, int drp_ld, float* dkp_dst, int dkp_ld) {
  using Lay = SpanLayout<T, K>;
  constexpr int KT = Lay::KT, KC = Lay::KC, GA = Lay::GA;
  float rt[NR], et[NR], kj[NC], cj[NC], drp[NR], dkp[NC], part[32];
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    rt[i] = active ? load(rr + (TR + i) * KT + q) : 0.f;
    et[i] = active ? ce[(TR + i) * KC + q] : 0.f;
    drp[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    kj[i] = active ? load(kr + (TC + i) * KT + q) : 0.f;
    cj[i] = active ? cc[(TC + i) * KC + q] : 0.f;
    dkp[i] = 0.f;
  }
#pragma unroll
  for (int p = 0; p < 32; ++p) part[p] = 0.f;
  {
    int p = 0;
#pragma unroll
    for (int i = 0; i < NR; ++i)
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        if (TRI && TC + j >= TR + i) continue;
        const float e = ex2(et[i] - cj[j]);
        const float gtj = Gm[(TR + i) * L + TC + j];
        part[p++] = rt[i] * kj[j] * e;
        drp[i] = fmaf(gtj * kj[j], e, drp[i]);
        dkp[j] = fmaf(gtj * rt[i], e, dkp[j]);
      }
  }
  tr_step<16, 16>(part, lane);
  tr_step<8, 8>(part, lane);
  tr_step<4, 4>(part, lane);
  tr_step<2, 2>(part, lane);
  tr_step<1, 1>(part, lane);
  {   // lane l now holds pair l's sum
    int p = 0, tl = -1, jl = 0;
#pragma unroll
    for (int i = 0; i < NR; ++i)
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        if (TRI && TC + j >= TR + i) continue;
        if (p == lane) tl = TR + i, jl = TC + j;
        ++p;
      }
    if (tl >= 0) a_half[tl * GA + jl] = part[0];
  }
  if (active) {
#pragma unroll
    for (int i = 0; i < NR; ++i) drp_dst[i * drp_ld + q] = drp[i];
#pragma unroll
    for (int j = 0; j < NC; ++j) dkp_dst[j * dkp_ld + q] = dkp[j];
  }
}

// Span n of head hb: S at its start from `states`, dS at its end from
// `dstates`; writes dr, dk, dv, dlw of its tokens and du's part of the span.
template <typename T, int K>
__global__ void __launch_bounds__(SPAN_THREADS, 2)
wkv6_bwd_span(const T* __restrict__ r, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dy,
              const float* __restrict__ lw, const T* __restrict__ u,
              const float* __restrict__ states,
              const float* __restrict__ dstates, T* __restrict__ dr,
              T* __restrict__ dk, T* __restrict__ dv,
              float* __restrict__ dlw, float* __restrict__ du_part, int S,
              int H, int nsp, long long u_sb) {
  using Lay = SpanLayout<T, K>;
  constexpr int KS = Lay::KS, KT = Lay::KT, KC = Lay::KC, GA = Lay::GA;
  constexpr int NT = K / 8, TILES = Lay::TILES, TPW = Lay::TPW;
  constexpr bool XT = sizeof(T) == 2;   // bf16 rows: exact in TF32
  extern __shared__ __align__(16) float sm[];
  float* Sst = sm + Lay::SST;
  float* dSm = sm + Lay::DSM;
  float* cc = sm + Lay::CC;
  float* ce = sm + Lay::CE;
  float* drp = sm + Lay::DRP;
  float* dkp = sm + Lay::DKP;
  float* Gm = sm + Lay::GM;
  float* Ap = sm + Lay::AP;
  float* us = sm + Lay::US;
  float* wl = sm + Lay::WL;
  float* cl = sm + Lay::CL;
  float* qsc = sm + Lay::QSC;
  float* dua = sm + Lay::DU;
  float* rs = sm + Lay::RS;
  T* rr = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(sm)
                               + Lay::ROWS);
  T* kr = rr + L * KT;
  T* vr = kr + L * KT;
  T* yr = vr + L * KT;

  const int n = blockIdx.x % nsp, hb = blockIdx.x / nsp;
  const int h = hb % H, b = hb / H;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4;
  const long long ss = (long long)H * K;
  const long long head = (long long)b * S * ss + (long long)h * K;
  const int tok0 = n * M;
  const int nch = min(CPS, (S - tok0 + L - 1) / L);   // chunks with a token
  const long long rec = ((long long)hb * nsp + n) * K * K;

  // this warp's tiles of a (K, K) matrix, all in one row of tiles (D
  // layout): tile warp * TPW + q
  const bool holds = warp * TPW < TILES;
  const int mrow = (warp * TPW / NT) * 16;   // the tiles' first row
  const int ncol0 = (warp * TPW % NT) * 8;   // and first column
  float acc[TPW][4];   // S going up the span, then dS coming down
  auto load_mat = [&](const float* src) {
#pragma unroll
    for (int q = 0; q < TPW; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[q][e] = holds ? src[rec + (long long)(mrow + g + 8 * (e / 2)) * K
                                + ncol0 + q * 8 + 2 * t4 + e % 2]
                          : 0.f;
  };
  auto copy_s0 = [&]() {   // S at the span's start into slot 0
    for (int e = tid; e < K * K / 4; e += SPAN_THREADS) {
      const int row = e / (K / 4), col = (e % (K / 4)) * 4;
      cp_async<16>(Sst + row * KS + col, states + rec + row * K + col, 16);
    }
  };
  // acc <- e^c_L acc + a^T x over the chunk, a(t, i) the decayed k or r
  // element (t, row i), x the v or dy rows
  auto update = [&](auto a, const T* x) {
    const float w0 = wl[mrow + g], w1 = wl[mrow + g + 8];
#pragma unroll
    for (int q = 0; q < TPW; ++q)
      acc[q][0] *= w0, acc[q][1] *= w0, acc[q][2] *= w1, acc[q][3] *= w1;
#pragma unroll
    for (int ks = 0; ks < L / 8; ++ks) {
      uint32_t ah[4], al[4];
      frag_a([&](int mm, int kk) { return a(ks * 8 + kk, mrow + mm); }, g,
             t4, ah, al);
#pragma unroll
      for (int q = 0; q < TPW; ++q) {
        uint32_t bh[2], bl[2];
        frag_b<XT>([&](int kk, int c) {
          return load(x + (ks * 8 + kk) * KT + ncol0 + q * 8 + c);
        }, g, t4, bh, bl);
        mma_x<false, XT>(acc[q], ah, al, bh, bl);
      }
    }
  };
  auto store_mat = [&](float* dst) {
#pragma unroll
    for (int q = 0; q < TPW; ++q) {
      float* p = dst + (mrow + g) * KS + ncol0 + q * 8 + 2 * t4;
      *reinterpret_cast<float2*>(p) = make_float2(acc[q][0], acc[q][1]);
      *reinterpret_cast<float2*>(p + 8 * KS) =
          make_float2(acc[q][2], acc[q][3]);
    }
  };
  // chunk j's rows by cp.async: k, v and lw (into c's place), and with
  // `all` r and dy
  auto load_chunk = [&](int j, bool all) {
    const int t0 = tok0 + j * L;
    if (all) {
      copy_rows<T, K, SPAN_THREADS>(rr, KT, r, head, ss, t0, L, S, tid);
      copy_rows<T, K, SPAN_THREADS>(yr, KT, dy, head, ss, t0, L, S, tid);
    }
    copy_rows<T, K, SPAN_THREADS>(kr, KT, k, head, ss, t0, L, S, tid);
    copy_rows<T, K, SPAN_THREADS>(vr, KT, v, head, ss, t0, L, S, tid);
    copy_rows<float, K, SPAN_THREADS>(cc, KC, lw, head, ss, t0, L, S, tid);
  };
  // the chunk's cumsums of the lw in cc, column q, two threads of
  // neighbouring lanes a column (rows 0-7, 8-15), log2 units: c in cc and
  // ce in ce (`both`), or e^(c_L - c) in cc; c_L and e^c_L
  auto scan = [&](bool both) {
    if (tid < 2 * K) {
      const int q = tid / 2, s = tid % 2;
      float x[8], ex[8], run = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        ex[i] = run;
        run += cc[(8 * s + i) * KC + q] * LOG2E;
        x[i] = run;
      }
      const float before = __shfl_up_sync(FULL, run, 1, 2);
      const float off = s == 1 ? before : 0.f;
      const float c_l = __shfl_sync(FULL, off + run, 1, 2);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float* pc = cc + (8 * s + i) * KC + q;
        if (both) {
          *pc = off + x[i];
          ce[(8 * s + i) * KC + q] = off + ex[i];
        } else {
          *pc = ex2(c_l - (off + x[i]));
        }
      }
      if (s == 1) cl[q] = c_l, wl[q] = ex2(c_l);
    }
  };

  for (int e = tid; e < K; e += SPAN_THREADS) {
    us[e] = load(u + b * u_sb + h * K + e);
    dua[e] = 0.f;
  }
  for (int e = tid; e < 2 * L * GA; e += SPAN_THREADS) Ap[e] = 0.f;   // the
                                         // upper triangle stays zero

  // ---- the chunk boundaries going up: S_1 .. S_{nch-1} into their slots
  load_mat(states);
  for (int j = 0; j + 1 < nch; ++j) {
    load_chunk(j, false);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    scan(false);
    __syncthreads();
    if (holds) {
      update([&](int tt, int i) { return load(kr + tt * KT + i)
                                         * cc[tt * KC + i]; }, vr);
      store_mat(Sst + ((j + 1) % 3) * K * KS);
    }
    __syncthreads();
  }

  // ---- the chunks, last to first, dS coming down from the span's end
  load_mat(dstates);
  for (int j = nch - 1; j >= 0; --j) {
    const float* Sj = Sst + (j % 3) * K * KS;
    load_chunk(j, true);
    if (j == 0) copy_s0();   // into slot 0: S_3's, done with, or free
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    // cumsums (warps 0-3), G = dy v^T (warps 4-5), the bonus (warps 6-7)
    if (warp < 4) {
      scan(true);
    } else if (warp < 6) {
      const int nn = warp - 4;
      float ga[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int ks = 0; ks < K / 8; ++ks) {
        uint32_t ah[4], al[4], bh[2], bl[2];
        frag_a_pk<XT>(yr + ks * 8, KT, g, t4, ah, al);
        frag_bt_pk<XT>(vr + nn * 8 * KT + ks * 8, KT, g, t4, bh, bl);
        mma_x<XT, XT>(ga, ah, al, bh, bl);
      }
      *reinterpret_cast<float2*>(Gm + g * L + nn * 8 + 2 * t4) =
          make_float2(ga[0], ga[1]);
      *reinterpret_cast<float2*>(Gm + (g + 8) * L + nn * 8 + 2 * t4) =
          make_float2(ga[2], ga[3]);
    } else {
      const int half = warp - 6, q = 32 * half + lane;
      const bool active = q < K;
      const float uq = active ? us[q] : 0.f;
      float part[16];
#pragma unroll
      for (int t = 0; t < L; ++t)
        part[t] = active ? load(rr + t * KT + q) * uq * load(kr + t * KT + q)
                         : 0.f;
      tr_step<8, 16>(part, lane);
      tr_step<4, 8>(part, lane);
      tr_step<2, 4>(part, lane);
      tr_step<1, 2>(part, lane);
      part[0] += __shfl_xor_sync(FULL, part[0], 1);
      if ((lane & 1) == 0) {   // lane 2t: row t's bonus over the half
        const int t = lane >> 1;
        Ap[half * L * GA + t * GA + t] = part[0];
      }
    }
    __syncthreads();

    // the pairs: warp pair w / 2 takes one of four groups, lane q % 32
    {
      const int half = warp & 1, q = 32 * half + lane;
      const bool active = q < K;
      float* a_half = Ap + half * L * GA;
      float* x0 = dSm;              // dr' rows 8-15 of rows 8-15's pairs
      float* x1 = dSm + 8 * K;      // dk' columns 0-7 of rows 8-11's
      float* x2 = dSm + 16 * K;     // and of rows 12-15's
      switch (warp >> 1) {
        case 0:
          chunk_pairs<T, K, 0, 8, 0, 8, true>(rr, kr, cc, ce, Gm, q, active,
                                              lane, a_half, drp, KC, dkp, KC);
          break;
        case 1:
          chunk_pairs<T, K, 8, 8, 8, 8, true>(rr, kr, cc, ce, Gm, q, active,
                                              lane, a_half, x0, K,
                                              dkp + 8 * KC, KC);
          break;
        case 2:
          chunk_pairs<T, K, 8, 4, 0, 8, false>(rr, kr, cc, ce, Gm, q, active,
                                               lane, a_half, drp + 8 * KC,
                                               KC, x1, K);
          break;
        default:
          chunk_pairs<T, K, 12, 4, 0, 8, false>(rr, kr, cc, ce, Gm, q,
                                                active, lane, a_half,
                                                drp + 12 * KC, KC, x2, K);
      }
    }
    __syncthreads();

    // the groups' parts joined in a fixed order; the decays as factors
    for (int e = tid; e < L * K; e += SPAN_THREADS) {
      const int t = e / K, q = e % K;
      if (t >= 8)
        drp[t * KC + q] += dSm[(t - 8) * K + q];
      else
        dkp[t * KC + q] = (dkp[t * KC + q] + dSm[8 * K + t * K + q])
                          + dSm[16 * K + t * K + q];
      cc[t * KC + q] = ex2(cl[q] - cc[t * KC + q]);   // e^(c_L - c)
      ce[t * KC + q] = ex2(ce[t * KC + q]);           // e^ce
    }
    __syncthreads();
    if (holds) store_mat(dSm);
    __syncthreads();

    // the products, each warp on one of them over several column tiles,
    // so that it forms each A fragment once: warps 0-1 S dy (dr out, r dr'
    // in dr''s place, du's column sums), 2-3 dS v (dk out, k dk' in dk''s
    // place, the column sums of k~ (dS v)), 4-7 k~ dS and A^T dy (dv out);
    // then every warp holding dS its part of rowsum(dS * S_j)
    {
      constexpr int NH = NT / 2;              // tiles an S dy or dS v warp
      constexpr int NQ = NT >= 4 ? NT / 4 : 1;   // a k~ dS warp's
      if (warp < 4) {
        const bool on_s = warp < 2;
        const int n0 = (warp & 1) * NH;
        const T* arow = on_s ? yr : vr;
        const float* bm = on_s ? Sj : dSm;
        float pr[NH][4] = {};
#pragma unroll 2
        for (int ks = 0; ks < K / 8; ++ks) {
          uint32_t ah[4], al[4];
          frag_a_pk<XT>(arow + ks * 8, KT, g, t4, ah, al);
#pragma unroll
          for (int q = 0; q < NH; ++q) {
            uint32_t bh[2], bl[2];
            frag_bt_pk<false>(bm + (n0 + q) * 8 * KS + ks * 8, KS, g, t4, bh,
                              bl);
            mma_x<XT, false>(pr[q], ah, al, bh, bl);
          }
        }
        const int t_first = tok0 + j * L;
        T* out = on_s ? dr : dk;
#pragma unroll
        for (int q = 0; q < NH; ++q) {
          float o[4], cs[2] = {0.f, 0.f};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int tt = g + 8 * (e / 2), qc = (n0 + q) * 8 + 2 * t4 + e % 2;
            const int at = tt * KC + qc;
            const float rv = load(rr + tt * KT + qc);
            const float kv = load(kr + tt * KT + qc);
            const float gd = Gm[tt * L + tt], gu = gd * us[qc];
            if (on_s) {   // dr'_t = e^ce (S dy_t) + the pairs'
              const float drf = fmaf(ce[at], pr[q][e], drp[at]);
              o[e] = fmaf(gu, kv, drf);
              drp[at] = rv * drf;
              cs[e % 2] = fmaf(gd * rv, kv, cs[e % 2]);
            } else {      // dk'_t = the pairs' + e^(c_L - c) (dS v_t)
              const float dsk = cc[at] * pr[q][e];
              const float dkf = dkp[at] + dsk;
              o[e] = fmaf(gu, rv, dkf);
              dkp[at] = kv * dkf;
              cs[e % 2] = fmaf(kv, dsk, cs[e % 2]);
            }
          }
#pragma unroll
          for (int hr = 0; hr < 2; ++hr)
            if (t_first + g + 8 * hr < S)
              store2(out + head + (long long)(t_first + g + 8 * hr) * ss
                         + (n0 + q) * 8 + 2 * t4,
                     o[2 * hr], o[2 * hr + 1]);
#pragma unroll
          for (int c = 0; c < 2; ++c) {
#pragma unroll
            for (int off = 4; off < 32; off *= 2)
              cs[c] += __shfl_xor_sync(FULL, cs[c], off);
            if (g == 0) {
              const int qc = (n0 + q) * 8 + 2 * t4 + c;
              if (on_s)
                dua[qc] += cs[c];
              else
                qsc[qc] = cs[c];
            }
          }
        }

      } else if ((warp - 4) * NQ < NT) {
        const int n0 = (warp - 4) * NQ;
        float kd4[NQ][4] = {}, at4[NQ][4] = {};
#pragma unroll 2
        for (int ks = 0; ks < K / 8; ++ks) {
          uint32_t ah[4], al[4];
          frag_a([&](int mm, int kk) {
            return load(kr + mm * KT + ks * 8 + kk)
                   * cc[mm * KC + ks * 8 + kk];
          }, g, t4, ah, al);
#pragma unroll
          for (int q = 0; q < NQ; ++q) {
            uint32_t bh[2], bl[2];
            frag_b([&](int kk, int c) {
              return dSm[(ks * 8 + kk) * KS + (n0 + q) * 8 + c];
            }, g, t4, bh, bl);
            mma_x<false, false>(kd4[q], ah, al, bh, bl);
          }
        }
#pragma unroll
        for (int ks = 0; ks < L / 8; ++ks) {
          uint32_t ah[4], al[4];
          frag_a([&](int mm, int kk) {
            const int tt = ks * 8 + kk;
            return Ap[tt * GA + mm] + Ap[L * GA + tt * GA + mm];
          }, g, t4, ah, al);
#pragma unroll
          for (int q = 0; q < NQ; ++q) {
            uint32_t bh[2], bl[2];
            frag_b<XT>([&](int kk, int c) {
              return load(yr + (ks * 8 + kk) * KT + (n0 + q) * 8 + c);
            }, g, t4, bh, bl);
            mma_x<false, XT>(at4[q], ah, al, bh, bl);
          }
        }
        const int t_first = tok0 + j * L;
#pragma unroll
        for (int q = 0; q < NQ; ++q)
#pragma unroll
          for (int hr = 0; hr < 2; ++hr)
            if (t_first + g + 8 * hr < S)
              store2(dv + head + (long long)(t_first + g + 8 * hr) * ss
                         + (n0 + q) * 8 + 2 * t4,
                     at4[q][2 * hr] + kd4[q][2 * hr],
                     at4[q][2 * hr + 1] + kd4[q][2 * hr + 1]);
      }
    }
    if (holds) {
      float rp[2] = {0.f, 0.f};
#pragma unroll
      for (int q = 0; q < TPW; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          rp[e / 2] = fmaf(acc[q][e],
                           Sj[(mrow + g + 8 * (e / 2)) * KS + ncol0 + q * 8
                              + 2 * t4 + e % 2],
                           rp[e / 2]);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        rp[c] += __shfl_xor_sync(FULL, rp[c], 1);
        rp[c] += __shfl_xor_sync(FULL, rp[c], 2);
      }
      if (t4 == 0) {
        const int part = ncol0 / (8 * TPW);
        rs[part * K + mrow + g] = rp[0];
        rs[part * K + mrow + g + 8] = rp[1];
      }
    }
    __syncthreads();

    // dlw: column q, rows 4s .. 4s + 3, the later rows' sums from the
    // neighbouring lanes; then dS <- e^c_L dS + (r e^ce)^T dy
    if (tid < 4 * K) {
      const int q = tid / 4, s = tid % 4;
      const int t_first = tok0 + j * L + 4 * s;
      float pv[4], qv[4], tp = 0.f, tq = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = drp[(4 * s + i) * KC + q];
        qv[i] = dkp[(4 * s + i) * KC + q];
      }
#pragma unroll
      for (int i = 3; i >= 0; --i) tp += pv[i], tq += qv[i];
#pragma unroll
      for (int d = 1; d < 4; d *= 2) {
        const float yp = __shfl_down_sync(FULL, tp, d, 4);
        const float yq = __shfl_down_sync(FULL, tq, d, 4);
        if (s + d < 4) tp += yp, tq += yq;
      }
      float after = __shfl_down_sync(FULL, tp, 1, 4);
      float upto = __shfl_down_sync(FULL, tq, 1, 4);
      if (s == 3) after = upto = 0.f;
      float rsum = 0.f;
#pragma unroll
      for (int p = 0; p < Lay::NP; ++p) rsum += rs[p * K + q];
      const float end = fmaf(wl[q], rsum, qsc[q]);
#pragma unroll
      for (int i = 3; i >= 0; --i) {
        upto += qv[i];
        if (t_first + i < S)
          dlw[head + (long long)(t_first + i) * ss + q] = after - upto + end;
        after += pv[i];
      }
    }
    if (holds && j > 0)
      update([&](int tt, int i) { return load(rr + tt * KT + i)
                                         * ce[tt * KC + i]; }, yr);
    __syncthreads();
  }
  for (int e = tid; e < K; e += SPAN_THREADS)
    du_part[((long long)hb * nsp + n) * K + e] = dua[e];
}

// Pass 3: du = the parts summed over the spans (and over the batch too
// when u is shared, u_sb = 0) in a fixed order: one block per output row
// of K, thread (q, i) summing every DU_WAYS-th part from the i-th, the
// DU_WAYS sums then added in order of i.
constexpr int DU_WAYS = 8;
__global__ void wkv6_bwd_du(const float* __restrict__ du_part,
                            float* __restrict__ du, int B, int H, int nsp,
                            int K, int shared) {
  __shared__ float part[DU_WAYS][64];
  const int row = blockIdx.x, q = threadIdx.x % K, i = threadIdx.x / K;
  const int b0 = shared ? 0 : row / H, b1 = shared ? B : b0 + 1;
  const int h = row % H;
  const long long n_all = (long long)(b1 - b0) * nsp;
  float acc = 0.f;
  for (long long e = i; e < n_all; e += DU_WAYS) {
    const long long b = b0 + e / nsp, n = e % nsp;
    acc += du_part[((b * H + h) * nsp + n) * K + q];
  }
  part[i][q] = acc;
  __syncthreads();
  if (i == 0) {
    float sum = part[0][q];
#pragma unroll
    for (int w = 1; w < DU_WAYS; ++w) sum += part[w][q];
    du[(long long)row * K + q] = sum;
  }
}

template <typename T, int K>
int launch(const void* r, const void* k, const void* v, const float* lw,
           const void* u, const float* s_in, const void* dy,
           const float* ds_in, void* dr, void* dk, void* dv, float* dlw,
           float* du, float* ds0, float* states, float* dstates,
           float* du_part, int B, int S, int H, long long u_sb,
           cudaStream_t stream) {
  const int nsp = (S + M - 1) / M;
  const int heads = B * H;
  const T* rt = static_cast<const T*>(r);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dyt = static_cast<const T*>(dy);
  const int walk_bytes = WalkLayout<T, K>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_bwd_walk<T, K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      walk_bytes);
  if (err != cudaSuccess) return (int)err;
  wkv6_bwd_walk<T, K><<<2 * heads * (K / R), WALK_THREADS, walk_bytes,
                        stream>>>(rt, kt, vt, dyt, lw, s_in, ds_in, states,
                                  dstates, ds0, B, S, H, nsp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int span_bytes = SpanLayout<T, K>::BYTES;
  err = cudaFuncSetAttribute(wkv6_bwd_span<T, K>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             span_bytes);
  if (err != cudaSuccess) return (int)err;
  wkv6_bwd_span<T, K><<<(unsigned)((long long)heads * nsp), SPAN_THREADS,
                        span_bytes, stream>>>(
      rt, kt, vt, dyt, lw, static_cast<const T*>(u), states, dstates,
      static_cast<T*>(dr), static_cast<T*>(dk), static_cast<T*>(dv), dlw,
      du_part, S, H, nsp, u_sb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  wkv6_bwd_du<<<u_sb == 0 ? H : heads, DU_WAYS * K, 0, stream>>>(
      du_part, du, B, H, nsp, K, u_sb == 0);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_k(int K, const void* r, const void* k, const void* v,
             const float* lw, const void* u, const float* s_in,
             const void* dy, const float* ds_in, void* dr, void* dk,
             void* dv, float* dlw, float* du, float* ds0, float* states,
             float* dstates, float* du_part, int B, int S, int H,
             long long u_sb, cudaStream_t st) {
  switch (K) {
    case 16:
      return launch<T, 16>(r, k, v, lw, u, s_in, dy, ds_in, dr, dk, dv, dlw,
                           du, ds0, states, dstates, du_part, B, S, H, u_sb,
                           st);
    case 32:
      return launch<T, 32>(r, k, v, lw, u, s_in, dy, ds_in, dr, dk, dv, dlw,
                           du, ds0, states, dstates, du_part, B, S, H, u_sb,
                           st);
    case 64:
      return launch<T, 64>(r, k, v, lw, u, s_in, dy, ds_in, dr, dk, dv, dlw,
                           du, ds0, states, dstates, du_part, B, S, H, u_sb,
                           st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// A pass's dynamic shared memory (blocks = false), or the thread blocks of
// it that the runtime fits on one SM (blocks = true; -1 on a CUDA error).
template <typename T, int K>
int pass_query(int pass, bool blocks) {
  const int bytes = pass == 0 ? WalkLayout<T, K>::BYTES
                              : SpanLayout<T, K>::BYTES;
  if (!blocks) return bytes;
  const void* fn = pass == 0
      ? reinterpret_cast<const void*>(wkv6_bwd_walk<T, K>)
      : reinterpret_cast<const void*>(wkv6_bwd_span<T, K>);
  int n = 0;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, fn, pass == 0 ? WALK_THREADS : SPAN_THREADS, bytes);
  return err == cudaSuccess ? n : -1;
}

template <typename T>
int query_k(int K, int pass, bool blocks) {
  switch (K) {
    case 16: return pass_query<T, 16>(pass, blocks);
    case 32: return pass_query<T, 32>(pass, blocks);
    case 64: return pass_query<T, 64>(pass, blocks);
    default: return -1;
  }
}

int query(int K, int dtype, int pass, bool blocks) {
  if (pass != 0 && pass != 1) return -1;
  if (dtype == typed_io::F32) return query_k<float>(K, pass, blocks);
  if (dtype == typed_io::BF16)
    return query_k<__nv_bfloat16>(K, pass, blocks);
  return -1;
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block of the walks (pass 0) or of the span
// pass (pass 1); -1 for a K, dtype or pass it does not take.
int wkv6_chunk_bwd_smem_bytes(int K, int dtype, int pass) {
  return query(K, dtype, pass, false);
}

// Thread blocks of the walks (pass 0) or of the span pass (pass 1) that fit
// on one SM at once, by cudaOccupancyMaxActiveBlocksPerMultiprocessor at
// the pass's threads and dynamic shared memory; -1 for a K, dtype or pass
// it does not take, or on a CUDA error.
int wkv6_chunk_bwd_blocks_per_sm(int K, int dtype, int pass) {
  return query(K, dtype, pass, true);
}

// r, k, v, dy, lw and dr, dk, dv, dlw: (B, S, H, K) contiguous, r, k, v,
// dy and lw 16-byte aligned; u: (H, K) when u_sb is 0, else (B, H, K)
// with u_sb = H * K; s_in and ds_in (each may be null: zeros), ds0 (may be
// null: not written): (B, H, K, K) float32; du: (H, K) or (B, H, K)
// float32, like u; scratch: B H n_spans K (2 K + 1) floats, n_spans =
// ceil(S / 64) (the states at each span's start and the cotangents at each
// span's end, then du's parts). K is 16, 32 or 64. dtype: 0 float32, 1
// bfloat16 (r, k, v, u, dy, dr, dk, dv). Launches its three kernels on
// `stream` and returns the first failing CUDA status, or the status after
// the last (0 = launched); does not synchronise and allocates nothing.
int wkv6_chunk_bwd_launch(const void* r, const void* k, const void* v,
                          const float* lw, const void* u, const float* s_in,
                          const void* dy, const float* ds_in, void* dr,
                          void* dk, void* dv, float* dlw, float* du,
                          float* ds0, float* scratch, int B, int S, int H,
                          int K, long long u_sb, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || (long long)B * H > INT_MAX / 8
      || (long long)B * H * ((S + M - 1) / M) > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const uintptr_t a = reinterpret_cast<uintptr_t>(r)
                      | reinterpret_cast<uintptr_t>(k)
                      | reinterpret_cast<uintptr_t>(v)
                      | reinterpret_cast<uintptr_t>(dy)
                      | reinterpret_cast<uintptr_t>(lw);
  if ((a & 15) != 0) return (int)cudaErrorMisalignedAddress;
  const long long mats = (long long)B * H * ((S + M - 1) / M) * K * K;
  float* states = scratch;
  float* dstates = scratch + mats;
  float* du_part = scratch + 2 * mats;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == typed_io::F32)
    return launch_k<float>(K, r, k, v, lw, u, s_in, dy, ds_in, dr, dk, dv,
                           dlw, du, ds0, states, dstates, du_part, B, S, H,
                           u_sb, st);
  if (dtype == typed_io::BF16)
    return launch_k<__nv_bfloat16>(K, r, k, v, lw, u, s_in, dy, ds_in, dr,
                                   dk, dv, dlw, du, ds0, states, dstates,
                                   du_part, B, S, H, u_sb, st);
  return (int)cudaErrorInvalidValue;
}

const char* wkv6_chunk_bwd_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

}  // extern "C"
