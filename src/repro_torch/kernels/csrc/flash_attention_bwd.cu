// flash_attention_bwd: dq, dk and dv of out = softmax(q k^T / sqrt(D)
// [causal mask]) v, from q, k, v, out, the forward's log-sum-exp and dout,
// the attention gradient of the LM zoo's training step.
//
// Replaces no TPU kernel: the reference's backward is plain JAX under a
// custom_vjp, src/repro/nn/attention.py:_flash_core_bwd, which recomputes
// the probabilities chunk by chunk from the saved log-sum-exp so that the
// (Sq, Sk) matrix is never stored. This kernel computes the same function:
//   delta = rowsum(dout * out) in fp32, out as the forward returned it
//           (rounded to its type);
//   p  = exp(s - lse), s = q k^T / sqrt(D) in fp32, -1e30 above the
//        diagonal under a causal mask (positions aligned at 0), so p = 0
//        there exactly; keys past Sk and queries past Sq take no part;
//   dp = dout v^T in fp32;
//   ds = p (dp - delta) / sqrt(D);
//   dv = p^T dout, with p rounded to dout's type (p.astype(dob.dtype));
//   dk = ds^T q and dq = ds k, with ds rounded to k's type (dsb);
// every sum in fp32, each output rounded once to its operand's type. Query
// head h reads kv head h / G, so the GQA repeat is never materialised, and
// dk and dv of a kv head sum its G query heads in fp32 in a fixed order
// (head, then query) before the one rounding (the reference rounds each
// repeated head's dk and sums the G of them in the input type: the same in
// fp32, within bf16 rounding in bf16). No float atomics: each output
// element is summed by one thread and written once, so two launches give
// the same bits. Each operand is read through its own (batch, sequence,
// head) strides in elements, the last dim contiguous; lse and delta are
// (B, H, Sq) fp32 contiguous.
//
// What bounds it on an H100: at Llama-3-8B's training shape (B 1, S 4096,
// H 32, KH 8, D 128, causal) the unmasked half is 8.4 M (query, key) pairs
// a head, and the backward's five products (s, dp, dv, dk, dq) take 2 D
// flops each a pair: 344 GFLOP, 0.35 ms at the card's 989 TFLOP/s for bf16
// operands, against 168 MB of operands, lse and gradients (0.050 ms at
// 3.35 TB/s). It is bound by operations. Three passes, in order:
//   * delta (one warp a (b, h, query) row);
//   * a dq pass, one thread block per q tile, head and b, the heaviest
//     causal tiles (the last queries) first, walking the k tiles up to the
//     diagonal and summing ds k;
//   * a dk/dv pass, one thread block per k tile, kv head and b, the
//     heaviest causal tiles (the first keys) first, walking the G query
//     heads of the kv head and, for each, the q tiles from the diagonal on,
//     summing p^T dout and ds^T q.
// The passes form s and dp again each (7 products a pair where the
// function needs 5): the price of writing dq without atomics. Tiles wholly
// above the diagonal are skipped, which is exact (p = 0). The dtype picks
// one of two routes, as in flash_attention_fwd.cu.
//
// bfloat16, the dtype the models train in: the wgmma route (namespace wg),
// FA3's shape turned around for the backward. All 7 products are bf16
// wgmma with fp32 accumulators, which is what the function asks: bf16
// operands, fp32 sums, p and ds rounded to bf16 before their products.
// The Hopper pieces (mbarriers, TMA, descriptors, wgmma) are hopper.cuh's,
// shared with the forward.
//   * A thread block is 384 threads: two consumer warpgroups and a producer
//     warpgroup, one thread of which feeds a two-stage ring in shared
//     memory: the forward's TMA tensor maps over (D, head, sequence,
//     batch), boxes of 64 rows x 64 head columns, 128-byte swizzled (GQA is
//     the kv head coordinate h / G; ragged S and D < 64 or 128 arrive as
//     zero-filled rows and columns). setmaxnreg moves registers from the
//     producer (40 a thread) to the consumers (232).
//   * flash_bwd_wg_delta writes delta and lse log2(e) into the scratch, each
//     (b, h) row block padded with zeros to whole 64-row tiles, so that a
//     tile's 256 bytes of each arrive by one bulk copy (a (B, H, Sq) row is
//     not 16-byte aligned at a ragged Sq, so it could not).
//   * dk/dv pass (flash_bwd_wg_dkdv): the block's 64 keys of k and v arrive
//     once and stay; each ring stage is one (query head, 64-row q tile)
//     pair: q, dout and the rows' lse and delta. Warpgroup 0 forms S^T =
//     K Q^T, then P^T in the accumulator's registers (lse varies along its
//     columns, the queries, so each thread reads its 16 columns' values
//     from the stage), and sums dV += P^T dO; warpgroup 1 forms dP^T = V
//     dO^T, then dS^T = P^T (dP^T - delta) / sqrt(D) with P^T handed over
//     in fp32 through shared memory (one mbarrier arrival a warp), and sums
//     dK += dS^T Q. S^T and dP^T are m64n64k16 with both operands K-major
//     in shared memory; P^T and dS^T are rounded to bf16 straight into the
//     register A operand of the m64nDk16 products, dout and q MN-major (the
//     transpose bit, as the forward's P V). Each warpgroup holds one 64 x D
//     fp32 accumulator (64 registers a thread at D = 128): a first design
//     with 128 keys a block, each warpgroup summing both dK and dV of 64,
//     needed more than 232 registers and spilled.
//   * dq pass (flash_bwd_wg_dq): the block's 128 rows of q and dout arrive
//     once; the 64-key tiles of k and v stream through the ring; warpgroup
//     w owns rows 64 w .. 64 w + 63 (lse and delta, one value a row, in
//     registers), forms S = Q K^T and dP = dO V^T, then dS, and sums dS_bf16
//     K (K MN-major). A warpgroup computes only the tiles up to its last
//     row's diagonal and hands the others back to the producer.
//   * Each tile's dV, dK or dQ product starts from zero on the tensor cores
//     and is added to the fp32 total by the consumer: the tensor cores'
//     running accumulation sums less exactly than fp32 to nearest, and in
//     place over all of a kv head's G x Sq queries it gave dk and dv
//     1.7-2.0x the relative error against the plain version (on an H100,
//     S 4,096, G 4).
//   * The order of every sum is fixed (head, then q tile; k tile), and dk,
//     dv and dq are written once each: two launches give the same bits.
//   * p = exp2(s log2(e) / sqrt(D) - lse log2(e)): one FMA and one
//     ex2.approx.ftz a pair, taken for every pair, with the mask selected
//     afterwards; the forward keeps its max in log2 units as well, and a
//     last-bit difference in the exponent moves a bf16 rounding of p only
//     rarely.
//   * Masks apply only on edge tiles (those reaching past the diagonal, Sq
//     or Sk), which run a separately compiled loop: p = 0 for a pair above
//     the diagonal, a key past Sk or a query past Sq. TMA's zero rows alone
//     would not do: a zero q row has s = 0 and p = exp(-lse) != 0.
//   * The two passes sum s and dp over D in their own orders (K Q^T against
//     Q K^T), so their ds may differ in a last bit.
// Shared memory at D = 128: 134,144 bytes (dk/dv) and 133,120 (dq), one
// block an SM; registers 168 at launch, no spills. At Llama-3-8B's
// training shape the dk/dv grid is 64 key tiles x 8 kv heads = 512 blocks
// and the dq grid 32 q tiles x 32 heads = 1,024 blocks, against 132 SMs.
//
// float32: the FMA route (namespace fma), this kernel's first design, the
// path of the fp32 checks against the reference's tolerances. Every product is
// fp32 FMA from fp32 shared-memory tiles (67 TFLOP/s at most):
//   * flash_bwd_dkdv: 256 threads per (64-key tile, kv head, b); the k and
//     v tiles stay in shared memory; per q tile it loads q, dout, lse and
//     delta, forms s and dp (thread (ty, tx) of a 16 x 16 grid owns query
//     rows ty + 16 i and keys tx + 16 j), writes p and ds to shared memory,
//     and adds p^T dout and ds^T q into its registers (key rows ty + 16 i,
//     head columns tx + 16 c);
//   * flash_bwd_dq: 256 threads per (64-row q tile, h, b); it recomputes s
//     and dp with the dk/dv pass's arithmetic in the same order, so both
//     passes see the same ds bits, and adds ds k into its registers.
// Tiles are fp32 in shared memory, rows padded by one word against bank
// conflicts: 162 KB (dkdv) and 146 KB (dq) at D = 128, one block an SM.

#include <cuda.h>  // CUtensorMap and its enums only: no libcuda is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "hopper.cuh"
#include "typed_io.cuh"

namespace {

using namespace typed_io;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;  // (B, H, Sq)
  float* delta;      // scratch: (B, H, Sq) (fma), two padded arrays (wg)
  void* dq;
  void* dk;
  void* dv;
  // (batch, sequence, head) strides in elements of q, k, v, o, dout, dq,
  // dk, dv
  long long qs[3], ks[3], vs[3], os[3], dos[3], dqs[3], dks[3], dvs[3];
  int B, H, Sq, Sk, G, D, causal;
  float scale;
};

constexpr int DELTA_THREADS = 256;  // both routes' delta passes: a warp a row

// ---------------------------------------------------------------------------
// the float32 route: fp32 FMA
// ---------------------------------------------------------------------------
namespace fma {

constexpr int BQ = 64, BK = 64;
constexpr int TX = 16, TY = 16;
constexpr int THREADS = TX * TY;
constexpr int R = BQ / TY;      // query (or key) rows per thread (4)
constexpr int C = BK / TX;      // key columns per thread (4)
constexpr int PLD = BK + 1;     // padded row of a p or ds tile
constexpr float MASKED = -1e30f;

template <int DT>
constexpr int dkdv_smem_floats() {
  // k, v, q and dout tiles; p and ds; lse and delta
  return 4 * 64 * (DT + 1) + 2 * 64 * PLD + 2 * 64;
}

template <int DT>
constexpr int dq_smem_floats() {
  // q, dout, k and v tiles; ds; lse and delta
  return 4 * 64 * (DT + 1) + 64 * PLD + 2 * 64;
}

// loads rows [s0, s0 + 64) of one head into tile[64][DT + 1] as fp32,
// zeros past `rows` or D
template <typename T, int DT>
__device__ __forceinline__ void load_tile(float* tile, const T* base,
                                          long long row_stride, int s0,
                                          int rows, int D) {
  constexpr int LD = DT + 1;
  for (int e = threadIdx.x; e < 64 * DT; e += THREADS) {
    const int r = e / DT, d = e % DT, s = s0 + r;
    tile[r * LD + d] =
        (s < rows && d < D) ? load(base + (long long)s * row_stride + d) : 0.f;
  }
}

// lse and delta of query rows [q0, q0 + 64) of one (b, h) row block
__device__ __forceinline__ void load_rows(float* Ls, float* Dl,
                                          const float* lse, const float* delta,
                                          int q0, int Sq) {
  if (threadIdx.x < BQ) {
    const int qi = q0 + threadIdx.x;
    Ls[threadIdx.x] = qi < Sq ? lse[qi] : 0.f;
    Dl[threadIdx.x] = qi < Sq ? delta[qi] : 0.f;
  }
}

// The (q tile at q0) x (k tile at k0) block of s and dp, as the thread
// (ty, tx) owns it (query rows ty + 16 i, keys tx + 16 j), turned into p
// and ds: s and dp are dot products over the head dim in order, p =
// exp(s / sqrt(D) [masked] - lse), ds = p (dp - delta) / sqrt(D), both 0
// for a key past Sk or a query past Sq. Both passes call this, so they
// agree on every bit of ds. (The scalars come by value: a reference to the
// kernel's parameter block could make the compiler copy it to local
// memory.)
template <int DT>
__device__ __forceinline__ void scores(const float* Qs, const float* dOs,
                                       const float* Ks, const float* Vs,
                                       const float* Ls, const float* Dl,
                                       float scale, int causal, int Sq,
                                       int Sk, int q0, int k0,
                                       float (&p)[R][C], float (&ds)[R][C]) {
  constexpr int LD = DT + 1;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  float s[R][C], dp[R][C];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DT; ++d) {
    float qv[R], ov[R], kv[C], vv[C];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      qv[i] = Qs[(ty + TY * i) * LD + d];
      ov[i] = dOs[(ty + TY * i) * LD + d];
    }
#pragma unroll
    for (int j = 0; j < C; ++j) {
      kv[j] = Ks[(tx + TX * j) * LD + d];
      vv[j] = Vs[(tx + TX * j) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < C; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = ty + TY * i, qi = q0 + r;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const int kj = k0 + tx + TX * j;
      float x = s[i][j] * scale;
      if (causal && qi < kj) x = MASKED;
      float pij = expf(x - Ls[r]);
      if (kj >= Sk || qi >= Sq) pij = 0.f;  // no such key or query
      p[i][j] = pij;
      ds[i][j] = pij * (dp[i][j] - Dl[r]) * scale;
    }
  }
}

// delta = rowsum(dout * out) in fp32: one warp per (b, h, query) row, rows
// in (b, h, query) order
template <typename T>
__global__ void __launch_bounds__(DELTA_THREADS) flash_bwd_delta(Args a) {
  const long long row =
      (long long)blockIdx.x * (DELTA_THREADS / 32) + threadIdx.x / 32;
  if (row >= (long long)a.B * a.H * a.Sq) return;  // the whole warp leaves
  const int lane = threadIdx.x % 32;
  const int qi = (int)(row % a.Sq);
  const int h = (int)((row / a.Sq) % a.H), b = (int)(row / a.Sq / a.H);
  const T* o = static_cast<const T*>(a.o) + b * a.os[0] + qi * a.os[1] +
               h * a.os[2];
  const T* g = static_cast<const T*>(a.dout) + b * a.dos[0] +
               qi * a.dos[1] + h * a.dos[2];
  float acc = 0.f;
  for (int d = lane; d < a.D; d += 32) acc = fmaf(load(g + d), load(o + d), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) a.delta[row] = acc;
}

template <typename T, int DT>
__global__ void __launch_bounds__(THREADS, 1) flash_bwd_dkdv(Args a) {
  constexpr int LD = DT + 1;
  constexpr int CD = DT / TX;  // head columns per thread
  extern __shared__ float smem[];
  float* Ks = smem;           // [BK][LD]
  float* Vs = Ks + BK * LD;   // [BK][LD]
  float* Qs = Vs + BK * LD;   // [BQ][LD]
  float* dOs = Qs + BQ * LD;  // [BQ][LD]
  float* Ps = dOs + BQ * LD;  // [BQ][PLD], p rounded to dout's type
  float* dSs = Ps + BQ * PLD; // [BQ][PLD], ds rounded to k's type
  float* Ls = dSs + BQ * PLD; // [BQ]
  float* Dl = Ls + BQ;        // [BQ]

  // blockIdx.x walks (k tile, kv head) with the k tile slowest, so the
  // heaviest causal tiles of every head start first
  const int KH = a.H / a.G;
  const int kt = blockIdx.x / KH, hk = blockIdx.x % KH, b = blockIdx.y;
  const int k0 = kt * BK;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  load_tile<T, DT>(Ks, static_cast<const T*>(a.k) + b * a.ks[0] +
                           hk * a.ks[2], a.ks[1], k0, a.Sk, a.D);
  load_tile<T, DT>(Vs, static_cast<const T*>(a.v) + b * a.vs[0] +
                           hk * a.vs[2], a.vs[1], k0, a.Sk, a.D);

  float dk[R][CD], dv[R][CD];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < CD; ++c) dk[i][c] = dv[i][c] = 0.f;

  // under a causal mask the q tiles that end before k0 see none of these
  // keys (BQ == BK: tile kt is the first that reaches k0)
  const int qt0 = a.causal ? kt : 0;
  const int n_qt = (a.Sq + BQ - 1) / BQ;
  for (int g = 0; g < a.G; ++g) {
    const int h = hk * a.G + g;
    const T* q = static_cast<const T*>(a.q) + b * a.qs[0] + h * a.qs[2];
    const T* dout = static_cast<const T*>(a.dout) + b * a.dos[0] +
                    h * a.dos[2];
    const long long row0 = ((long long)b * a.H + h) * a.Sq;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // the last tile's products are done with the tiles
      load_tile<T, DT>(Qs, q, a.qs[1], q0, a.Sq, a.D);
      load_tile<T, DT>(dOs, dout, a.dos[1], q0, a.Sq, a.D);
      load_rows(Ls, Dl, a.lse + row0, a.delta + row0, q0, a.Sq);
      __syncthreads();

      float p[R][C], ds[R][C];
      scores<DT>(Qs, dOs, Ks, Vs, Ls, Dl, a.scale, a.causal, a.Sq, a.Sk, q0,
                 k0, p, ds);
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < C; ++j) {
          Ps[(ty + TY * i) * PLD + tx + TX * j] = round_to<T>(p[i][j]);
          dSs[(ty + TY * i) * PLD + tx + TX * j] = round_to<T>(ds[i][j]);
        }
      __syncthreads();

      // dv += p^T dout, dk += ds^T q over this tile's queries in order
      const int nq = min(BQ, a.Sq - q0);
#pragma unroll 2
      for (int r = 0; r < nq; ++r) {
        float pv[R], sv[R], ov[CD], xv[CD];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          pv[i] = Ps[r * PLD + ty + TY * i];
          sv[i] = dSs[r * PLD + ty + TY * i];
        }
#pragma unroll
        for (int c = 0; c < CD; ++c) {
          ov[c] = dOs[r * LD + tx + TX * c];
          xv[c] = Qs[r * LD + tx + TX * c];
        }
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int c = 0; c < CD; ++c) {
            dv[i][c] = fmaf(pv[i], ov[c], dv[i][c]);
            dk[i][c] = fmaf(sv[i], xv[c], dk[i][c]);
          }
      }
    }
  }

  T* dkp = static_cast<T*>(a.dk) + b * a.dks[0] + hk * a.dks[2];
  T* dvp = static_cast<T*>(a.dv) + b * a.dvs[0] + hk * a.dvs[2];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int kj = k0 + ty + TY * i;
    if (kj >= a.Sk) continue;
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      const int d = tx + TX * c;
      if (d >= a.D) continue;
      store(dkp + (long long)kj * a.dks[1] + d, dk[i][c]);
      store(dvp + (long long)kj * a.dvs[1] + d, dv[i][c]);
    }
  }
}

template <typename T, int DT>
__global__ void __launch_bounds__(THREADS, 1) flash_bwd_dq(Args a) {
  constexpr int LD = DT + 1;
  constexpr int CD = DT / TX;
  extern __shared__ float smem[];
  float* Qs = smem;           // [BQ][LD]
  float* dOs = Qs + BQ * LD;  // [BQ][LD]
  float* Ks = dOs + BQ * LD;  // [BK][LD]
  float* Vs = Ks + BK * LD;   // [BK][LD]
  float* dSs = Vs + BK * LD;  // [BQ][PLD], ds rounded to k's type
  float* Ls = dSs + BQ * PLD; // [BQ]
  float* Dl = Ls + BQ;        // [BQ]

  // blockIdx.x walks (q tile, head) with the q tile slowest, from the last
  // tile, so the heaviest causal tiles of every head start first
  const int n_qt = (a.Sq + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - (int)(blockIdx.x / a.H)) * BQ;
  const int h = blockIdx.x % a.H, b = blockIdx.y, hk = h / a.G;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const T* k = static_cast<const T*>(a.k) + b * a.ks[0] + hk * a.ks[2];
  const T* v = static_cast<const T*>(a.v) + b * a.vs[0] + hk * a.vs[2];
  const long long row0 = ((long long)b * a.H + h) * a.Sq;
  load_tile<T, DT>(Qs, static_cast<const T*>(a.q) + b * a.qs[0] +
                           h * a.qs[2], a.qs[1], q0, a.Sq, a.D);
  load_tile<T, DT>(dOs, static_cast<const T*>(a.dout) + b * a.dos[0] +
                            h * a.dos[2], a.dos[1], q0, a.Sq, a.D);
  load_rows(Ls, Dl, a.lse + row0, a.delta + row0, q0, a.Sq);

  float dq[R][CD];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < CD; ++c) dq[i][c] = 0.f;

  // under a causal mask, key tiles past the last query row are all masked
  const int k_end = a.causal ? min(a.Sk, q0 + BQ) : a.Sk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the last tile's dq product is done with Ks and dSs
    load_tile<T, DT>(Ks, k, a.ks[1], k0, a.Sk, a.D);
    load_tile<T, DT>(Vs, v, a.vs[1], k0, a.Sk, a.D);
    __syncthreads();

    float p[R][C], ds[R][C];
    scores<DT>(Qs, dOs, Ks, Vs, Ls, Dl, a.scale, a.causal, a.Sq, a.Sk, q0, k0,
               p, ds);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < C; ++j)
        dSs[(ty + TY * i) * PLD + tx + TX * j] = round_to<T>(ds[i][j]);
    __syncthreads();

    // dq += ds k over this tile's keys in order
    const int nk = min(BK, a.Sk - k0);
#pragma unroll 2
    for (int kk = 0; kk < nk; ++kk) {
      float sv[R], kv[CD];
#pragma unroll
      for (int i = 0; i < R; ++i) sv[i] = dSs[(ty + TY * i) * PLD + kk];
#pragma unroll
      for (int c = 0; c < CD; ++c) kv[c] = Ks[kk * LD + tx + TX * c];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int c = 0; c < CD; ++c) dq[i][c] = fmaf(sv[i], kv[c], dq[i][c]);
    }
  }

  T* dqp = static_cast<T*>(a.dq) + b * a.dqs[0] + h * a.dqs[2];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qi = q0 + ty + TY * i;
    if (qi >= a.Sq) continue;
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      const int d = tx + TX * c;
      if (d < a.D) store(dqp + (long long)qi * a.dqs[1] + d, dq[i][c]);
    }
  }
}

template <typename T, int DT>
int launch(const Args& a, cudaStream_t stream) {
  const long long rows = (long long)a.B * a.H * a.Sq;
  flash_bwd_delta<T><<<(unsigned)((rows + DELTA_THREADS / 32 - 1) /
                                  (DELTA_THREADS / 32)),
                       DELTA_THREADS, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int n_qt = (a.Sq + BQ - 1) / BQ, n_kt = (a.Sk + BK - 1) / BK;
  const int dq_bytes = dq_smem_floats<DT>() * (int)sizeof(float);
  err = cudaFuncSetAttribute(flash_bwd_dq<T, DT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dq_bytes);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq<T, DT><<<dim3(n_qt * a.H, a.B), THREADS, dq_bytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int dkdv_bytes = dkdv_smem_floats<DT>() * (int)sizeof(float);
  err = cudaFuncSetAttribute(flash_bwd_dkdv<T, DT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dkdv_bytes);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkdv<T, DT><<<dim3(n_kt * (a.H / a.G), a.B), THREADS, dkdv_bytes,
                          stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace fma

// ---------------------------------------------------------------------------
// the bfloat16 route: TMA, mbarriers and wgmma
// ---------------------------------------------------------------------------
namespace wg {

using namespace hopper;

constexpr int CONSUMERS = 2;                    // warpgroups
constexpr int THREADS = 128 * (CONSUMERS + 1);  // + the producer warpgroup
constexpr int STEP = 64;  // keys (dk/dv) or q rows (dq) a block owns per
                          // warpgroup; q rows (dk/dv) or keys (dq) a stage
constexpr int DQ_ROWS = STEP * CONSUMERS;       // q rows a dq block owns
constexpr int DKDV_STAGES = 2, DQ_STAGES = 2;  // ring stages of the passes
constexpr int PANEL_OWN = DQ_ROWS * ROW_BYTES;  // 128 rows x 64 columns
constexpr int PANEL_STEP = STEP * ROW_BYTES;    // 64 rows x 64 columns
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;

// NP panels of 64 head columns each; every panel starts on a 1024-byte
// boundary, the period of the 128-byte swizzle
template <int NP>
struct __align__(1024) DkdvSmem {
  uint8_t k[NP][PANEL_STEP];
  uint8_t v[NP][PANEL_STEP];
  uint8_t q[DKDV_STAGES][NP][PANEL_STEP];
  uint8_t dout[DKDV_STAGES][NP][PANEL_STEP];
  // P^T (64 keys x 64 queries, fp32) from the dV warpgroup to the dK one,
  // in the accumulators' order: element i of thread t at [i / 4][t][i % 4]
  float4 p[DKDV_STAGES][8][128];
  float lse[DKDV_STAGES][STEP];    // x log2(e); 0 past Sq
  float delta[DKDV_STAGES][STEP];  // 0 past Sq
  uint64_t kv_full, full[DKDV_STAGES], empty[DKDV_STAGES], p_full[DKDV_STAGES];
};

template <int NP>
struct __align__(1024) DqSmem {
  uint8_t q[NP][PANEL_OWN];
  uint8_t dout[NP][PANEL_OWN];
  uint8_t k[DQ_STAGES][NP][PANEL_STEP];
  uint8_t v[DQ_STAGES][NP][PANEL_STEP];
  uint64_t q_full, full[DQ_STAGES], empty[DQ_STAGES];
};

template <typename S>
constexpr int smem_bytes() {
  return (int)sizeof(S) + 1024;  // + aligning the base
}

template <typename S>
__device__ __forceinline__ S& smem_struct() {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t pad = (1024 - (smem_u32(smem_raw) & 1023)) & 1023;
  return *reinterpret_cast<S*>(smem_raw + pad);
}

// The route's scratch (the caller's delta buffer): each (b, h) row block
// of lse x log2(e), then of delta, padded to a whole number of 64-row
// tiles with zeros, so that a tile's 256 bytes of each arrive by one bulk
// copy (a (B, H, Sq) row is not 16-byte aligned at a ragged Sq)
__host__ __device__ __forceinline__ long long padded_rows(int Sq) {
  return (Sq + STEP - 1) / STEP * STEP;
}
__device__ __forceinline__ float* lse2_rows(const Args& a, int bh) {
  return a.delta + bh * padded_rows(a.Sq);
}
__device__ __forceinline__ float* delta_rows(const Args& a, int bh) {
  return a.delta + ((long long)a.B * a.H + bh) * padded_rows(a.Sq);
}

// delta = rowsum(dout * out) and lse x log2(e) into the scratch, zeros in
// the padding: one warp per (b, h, padded query) row
__global__ void __launch_bounds__(DELTA_THREADS) flash_bwd_wg_delta(Args a) {
  const long long Sqp = padded_rows(a.Sq);
  const long long row =
      (long long)blockIdx.x * (DELTA_THREADS / 32) + threadIdx.x / 32;
  if (row >= (long long)a.B * a.H * Sqp) return;  // the whole warp leaves
  const int lane = threadIdx.x % 32;
  const int qi = (int)(row % Sqp), bh = (int)(row / Sqp);
  float acc = 0.f, lse2 = 0.f;
  if (qi < a.Sq) {
    const int h = bh % a.H, b = bh / a.H;
    const __nv_bfloat16* o = static_cast<const __nv_bfloat16*>(a.o) +
                             b * a.os[0] + qi * a.os[1] + h * a.os[2];
    const __nv_bfloat16* g = static_cast<const __nv_bfloat16*>(a.dout) +
                             b * a.dos[0] + qi * a.dos[1] + h * a.dos[2];
    for (int d = lane; d < a.D; d += 32)
      acc = fmaf(load(g + d), load(o + d), acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    lse2 = a.lse[(long long)bh * a.Sq + qi] * LOG2E;
  }
  if (lane == 0) {
    lse2_rows(a, bh)[qi] = lse2;
    delta_rows(a, bh)[qi] = acc;
  }
}

// acc (64 x 64 fp32, m64n64's accumulator layout) = A B^T over the DP / 16
// steps of 16 head columns, A's 64 rows and B's 64 rows K-major in panels
// a_panel and b_panel bytes apart
template <int DP>
__device__ __forceinline__ void scores(float (&acc)[32], uint32_t a,
                                       uint32_t a_panel, uint32_t b,
                                       uint32_t b_panel) {
#pragma unroll
  for (int ks = 0; ks < DP / 16; ++ks)
    wgmma_ss_n64(acc, kmajor_desc(a + (ks / 4) * a_panel + (ks % 4) * 32),
                 kmajor_desc(b + (ks / 4) * b_panel + (ks % 4) * 32), ks > 0);
}

// part (64 x DP fp32) = A (64 x 64 bf16 in registers, packed) B (64 x DP,
// MN-major in shared memory at b, panels PANEL_STEP bytes apart)
template <int DP>
__device__ __forceinline__ void product(float* part,
                                        const uint32_t (&a)[4][4],
                                        uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < STEP / 16; ++kk) {
    const uint64_t db = mnmajor_desc(b + kk * 16 * ROW_BYTES, PANEL_STEP);
    if constexpr (DP == 64)
      wgmma_rs_n64(part, a[kk], db, kk > 0);
    else
      wgmma_rs_n128(part, a[kk], db, kk > 0);
  }
}

// 2^x on the SFU in one instruction (subnormal results flush to 0). It is
// taken for every pair and the mask selects afterwards: a branch around
// each exponential (what `masked ? 0 : exp2f(..)` compiled to) costs the
// loop its parallelism, and exp2f's subnormal handling more instructions.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// p and ds of one (query, key) pair from s = q . k and dp = dout . v:
// p = exp2(s log2(e) / sqrt(D) - lse log2(e)), 0 where `masked`, and ds =
// p (dp - delta) / sqrt(D); s becomes p and dp becomes ds
__device__ __forceinline__ void p_ds(float& s, float& dp, float lse2,
                                     float delta, float scale2, float scale,
                                     bool masked) {
  const float e = ex2(fmaf(s, scale2, -lse2));
  const float p = masked ? 0.f : e;
  s = p;
  dp = p * (dp - delta) * scale;
}

// (query qi, key kj) takes no part: above the diagonal, or no such key or
// query
__device__ __forceinline__ bool masked_pair(const Args& a, int qi, int kj) {
  return (a.causal && qi < kj) || kj >= a.Sk || qi >= a.Sq;
}

// P^T of the dk/dv pass in place of S^T (x, keys kr and kr + 8, query
// columns 8 (i / 4) + cq + i % 2 of the q tile at q0): lse2 varies along
// the columns. EDGE (a tile reaching past the diagonal, Sq or Sk) adds the
// mask; the other tiles, nearly all, run without its instructions.
template <bool EDGE>
__device__ __forceinline__ void p_of_scores(float (&x)[32], const float* lse2,
                                            const Args& a, int q0, int kr,
                                            int cq, float scale2) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int c = 8 * (i / 4) + cq + i % 2;
    const float e = ex2(fmaf(x[i], scale2, -lse2[c]));
    x[i] = EDGE && masked_pair(a, q0 + c, kr + 8 * ((i % 4) / 2)) ? 0.f : e;
  }
}

// p and ds of the dq pass in place of s and dp (rows r0 and r0 + 8, each
// with its lse2 and delta; key columns k0 + 8 (i / 4) + cq + i % 2); EDGE
// as above
template <bool EDGE>
__device__ __forceinline__ void p_ds_of_scores(
    float (&s)[32], float (&dp)[32], const float (&lse2)[2],
    const float (&delta)[2], const Args& a, int r0, int k0, int cq,
    float scale2, float scale) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int e = (i % 4) / 2;
    p_ds(s[i], dp[i], lse2[e], delta[e], scale2, scale,
         EDGE && masked_pair(a, r0 + 8 * e, k0 + 8 * (i / 4) + cq + i % 2));
  }
}

// x (64 x 64 fp32 in m64n64's accumulator layout) rounded to bf16 as the
// register A operand of a product over its 64 columns: columns 16 kk ..
// 16 kk + 15 are accumulator groups 2 kk (A registers 0, 1) and 2 kk + 1
// (A registers 2, 3), rows r (0, 2) and r + 8 (1, 3)
__device__ __forceinline__ void pack_a(const float (&x)[32],
                                       uint32_t (&a)[4][4]) {
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    a[jj / 2][(jj % 2) * 2 + 0] = pack_bf16(x[4 * jj], x[4 * jj + 1]);
    a[jj / 2][(jj % 2) * 2 + 1] = pack_bf16(x[4 * jj + 2], x[4 * jj + 3]);
  }
}

// rows r and r + 8 of a 64 x DP fp32 accumulator to bf16 rows of `out`
// (row stride rs), masked at `rows` and D
template <int DP>
__device__ __forceinline__ void store_rows(const float* acc,
                                           __nv_bfloat16* out, long long rs,
                                           int r, int rows, int D) {
  const int c = 2 * (threadIdx.x % 4);
#pragma unroll
  for (int jj = 0; jj < DP / 8; ++jj) {
    const int d = 8 * jj + c;  // D is a multiple of 8, so d + 1 < D too
    if (d >= D) continue;
    if (r < rows)
      *reinterpret_cast<__nv_bfloat162*>(out + (long long)r * rs + d) =
          __floats2bfloat162_rn(acc[4 * jj], acc[4 * jj + 1]);
    if (r + 8 < rows)
      *reinterpret_cast<__nv_bfloat162*>(out + (long long)(r + 8) * rs + d) =
          __floats2bfloat162_rn(acc[4 * jj + 2], acc[4 * jj + 3]);
  }
}

// The dk/dv pass's consumers: both warpgroups own the block's 64 keys, k0
// .. k0 + 63. Thread (warp, lane) of either holds keys kr = k0 + 16 warp +
// lane / 4 and kr + 8: in the accumulator layout element i is key kr + 8
// ((i % 4) / 2) and query column 8 (i / 4) + 2 (lane % 4) + i % 2 of the
// stage's q tile, and dk, dv likewise over head columns. Warpgroup 0
// forms S^T = K Q^T and P^T, hands P^T to warpgroup 1 through shared
// memory and sums dV += P^T dO; warpgroup 1 forms dP^T = V dO^T, then dS^T
// from P^T, and sums dK += dS^T Q: two products each a stage, and one
// 64 x D accumulator a thread.
template <int NP>
__device__ __forceinline__ void dkdv_consume(DkdvSmem<NP>& sm, const Args& a,
                                             int k0, int qt0, int n_qt,
                                             int wgi, int b, int hk) {
  constexpr int DP = 64 * NP;
  constexpr int NO = DP / 2;
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int kr = k0 + 16 * warp + lane / 4;
  const int cq = 2 * (lane % 4);
  const float scale = a.scale, scale2 = a.scale * LOG2E;
  float acc[NO];  // dv (warpgroup 0) or dk (1)
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;
  const uint32_t kv_base = smem_u32(wgi == 0 ? sm.k[0] : sm.v[0]);
  mbar_wait(&sm.kv_full, 0);

  const int per_head = n_qt - qt0;
  for (int it = 0; it < a.G * per_head; ++it) {
    const int st = it % DKDV_STAGES;
    const uint32_t ph = (it / DKDV_STAGES) & 1;
    const int q0 = (qt0 + it % per_head) * STEP;
    mbar_wait(&sm.full[st], ph);
    const uint32_t q_st = smem_u32(sm.q[st][0]);
    const uint32_t do_st = smem_u32(sm.dout[st][0]);

    // S^T = K Q^T (warpgroup 0) or dP^T = V dO^T (1); zeroed first only so
    // that no register is read before it is written (scale_d = 0 drops it)
    float x[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) x[i] = 0.f;
    wgmma_fence();
    scores<DP>(x, kv_base, PANEL_STEP, wgi == 0 ? q_st : do_st, PANEL_STEP);
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(x);

    uint32_t xa[4][4];
    if (wgi == 0) {
      // P^T: lse varies along the columns (queries); p = 0 where masked
      const bool edge = (a.causal && q0 < k0 + 63) || q0 + STEP > a.Sq ||
                        k0 + STEP > a.Sk;
      if (edge)
        p_of_scores<true>(x, sm.lse[st], a, q0, kr, cq, scale2);
      else
        p_of_scores<false>(x, sm.lse[st], a, q0, kr, cq, scale2);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        sm.p[st][j][t] =
            make_float4(x[4 * j], x[4 * j + 1], x[4 * j + 2], x[4 * j + 3]);
      __syncwarp();  // the warp's P^T is written: one arrival publishes it
      if (lane == 0) mbar_arrive(&sm.p_full[st]);
      pack_a(x, xa);
    } else {
      // dS^T = P^T (dP^T - delta) / sqrt(D), delta along the columns
      mbar_wait(&sm.p_full[st], ph);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 p = sm.p[st][j][t];
        const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          x[i] = pv[e] * (x[i] - sm.delta[st][8 * j + cq + e % 2]) * scale;
        }
      }
      pack_a(x, xa);
    }

    // dV += P^T dO (warpgroup 0) or dK += dS^T Q (1) over the 64 queries:
    // the tile's product on the tensor cores, then added in fp32, so that
    // the sums over many tiles round to nearest (the tensor cores' own
    // accumulation is not, and its error grows with the number of tiles)
    float part[NO];
    wgmma_fence();
    product<DP>(part, xa, wgi == 0 ? do_st : q_st);
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(part);
#pragma unroll
    for (int i = 0; i < NO; ++i) acc[i] += part[i];
    if (lane == 0) mbar_arrive(&sm.empty[st]);  // this warp is done with st
  }

  void* out = wgi == 0 ? a.dv : a.dk;
  const long long* os = wgi == 0 ? a.dvs : a.dks;
  store_rows<DP>(acc, static_cast<__nv_bfloat16*>(out) + b * os[0] +
                          hk * os[2], os[1], kr, a.Sk, a.D);
}

template <int NP>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_wg_dkdv(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo,
                      const Args a) {
  DkdvSmem<NP>& sm = smem_struct<DkdvSmem<NP>>();
  // blockIdx.x walks (k tile, kv head) with the k tile slowest, so the
  // heaviest causal tiles of every head start first
  const int KH = a.H / a.G;
  const int hk = blockIdx.x % KH, b = blockIdx.y;
  const int k0 = (blockIdx.x / KH) * STEP;
  const int n_qt = (a.Sq + STEP - 1) / STEP;
  // under a causal mask the q tiles that end before k0 see none of its keys
  const int qt0 = a.causal ? min(k0 / STEP, n_qt) : 0;
  const int wgi = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(&sm.kv_full, 1);
    for (int st = 0; st < DKDV_STAGES; ++st) {
      mbar_init(&sm.full[st], 1);
      mbar_init(&sm.empty[st], CONSUMERS * 4);  // lane 0 of each warp
      mbar_init(&sm.p_full[st], 4);  // lane 0 of each warp of warpgroup 0
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // one if-else for the two roles, never reconverging (setmaxnreg needs it)
  if (wgi == CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS)
                 : "memory");
    if (threadIdx.x == CONSUMERS * 128) {
      mbar_expect_tx(&sm.kv_full, 2 * NP * PANEL_STEP);
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        tma_load(sm.k[p], &tk, &sm.kv_full, 64 * p, hk, k0, b);
        tma_load(sm.v[p], &tv, &sm.kv_full, 64 * p, hk, k0, b);
      }
      const int per_head = n_qt - qt0;
      for (int it = 0; it < a.G * per_head; ++it) {
        const int st = it % DKDV_STAGES;
        const int h = hk * a.G + it / per_head;
        const int q0 = (qt0 + it % per_head) * STEP;
        const int bh = b * a.H + h;
        mbar_wait(&sm.empty[st], ((it / DKDV_STAGES) & 1) ^ 1);  // round 0
        mbar_expect_tx(&sm.full[st], 2 * NP * PANEL_STEP + 2 * STEP * 4);
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          tma_load(sm.q[st][p], &tq, &sm.full[st], 64 * p, h, q0, b);
          tma_load(sm.dout[st][p], &tdo, &sm.full[st], 64 * p, h, q0, b);
        }
        bulk_load(sm.lse[st], lse2_rows(a, bh) + q0, STEP * 4, &sm.full[st]);
        bulk_load(sm.delta[st], delta_rows(a, bh) + q0, STEP * 4,
                  &sm.full[st]);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS)
                 : "memory");
    dkdv_consume<NP>(sm, a, k0, qt0, n_qt, wgi, b, hk);
  }
}

// One consumer warpgroup of the dq pass: query rows row_lo .. row_lo + 63.
// Thread (warp, lane) holds rows r0 = row_lo + 16 warp + lane / 4 and r0 +
// 8: s[i] is row r0 + 8 ((i % 4) / 2) and key column 8 (i / 4) + 2 (lane %
// 4) + i % 2 of the stage's k tile, and dq likewise over head columns.
template <int NP>
__device__ __forceinline__ void dq_consume(DqSmem<NP>& sm, const Args& a,
                                           int q0, int n_tiles, int wgi,
                                           int b, int h) {
  constexpr int DP = 64 * NP;
  constexpr int NO = DP / 2;
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int row_lo = q0 + 64 * wgi;
  const int r0 = row_lo + 16 * warp + lane / 4;
  const int cq = 2 * (lane % 4);
  const float scale = a.scale, scale2 = a.scale * LOG2E;
  float lse2[2], delta[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int qi = r0 + 8 * e;
    lse2[e] = qi < a.Sq ? lse2_rows(a, b * a.H + h)[qi] : 0.f;
    delta[e] = qi < a.Sq ? delta_rows(a, b * a.H + h)[qi] : 0.f;
  }
  float dq[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) dq[i] = 0.f;
  const uint32_t q_base = smem_u32(sm.q[0]) + wgi * 64 * ROW_BYTES;
  const uint32_t do_base = smem_u32(sm.dout[0]) + wgi * 64 * ROW_BYTES;
  mbar_wait(&sm.q_full, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % DQ_STAGES;
    const int k0 = j * STEP;
    mbar_wait(&sm.full[st], (j / DQ_STAGES) & 1);
    // under a causal mask a k tile past this warpgroup's last row is all
    // masked; rows past Sq are not stored
    if ((a.causal && k0 > row_lo + 63) || row_lo >= a.Sq) {
      if (lane == 0) mbar_arrive(&sm.empty[st]);
      continue;
    }
    const uint32_t k_st = smem_u32(sm.k[st][0]);
    const uint32_t v_st = smem_u32(sm.v[st][0]);

    // S = Q K^T and dP = dO V^T
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    wgmma_fence();
    scores<DP>(s, q_base, PANEL_OWN, k_st, PANEL_STEP);
    scores<DP>(dp, do_base, PANEL_OWN, v_st, PANEL_STEP);
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(s);
    fence_operands(dp);

    const bool edge = (a.causal && k0 + STEP - 1 > row_lo) ||
                      k0 + STEP > a.Sk || row_lo + 64 > a.Sq;
    if (edge)
      p_ds_of_scores<true>(s, dp, lse2, delta, a, r0, k0, cq, scale2, scale);
    else
      p_ds_of_scores<false>(s, dp, lse2, delta, a, r0, k0, cq, scale2, scale);
    uint32_t da[4][4];
    pack_a(dp, da);

    // dQ += dS K over the stage's 64 keys, added in fp32 as dk and dv are
    float part[NO];
    wgmma_fence();
    product<DP>(part, da, k_st);
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(part);
#pragma unroll
    for (int i = 0; i < NO; ++i) dq[i] += part[i];
    if (lane == 0) mbar_arrive(&sm.empty[st]);  // this warp is done with st
  }

  store_rows<DP>(dq, static_cast<__nv_bfloat16*>(a.dq) + b * a.dqs[0] +
                         h * a.dqs[2], a.dqs[1], r0, a.Sq, a.D);
}

template <int NP>
__global__ void __launch_bounds__(THREADS, 1)
    flash_bwd_wg_dq(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo, const Args a) {
  DqSmem<NP>& sm = smem_struct<DqSmem<NP>>();
  // blockIdx.x walks (q tile, head) with the q tile slowest, from the last
  // tile, so the heaviest causal tiles of every head start first
  const int n_qt = (a.Sq + DQ_ROWS - 1) / DQ_ROWS;
  const int q0 = (n_qt - 1 - (int)(blockIdx.x / a.H)) * DQ_ROWS;
  const int h = blockIdx.x % a.H, b = blockIdx.y;
  // under a causal mask, key tiles past the last query row are all masked
  const int k_end = a.causal ? min(a.Sk, q0 + DQ_ROWS) : a.Sk;
  const int n_tiles = (k_end + STEP - 1) / STEP;
  const int wgi = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    for (int st = 0; st < DQ_STAGES; ++st) {
      mbar_init(&sm.full[st], 1);
      mbar_init(&sm.empty[st], CONSUMERS * 4);  // lane 0 of each warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wgi == CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS)
                 : "memory");
    if (threadIdx.x == CONSUMERS * 128) {
      const int hk = h / a.G;
      mbar_expect_tx(&sm.q_full, 2 * NP * PANEL_OWN);
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int r = 0; r < DQ_ROWS; r += STEP) {
          tma_load(sm.q[p] + r * ROW_BYTES, &tq, &sm.q_full, 64 * p, h,
                   q0 + r, b);
          tma_load(sm.dout[p] + r * ROW_BYTES, &tdo, &sm.q_full, 64 * p, h,
                   q0 + r, b);
        }
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % DQ_STAGES;
        mbar_wait(&sm.empty[st], ((j / DQ_STAGES) & 1) ^ 1);  // round 0 passes
        mbar_expect_tx(&sm.full[st], 2 * NP * PANEL_STEP);
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          tma_load(sm.k[st][p], &tk, &sm.full[st], 64 * p, hk, j * STEP, b);
          tma_load(sm.v[st][p], &tv, &sm.full[st], 64 * p, hk, j * STEP, b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS)
                 : "memory");
    dq_consume<NP>(sm, a, q0, n_tiles, wgi, b, h);
  }
}

template <int NP>
int launch(const Args& a, const long long* strides, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  const int KH = a.H / a.G;
  int err = make_map(&tq, a.q, a.D, a.H, a.Sq, a.B, strides, STEP);
  if (err == 0)
    err = make_map(&tk, a.k, a.D, KH, a.Sk, a.B, strides + 3, STEP);
  if (err == 0)
    err = make_map(&tv, a.v, a.D, KH, a.Sk, a.B, strides + 6, STEP);
  if (err == 0)
    err = make_map(&tdo, a.dout, a.D, a.H, a.Sq, a.B, strides + 12, STEP);
  if (err != 0) return err;
  const long long rows = (long long)a.B * a.H * padded_rows(a.Sq);
  flash_bwd_wg_delta<<<(unsigned)((rows + DELTA_THREADS / 32 - 1) /
                                  (DELTA_THREADS / 32)),
                       DELTA_THREADS, 0, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const int dq_bytes = smem_bytes<DqSmem<NP>>();
  e = cudaFuncSetAttribute(
      flash_bwd_wg_dq<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      dq_bytes);
  if (e != cudaSuccess) return (int)e;
  const int n_qt = (a.Sq + DQ_ROWS - 1) / DQ_ROWS;
  const int n_kt = (a.Sk + STEP - 1) / STEP;
  flash_bwd_wg_dq<NP><<<dim3(n_qt * a.H, a.B), THREADS, dq_bytes, stream>>>(
      tq, tk, tv, tdo, a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const int dkdv_bytes = smem_bytes<DkdvSmem<NP>>();
  e = cudaFuncSetAttribute(flash_bwd_wg_dkdv<NP>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           dkdv_bytes);
  if (e != cudaSuccess) return (int)e;
  flash_bwd_wg_dkdv<NP><<<dim3(n_kt * KH, a.B), THREADS, dkdv_bytes,
                          stream>>>(tq, tk, tv, tdo, a);
  return (int)cudaGetLastError();
}

}  // namespace wg

}  // namespace

extern "C" {

// Dynamic shared memory of one thread block of the dq pass (pass 0) or the
// dk/dv pass (pass 1) at head dim D and dtype (0 float32, 1 bfloat16); 0
// if D > 128.
int flash_attention_bwd_smem_bytes(int D, int dtype, int pass) {
  if (D <= 0 || D > 128 || pass < 0 || pass > 1) return 0;
  if (dtype == typed_io::BF16) {
    if (D <= 64)
      return pass == 0 ? wg::smem_bytes<wg::DqSmem<1>>()
                       : wg::smem_bytes<wg::DkdvSmem<1>>();
    return pass == 0 ? wg::smem_bytes<wg::DqSmem<2>>()
                     : wg::smem_bytes<wg::DkdvSmem<2>>();
  }
  const int floats =
      D <= 64 ? (pass == 0 ? fma::dq_smem_floats<64>()
                           : fma::dkdv_smem_floats<64>())
              : (pass == 0 ? fma::dq_smem_floats<128>()
                           : fma::dkdv_smem_floats<128>());
  return floats * (int)sizeof(float);
}

// Floats of the `delta` scratch a launch needs: (B, H, Sq) on the FMA
// route, two (B, H, Sq rounded up to 64) arrays on the wgmma route.
long long flash_attention_bwd_scratch_floats(int B, int H, int Sq,
                                             int dtype) {
  if (dtype == typed_io::BF16)
    return 2LL * B * H * wg::padded_rows(Sq);
  return (long long)B * H * Sq;
}

// strides: 24 values, the (batch, sequence, head) strides in elements of q,
// k, v, out, dout, dq, dk and dv, in that order, the last dim of each
// contiguous. lse: the forward's (B, H, Sq) fp32; delta: fp32 scratch of
// flash_attention_bwd_scratch_floats(B, H, Sq, dtype) floats. dtype: 0
// float32 (the FMA route), 1 bfloat16 (the wgmma route: q, k, v and dout
// as TMA reads them, base addresses 16-byte aligned, D a
// multiple of 8, the strides of dimensions longer than 1 multiples of 8
// elements; dq, dk and dv 4-byte aligned rows), one for all eight tensors.
// Launches the three passes on `stream` and returns the status right after
// the launches (0 = launched); does not synchronise and allocates nothing.
int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                               const void* out, const void* dout,
                               const float* lse, float* delta, void* dq,
                               void* dk, void* dv, const long long* strides,
                               int B, int H, int G, int Sq, int Sk, int D,
                               int causal, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || G <= 0 || Sq <= 0 || Sk <= 0 || D <= 0 ||
      D > 128 || H % G != 0 || B > 65535 ||
      (long long)((Sq + fma::BQ - 1) / fma::BQ) * H > INT_MAX ||
      (long long)((Sk + fma::BK - 1) / fma::BK) * H > INT_MAX ||
      (long long)B * H * (Sq + 63) / (DELTA_THREADS / 32) >= INT_MAX)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = out;
  a.dout = dout;
  a.lse = lse;
  a.delta = delta;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  long long* dst[8] = {a.qs, a.ks, a.vs, a.os, a.dos, a.dqs, a.dks, a.dvs};
  for (int t = 0; t < 8; ++t)
    for (int i = 0; i < 3; ++i) dst[t][i] = strides[3 * t + i];
  a.B = B;
  a.H = H;
  a.Sq = Sq;
  a.Sk = Sk;
  a.G = G;
  a.D = D;
  a.causal = causal;
  a.scale = (float)(1.0 / sqrt((double)D));  // f32(1/sqrt(D))
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == typed_io::F32)
    return D <= 64 ? fma::launch<float, 64>(a, st)
                   : fma::launch<float, 128>(a, st);
  if (dtype == typed_io::BF16) {
    const uintptr_t outs = reinterpret_cast<uintptr_t>(dq) |
                           reinterpret_cast<uintptr_t>(dk) |
                           reinterpret_cast<uintptr_t>(dv);
    if (D % 8 != 0 || (outs & 3) != 0) return (int)cudaErrorInvalidValue;
    return D <= 64 ? wg::launch<1>(a, strides, st)
                   : wg::launch<2>(a, strides, st);
  }
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_bwd_error_string(int status) {
  if (status == hopper::NO_ENCODER)
    return "cuTensorMapEncodeTiled is not available from the driver";
  if (status >= hopper::ENCODE_FAILED)
    return "cuTensorMapEncodeTiled refused an operand's tensor map";
  return cudaGetErrorString((cudaError_t)status);
}

}  // extern "C"
