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
// operands (5.1 ms at the 67 TFLOP/s of fp32 FMA work, where this design
// runs them), against 168 MB of operands, lse and gradients (0.050 ms at 3.35
// TB/s). It is bound by operations. This first design keeps every product
// on fp32 FMA from shared-memory tiles (the forward's FMA route); tensor
// cores, TMA and wgmma are a later redesign:
//   * flash_bwd_delta: one warp a (b, h, query) row;
//   * flash_bwd_dkdv: one thread block of 256 threads per (64-key tile, kv
//     head, b), the heaviest causal tiles (the first keys) first. The k and
//     v tiles stay in shared memory; the block walks the G query heads of
//     the kv head and, for each, the 64-row q tiles from the diagonal on
//     (the tiles before it are fully masked, p = 0, and are skipped, which
//     is exact). Per q tile it loads q, dout, lse and delta, forms s and dp
//     (thread (ty, tx) of a 16 x 16 grid owns query rows ty + 16 i and keys
//     tx + 16 j), writes p and ds rounded to shared memory, and adds p^T
//     dout and ds^T q into its registers (key rows ty + 16 i, head columns
//     tx + 16 c) in fp32;
//   * flash_bwd_dq: one thread block per (64-row q tile, h, b), the heaviest
//     causal tiles (the last queries) first, walks the k tiles up to the
//     diagonal and adds ds k into its registers. It recomputes s and dp with
//     the dkdv pass's arithmetic in the same order, so both passes see the
//     same ds bits. The two passes redo s and dp (7 products a pair where
//     the function needs 5): the price of writing dq without atomics.
// Tiles are fp32 in shared memory, rows padded by one word against bank
// conflicts: 162 KB (dkdv) and 146 KB (dq) at D = 128, one block an SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>

#include "typed_io.cuh"

namespace {

using namespace typed_io;

constexpr int BQ = 64, BK = 64;
constexpr int TX = 16, TY = 16;
constexpr int THREADS = TX * TY;
constexpr int R = BQ / TY;      // query (or key) rows per thread (4)
constexpr int C = BK / TX;      // key columns per thread (4)
constexpr int PLD = BK + 1;     // padded row of a p or ds tile
constexpr float MASKED = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;  // (B, H, Sq)
  float* delta;      // (B, H, Sq)
  void* dq;
  void* dk;
  void* dv;
  // (batch, sequence, head) strides in elements of q, k, v, o, dout, dq,
  // dk, dv
  long long qs[3], ks[3], vs[3], os[3], dos[3], dqs[3], dks[3], dvs[3];
  int B, H, Sq, Sk, G, D, causal;
  float scale;
};

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
__global__ void __launch_bounds__(THREADS) flash_bwd_delta(Args a) {
  const long long row =
      (long long)blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
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
  flash_bwd_delta<T><<<(unsigned)((rows + THREADS / 32 - 1) / (THREADS / 32)),
                       THREADS, 0, stream>>>(a);
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

}  // namespace

extern "C" {

// Dynamic shared memory of one thread block of the dk/dv pass (the larger
// of the two) at head dim D; 0 if D > 128.
int flash_attention_bwd_smem_bytes(int D) {
  if (D <= 0 || D > 128) return 0;
  return (D <= 64 ? dkdv_smem_floats<64>() : dkdv_smem_floats<128>()) *
         (int)sizeof(float);
}

// strides: 24 values, the (batch, sequence, head) strides in elements of q,
// k, v, out, dout, dq, dk and dv, in that order, the last dim of each
// contiguous. lse: the forward's (B, H, Sq) fp32; delta: (B, H, Sq) fp32
// scratch. dtype: 0 float32, 1 bfloat16, one for all eight tensors.
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
      (long long)((Sq + BQ - 1) / BQ) * H > INT_MAX ||
      (long long)B * H * Sq / (THREADS / 32) >= INT_MAX)
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
    return D <= 64 ? launch<float, 64>(a, st) : launch<float, 128>(a, st);
  if (dtype == typed_io::BF16)
    return D <= 64 ? launch<__nv_bfloat16, 64>(a, st)
                   : launch<__nv_bfloat16, 128>(a, st);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_bwd_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

}  // extern "C"
