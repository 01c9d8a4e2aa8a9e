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
// 3.35 TB/s. Its products (S dy, dS v, k~ dS and the two walks' rank-16
// updates, 6.7 GFLOP) would take 0.014 ms at the TF32 rate, its pairwise
// flops 0.016 ms at 67 TFLOP/s and its exponentials 0.026 ms on the SFUs:
// bound by bytes. But each head's chunks are a chain, 256 long, and the
// design below also moves each chunk's state and cotangent through device
// memory (2 x 168 MB written and read at that shape).
//
// Design (a first one, right before fast):
//   * pass 1, wkv6_bwd_walk: 2 B H blocks of 256 threads. Block hb < B H
//     walks head hb's chunks forward and writes the state at each chunk's
//     start to `states` (B H, n_chunks, K, V); block B H + hb walks them
//     backward from ds_out and writes dS at each chunk's end to `dstates`,
//     and the dS left after chunk 0 to ds0. Each element of the (K, V)
//     matrix evolves alone (its row's decay, a rank-16 update), so a thread
//     keeps K V / 256 of them in registers; the next chunk's rows are
//     loaded into registers while the current one is computed. This is the
//     reference's jax.checkpoint trade: keep the states between chunks;
//   * pass 2, wkv6_bwd_chunk: one block of 256 threads per (head, chunk),
//     B H n_chunks of them, all independent. It reads the chunk's rows and
//     its S and dS, forms A and G (one warp per pair of tokens, lanes over
//     K), then each thread takes one column k (or v) of 16 / (256 / K) rows
//     for dr, dk and dv, and one thread per column finishes dlw with a
//     16-row scan and writes the chunk's part of du;
//   * pass 3, wkv6_bwd_du: sums du's parts over the chunks (and over the
//     batch for a shared u) in a fixed order.
// Every product and sum is fp32 FMA from shared memory, nothing inside is
// rounded to bf16 (as in the forward), and no float atomic is used, so two
// launches give the same bits.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "typed_io.cuh"

namespace {

using namespace typed_io;

constexpr int L = 16;          // chunk length
constexpr int THREADS = 256;   // threads of a walk or chunk block

// four consecutive elements from global memory as floats (16-byte aligned
// for float, 8-byte for bfloat16)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void put4(float* p, float4 x) {
  p[0] = x.x, p[1] = x.y, p[2] = x.z, p[3] = x.w;
}

// Pass 1. Block hb < B H: the state walk of head hb, forward; block B H +
// hb: its cotangent walk, backward. `a` is k (state walk) or r, `x` is v
// or dy; each chunk the walk first records its matrix, then
//   state walk:      S  <- e^c_L S  + (k e^(c_L - c))^T v
//   cotangent walk:  dS <- e^c_L dS + (r e^ce)^T dy
template <typename T, int K>
__global__ void __launch_bounds__(THREADS)
wkv6_bwd_walk(const T* __restrict__ r, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dy,
              const float* __restrict__ lw, const float* __restrict__ s_in,
              const float* __restrict__ ds_in, float* __restrict__ states,
              float* __restrict__ dstates, float* __restrict__ ds0, int B,
              int S, int H, int nc) {
  constexpr int E = K * K / THREADS;        // matrix elements per thread
  constexpr int NV = L * K / 4;             // 4-element vectors per row set
  __shared__ __align__(16) float as[L][K];  // k or r, then decayed
  __shared__ __align__(16) float xs[L][K];  // v or dy
  __shared__ __align__(16) float ls[L][K];  // lw
  __shared__ float wl[K];                   // e^c_L
  const int heads = B * H;
  const bool cot = blockIdx.x >= heads;
  const int hb = cot ? blockIdx.x - heads : blockIdx.x;
  const int h = hb % H, b = hb / H, tid = threadIdx.x;
  const long long ss = (long long)H * K;    // token stride
  const long long head = (long long)b * S * ss + (long long)h * K;
  const long long mat = (long long)hb * K * K;
  const T* ag = cot ? r : k;
  const T* xg = cot ? dy : v;
  const float* init = cot ? ds_in : s_in;
  float* rec = (cot ? dstates : states) + (long long)hb * nc * K * K;

  float m[E];
#pragma unroll
  for (int e = 0; e < E; ++e)
    m[e] = init != nullptr ? init[mat + tid + THREADS * e] : 0.f;

  // this thread's vector of chunk c's rows (zeros past S)
  float4 pa, px, pl;
  auto fetch = [&](int c) {
    pa = px = pl = make_float4(0.f, 0.f, 0.f, 0.f);
    if (tid < NV) {
      const int row = tid / (K / 4), col = (tid % (K / 4)) * 4;
      const int t = c * L + row;
      if (t < S) {
        const long long at = head + (long long)t * ss + col;
        pa = load4(ag + at);
        px = load4(xg + at);
        pl = load4(lw + at);
      }
    }
  };
  fetch(cot ? nc - 1 : 0);
  for (int it = 0; it < nc; ++it) {
    const int c = cot ? nc - 1 - it : it;
    if (tid < NV) {
      const int row = tid / (K / 4), col = (tid % (K / 4)) * 4;
      put4(&as[row][col], pa);
      put4(&xs[row][col], px);
      put4(&ls[row][col], pl);
    }
    if (it + 1 < nc) fetch(cot ? c - 1 : c + 1);   // in flight meanwhile
#pragma unroll
    for (int e = 0; e < E; ++e)
      rec[(long long)c * K * K + tid + THREADS * e] = m[e];
    __syncthreads();
    if (tid < K) {
      float cum[L];
      float cs = 0.f;
#pragma unroll
      for (int t = 0; t < L; ++t) {
        const float ce = cs;
        cs += ls[t][tid];
        cum[t] = cot ? ce : cs;
      }
      wl[tid] = expf(cs);
#pragma unroll
      for (int t = 0; t < L; ++t)
        as[t][tid] *= expf(cot ? cum[t] : cs - cum[t]);
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int idx = tid + THREADS * e, row = idx / K, col = idx % K;
      float acc = wl[row] * m[e];
#pragma unroll
      for (int t = 0; t < L; ++t) acc = fmaf(as[t][row], xs[t][col], acc);
      m[e] = acc;
    }
    __syncthreads();
  }
  if (cot && ds0 != nullptr) {
#pragma unroll
    for (int e = 0; e < E; ++e) ds0[mat + tid + THREADS * e] = m[e];
  }
}

// shared memory of a pass-2 block, in floats: r, k, v, dy, c, ce, k
// e^(c_L - c), P = r dr', Q = k dk', QS = k (dk's state part) [L][K]; S and
// dS [K][K + 1]; A and G [L][L + 1]; u and e^c_L [K]
template <int K>
struct ChunkLayout {
  static constexpr int KP = K + 1, LP = L + 1;
  static constexpr int FLOATS = 10 * L * K + 2 * K * KP + 2 * L * LP + 2 * K;
  static constexpr int BYTES = 4 * FLOATS;
};

// Pass 2: chunk c of head hb, from the state at its start (states) and
// the cotangent at its end (dstates).
template <typename T, int K>
__global__ void __launch_bounds__(THREADS)
wkv6_bwd_chunk(const T* __restrict__ r, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dy,
               const float* __restrict__ lw, const T* __restrict__ u,
               const float* __restrict__ states,
               const float* __restrict__ dstates, T* __restrict__ dr,
               T* __restrict__ dk, T* __restrict__ dv,
               float* __restrict__ dlw, float* __restrict__ du_part, int S,
               int H, int nc, long long u_sb) {
  using Lay = ChunkLayout<K>;
  constexpr int KP = Lay::KP, LP = Lay::LP;
  constexpr int NV = L * K / 4;
  constexpr int GROUPS = THREADS / K;       // row groups of a column
  constexpr int RPT = L / GROUPS;           // rows per thread
  extern __shared__ __align__(16) float sm[];
  float* rs = sm;
  float* ks = rs + L * K;
  float* vs = ks + L * K;
  float* dys = vs + L * K;
  float* cs = dys + L * K;
  float* ces = cs + L * K;
  float* kd = ces + L * K;
  float* P = kd + L * K;
  float* Q = P + L * K;
  float* QS = Q + L * K;
  float* Sm = QS + L * K;
  float* dSm = Sm + K * KP;
  float* A = dSm + K * KP;
  float* Gm = A + L * LP;
  float* us = Gm + L * LP;
  float* wl = us + K;

  const int c = blockIdx.x % nc, hb = blockIdx.x / nc;
  const int h = hb % H, b = hb / H, tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const long long ss = (long long)H * K;
  const long long head = (long long)b * S * ss + (long long)h * K;
  const long long mat = ((long long)hb * nc + c) * K * K;

  for (int e = tid; e < NV; e += THREADS) {
    const int row = e / (K / 4), col = (e % (K / 4)) * 4;
    const int t = c * L + row;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), bb = a, cc = a, d = a,
           l = a;
    if (t < S) {
      const long long at = head + (long long)t * ss + col;
      a = load4(r + at);
      bb = load4(k + at);
      cc = load4(v + at);
      d = load4(dy + at);
      l = load4(lw + at);
    }
    put4(rs + row * K + col, a);
    put4(ks + row * K + col, bb);
    put4(vs + row * K + col, cc);
    put4(dys + row * K + col, d);
    put4(cs + row * K + col, l);   // lw until the cumsum below
  }
  for (int e = tid; e < K * K; e += THREADS) {
    Sm[(e / K) * KP + e % K] = states[mat + e];
    dSm[(e / K) * KP + e % K] = dstates[mat + e];
  }
  for (int e = tid; e < K; e += THREADS)
    us[e] = load(u + b * u_sb + h * K + e);
  __syncthreads();

  if (tid < K) {   // cumsums, e^c_L and k e^(c_L - c), column tid
    float cum = 0.f;
#pragma unroll
    for (int t = 0; t < L; ++t) {
      ces[t * K + tid] = cum;
      cum += cs[t * K + tid];
      cs[t * K + tid] = cum;
    }
    wl[tid] = expf(cum);
#pragma unroll
    for (int t = 0; t < L; ++t)
      kd[t * K + tid] = ks[t * K + tid] * expf(cum - cs[t * K + tid]);
  }
  __syncthreads();

  // A_tj (j < t; the bonus b_t at j = t) and G_tj (j <= t): one warp per
  // pair, its lanes over K
  for (int p = warp; p < L * (L + 1) / 2; p += THREADS / 32) {
    int t = 0;
    while ((t + 1) * (t + 2) / 2 <= p) ++t;
    const int j = p - t * (t + 1) / 2;
    float a = 0.f, g = 0.f;
    for (int q = lane; q < K; q += 32) {
      const float rk = rs[t * K + q] * ks[j * K + q];
      a += j < t ? rk * expf(ces[t * K + q] - cs[j * K + q]) : rk * us[q];
      g = fmaf(dys[t * K + q], vs[j * K + q], g);
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {
      a += __shfl_xor_sync(0xffffffffu, a, off);
      g += __shfl_xor_sync(0xffffffffu, g, off);
    }
    if (lane == 0) {
      A[t * LP + j] = a;
      Gm[t * LP + j] = g;
    }
  }
  __syncthreads();

  // dr, dk, dv: column `col`, rows grp, grp + GROUPS, ...
  {
    const int col = tid % K, grp = tid / K;
    float sdy[RPT], dsv[RPT], kds[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) sdy[i] = dsv[i] = kds[i] = 0.f;
    for (int q = 0; q < K; ++q) {
      const float s_cq = Sm[col * KP + q];     // S[col][q]
      const float ds_cq = dSm[col * KP + q];   // dS[col][q]
      const float ds_qc = dSm[q * KP + col];   // dS[q][col]
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int t = grp + GROUPS * i;
        sdy[i] = fmaf(s_cq, dys[t * K + q], sdy[i]);
        dsv[i] = fmaf(ds_cq, vs[t * K + q], dsv[i]);
        kds[i] = fmaf(kd[t * K + q], ds_qc, kds[i]);
      }
    }
    const float uc = us[col], c_last = cs[(L - 1) * K + col];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int t = grp + GROUPS * i;
      const float ce_t = ces[t * K + col], c_t = cs[t * K + col];
      // dr'_t: the state's part and the pairs j < t
      float drp = expf(ce_t) * sdy[i];
      for (int j = 0; j < t; ++j)
        drp = fmaf(Gm[t * LP + j] * ks[j * K + col],
                   expf(ce_t - cs[j * K + col]), drp);
      // dk'_t: the pairs t2 > t and the state's part
      const float st = expf(c_last - c_t) * dsv[i];
      float dkp = st;
      for (int t2 = t + 1; t2 < L; ++t2)
        dkp = fmaf(Gm[t2 * LP + t] * rs[t2 * K + col],
                   expf(ces[t2 * K + col] - c_t), dkp);
      // dv_t (column col as v): the pairs t2 > t, the bonus, the state
      float dvv = kds[i];
      for (int t2 = t + 1; t2 < L; ++t2)
        dvv = fmaf(A[t2 * LP + t], dys[t2 * K + col], dvv);
      dvv = fmaf(A[t * LP + t], dys[t * K + col], dvv);
      const float gd = Gm[t * LP + t];
      P[t * K + col] = rs[t * K + col] * drp;
      Q[t * K + col] = ks[t * K + col] * dkp;
      QS[t * K + col] = ks[t * K + col] * st;
      if (c * L + t < S) {
        const long long at = head + (long long)(c * L + t) * ss + col;
        store(dr + at, fmaf(gd * uc, ks[t * K + col], drp));
        store(dk + at, fmaf(gd * uc, rs[t * K + col], dkp));
        store(dv + at, dvv);
      }
    }
  }
  __syncthreads();

  if (tid < K) {   // dlw and du's part, column tid
    float end = 0.f;
    for (int q = 0; q < K; ++q)
      end = fmaf(dSm[tid * KP + q], Sm[tid * KP + q], end);
    end *= wl[tid];
    float dsum = 0.f;
#pragma unroll
    for (int t = 0; t < L; ++t) {
      end += QS[t * K + tid];
      dsum = fmaf(Gm[t * LP + t] * rs[t * K + tid], ks[t * K + tid], dsum);
    }
    du_part[((long long)hb * nc + c) * K + tid] = dsum;
    float after = 0.f, upto = 0.f;
#pragma unroll
    for (int t = L - 1; t >= 0; --t) {
      upto += Q[t * K + tid];
      if (c * L + t < S)
        dlw[head + (long long)(c * L + t) * ss + tid] = after - upto + end;
      after += P[t * K + tid];
    }
  }
}

// Pass 3: du = the parts summed over the chunks, in order, and over the
// batch too when u is shared (u_sb = 0): one block per output row of K.
__global__ void wkv6_bwd_du(const float* __restrict__ du_part,
                            float* __restrict__ du, int B, int H, int nc,
                            int K, int shared) {
  const int row = blockIdx.x, q = threadIdx.x;
  const int b0 = shared ? 0 : row / H, b1 = shared ? B : b0 + 1;
  const int h = row % H;
  float acc = 0.f;
  for (int b = b0; b < b1; ++b)
    for (int c = 0; c < nc; ++c)
      acc += du_part[(((long long)b * H + h) * nc + c) * K + q];
  du[(long long)row * K + q] = acc;
}

template <typename T, int K>
int launch(const void* r, const void* k, const void* v, const float* lw,
           const void* u, const float* s_in, const void* dy,
           const float* ds_in, void* dr, void* dk, void* dv, float* dlw,
           float* du, float* ds0, float* states, float* dstates,
           float* du_part, int B, int S, int H, long long u_sb,
           cudaStream_t stream) {
  const int nc = (S + L - 1) / L;
  const int heads = B * H;
  const T* rt = static_cast<const T*>(r);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dyt = static_cast<const T*>(dy);
  wkv6_bwd_walk<T, K><<<2 * heads, THREADS, 0, stream>>>(
      rt, kt, vt, dyt, lw, s_in, ds_in, states, dstates, ds0, B, S, H, nc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int bytes = ChunkLayout<K>::BYTES;
  err = cudaFuncSetAttribute(wkv6_bwd_chunk<T, K>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return (int)err;
  wkv6_bwd_chunk<T, K><<<(unsigned)((long long)heads * nc), THREADS, bytes,
                         stream>>>(
      rt, kt, vt, dyt, lw, static_cast<const T*>(u), states, dstates,
      static_cast<T*>(dr), static_cast<T*>(dk), static_cast<T*>(dv), dlw,
      du_part, S, H, nc, u_sb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  wkv6_bwd_du<<<u_sb == 0 ? H : heads, K, 0, stream>>>(du_part, du, B, H, nc,
                                                       K, u_sb == 0);
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

}  // namespace

extern "C" {

// Dynamic shared memory of one pass-2 block (-1 for a K it does not take).
int wkv6_chunk_bwd_smem_bytes(int K) {
  switch (K) {
    case 16: return ChunkLayout<16>::BYTES;
    case 32: return ChunkLayout<32>::BYTES;
    case 64: return ChunkLayout<64>::BYTES;
    default: return -1;
  }
}

// r, k, v, dy, lw and dr, dk, dv, dlw: (B, S, H, K) contiguous, r, k, v,
// dy and lw 16-byte aligned; u: (H, K) when u_sb is 0, else (B, H, K)
// with u_sb = H * K; s_in and ds_in (each may be null: zeros), ds0 (may be
// null: not written): (B, H, K, K) float32; du: (H, K) or (B, H, K)
// float32, like u; scratch: B H n_chunks K (2 K + 1) floats (the states
// and the cotangents at each chunk's boundary, then du's parts). K is
// 16, 32 or 64. dtype: 0 float32, 1 bfloat16 (r, k, v, u, dy, dr, dk,
// dv). Launches its three kernels on `stream` and returns the CUDA status
// after the last (0 = launched); does not synchronise and allocates
// nothing.
int wkv6_chunk_bwd_launch(const void* r, const void* k, const void* v,
                          const float* lw, const void* u, const float* s_in,
                          const void* dy, const float* ds_in, void* dr,
                          void* dk, void* dv, float* dlw, float* du,
                          float* ds0, float* scratch, int B, int S, int H,
                          int K, long long u_sb, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || (long long)B * H > INT_MAX / 2
      || (long long)B * H * ((S + L - 1) / L) > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const uintptr_t a = reinterpret_cast<uintptr_t>(r)
                      | reinterpret_cast<uintptr_t>(k)
                      | reinterpret_cast<uintptr_t>(v)
                      | reinterpret_cast<uintptr_t>(dy)
                      | reinterpret_cast<uintptr_t>(lw);
  if ((a & 15) != 0) return (int)cudaErrorMisalignedAddress;
  const long long mats = (long long)B * H * ((S + L - 1) / L) * K * K;
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
