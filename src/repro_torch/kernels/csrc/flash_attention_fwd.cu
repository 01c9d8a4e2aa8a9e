// flash_attention_fwd: out = softmax(q k^T / sqrt(D) [causal mask]) v with
// an online softmax, the attention of the LM zoo's prefill.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:_kernel
// (called by flash_attention_fwd).
//
// The function: q (B, Sq, H, D), k and v (B, Sk, KH, D), H = KH * G; query
// head h reads kv head h / G (the reference's jnp.repeat(k, G, axis=2)),
// so the GQA repeat is never materialised. Each of q, k, v and out is read
// through its own (batch, sequence, head) strides in elements, with the
// last dim contiguous: the model's (B, S, H, D) projections and the
// reference's flattened (BH, S, D) layout (H = 1) are both taken as they
// are. Scores accumulate in fp32 and are scaled by 1/sqrt(D) after the dot;
// a causal mask (key j > query i, positions aligned at 0) sets -1e30, as
// the TPU kernel does; keys past Sk do not exist and take no part. p is
// rounded to v's type before the PV product (p.astype(v.dtype)); the sum
// l is taken of the unrounded p, clamped at 1e-30; out = acc / l in q's
// type. float32 and bfloat16, D <= 128.
//
// What bounds it on an H100: at Llama-3-8B's prefill (B 4, S 4096, H 32,
// D 128, bf16, causal) the unmasked half is 2*S^2*D flops per (b, h), 550
// GFLOP in all: 0.556 ms at 989 TFLOP/s of dense bf16 tensor-core work,
// against 537 MB of q, k, v and out, 0.160 ms at 3.35 TB/s: bound by
// operations. This kernel multiplies with fp32 FMA outside the tensor
// cores (67 TFLOP/s at most): it is simple and right first; tensor cores
// (mma.sync or wgmma), TMA and warp specialisation are later work.
//
// Design:
//   * one thread block of 256 threads per (64-row q tile, h, b); blockIdx.x
//     walks the q tiles from the last, so the heaviest causal tiles start
//     first;
//   * the q tile, one k (then v) tile of 64 keys and the 64 x 64 p tile sit
//     in shared memory as fp32, rows padded by one word against bank
//     conflicts (83 KB at D = 128: two blocks per SM);
//   * thread (ty, tx) of a 16 x 16 grid owns query rows ty + 16 i (i < 4),
//     key columns tx + 16 j of the score tile and output columns tx + 16 j
//     of its rows; the running max m, the sum l and the accumulator live in
//     its registers in fp32; a row's max and sum reduce over its 16 threads
//     with warp shuffles;
//   * under a causal mask the k tiles past the q tile's last row are fully
//     masked (p = exp(-1e30 - m) = 0, corr = 1) and are skipped, which is
//     exact; a ragged Sq or Sk is masked, not padded.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

#include "typed_io.cuh"

namespace {

using namespace typed_io;

constexpr int BQ = 64, BK = 64;
constexpr int TX = 16, TY = 16;
constexpr int THREADS = TX * TY;
constexpr int RQ = BQ / TY;  // query rows per thread (4)
constexpr int CK = BK / TX;  // key columns per thread (4)
constexpr int PLD = BK + 1;  // padded row of the p tile
constexpr float MASKED = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  // (batch, sequence, head) strides in elements of q, k, v, o
  long long qs[3], ks[3], vs[3], os[3];
  int Sq, Sk, G, D, causal;
  float scale;
};

template <int DT>
constexpr int smem_floats() {
  return 2 * BQ * (DT + 1) + BQ * PLD;  // q tile, k/v tile, p tile
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

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int DT>
__global__ void __launch_bounds__(THREADS, 2) flash_fwd_kernel(Args a) {
  constexpr int LD = DT + 1;
  constexpr int CD = DT / TX;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;             // [BQ][LD]
  float* KVs = Qs + BQ * LD;    // [BK][LD], k then v
  float* Ps = KVs + BK * LD;    // [BQ][PLD]

  const int n_qt = (a.Sq + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / a.G;
  const T* q = static_cast<const T*>(a.q) + b * a.qs[0] + h * a.qs[2];
  const T* k = static_cast<const T*>(a.k) + b * a.ks[0] + hk * a.ks[2];
  const T* v = static_cast<const T*>(a.v) + b * a.vs[0] + hk * a.vs[2];
  T* o = static_cast<T*>(a.o) + b * a.os[0] + h * a.os[2];
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;

  load_tile<T, DT>(Qs, q, a.qs[1], q0, a.Sq, a.D);

  float m[RQ], l[RQ], acc[RQ][CD];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = MASKED;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;
  }

  // under a causal mask, key tiles past the last query row are all masked
  const int k_end = a.causal ? min(a.Sk, q0 + BQ) : a.Sk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the last PV is done with KVs and Ps
    load_tile<T, DT>(KVs, k, a.ks[1], k0, a.Sk, a.D);
    __syncthreads();

    float s[RQ][CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DT; ++d) {
      float qv[RQ], kv[CK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) qv[i] = Qs[(ty + TY * i) * LD + d];
#pragma unroll
      for (int j = 0; j < CK; ++j) kv[j] = KVs[(tx + TX * j) * LD + d];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CK; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int qi = q0 + ty + TY * i;
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const int kj = k0 + tx + TX * j;
        float x = s[i][j] * a.scale;
        if (a.causal && qi < kj) x = MASKED;
        if (kj >= a.Sk) x = -INFINITY;  // no such key
        s[i][j] = x;
        mt = fmaxf(mt, x);
      }
      const float m_new = fmaxf(m[i], row_max16(mt));
      const float corr = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps += p;
        Ps[(ty + TY * i) * PLD + tx + TX * j] = round_to<T>(p);
      }
      l[i] = l[i] * corr + row_sum16(ps);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CD; ++c) acc[i][c] *= corr;
    }

    __syncthreads();  // every score read k; every p is in Ps
    load_tile<T, DT>(KVs, v, a.vs[1], k0, a.Sk, a.D);
    __syncthreads();

    const int n_keys = min(BK, a.Sk - k0);
#pragma unroll 4
    for (int kk = 0; kk < n_keys; ++kk) {
      float pv[RQ], vv[CD];
#pragma unroll
      for (int i = 0; i < RQ; ++i) pv[i] = Ps[(ty + TY * i) * PLD + kk];
#pragma unroll
      for (int c = 0; c < CD; ++c) vv[c] = KVs[kk * LD + tx + TX * c];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int c = 0; c < CD; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int qi = q0 + ty + TY * i;
    if (qi >= a.Sq) continue;
    const float li = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      const int d = tx + TX * c;
      if (d < a.D) store(o + (long long)qi * a.os[1] + d, acc[i][c] / li);
    }
  }
}

template <typename T, int DT>
int launch(const Args& a, int B, int H, cudaStream_t stream) {
  const int bytes = smem_floats<DT>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, DT><<<grid, THREADS, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory of one thread block for head dim D (0 if D > 128).
int flash_attention_fwd_smem_bytes(int D) {
  if (D <= 64) return smem_floats<64>() * (int)sizeof(float);
  if (D <= 128) return smem_floats<128>() * (int)sizeof(float);
  return 0;
}

// strides: 12 values, the (batch, sequence, head) strides in elements of
// q, k, v and out, in that order. dtype: 0 float32, 1 bfloat16 (q, k, v
// and out all of it). Launches on `stream` and returns the CUDA status
// right after the launch (0 = launched); does not synchronise and
// allocates nothing.
int flash_attention_fwd_launch(const void* q, const void* k, const void* v,
                               void* out, const long long* strides, int B,
                               int H, int G, int Sq, int Sk, int D,
                               int causal, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || G <= 0 || Sq <= 0 || Sk < 0 || D <= 0 || D > 128 ||
      H % G != 0 || B > 65535 || H > 65535 ||
      (Sq + BQ - 1) / BQ > INT_MAX / 2)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = out;
  for (int i = 0; i < 3; ++i) {
    a.qs[i] = strides[i];
    a.ks[i] = strides[3 + i];
    a.vs[i] = strides[6 + i];
    a.os[i] = strides[9 + i];
  }
  a.Sq = Sq;
  a.Sk = Sk;
  a.G = G;
  a.D = D;
  a.causal = causal;
  a.scale = (float)(1.0 / sqrt((double)D));  // the reference's f32(1/sqrt(D))
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == typed_io::F32)
    return D <= 64 ? launch<float, 64>(a, B, H, st)
                   : launch<float, 128>(a, B, H, st);
  if (dtype == typed_io::BF16)
    return D <= 64 ? launch<__nv_bfloat16, 64>(a, B, H, st)
                   : launch<__nv_bfloat16, 128>(a, B, H, st);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_fwd_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

}  // extern "C"
