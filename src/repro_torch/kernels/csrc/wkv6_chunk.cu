// wkv6_chunk: the RWKV-6 (Finch) WKV recurrence in chunks of 16 tokens,
// the time-mix core of RWKV-6's prefill.
//
// Replaces the Pallas TPU kernel src/repro/kernels/wkv6.py:_kernel (called
// by wkv6_chunk).
//
// The function, per (batch b, head h), with K = V = head size:
//     y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
//     S_t = diag(exp(lw_t)) S_{t-1} + k_t v_t^T
// r, k, v (B, S, H, K) in float32 or bfloat16, lw (B, S, H, K) float32
// log-decays (<= 0), u (H, K) or (B, H, K) in r's type; the (K, V) state is
// float32, read from s_in (zeros when s_in is null: prefill) and written
// to s_out after the last token, which the TPU kernel keeps in VMEM and
// drops (the model's decode needs it). y (B, S, H, V) in r's type. Every
// tensor contiguous. Inside a chunk of L = 16 tokens, with c the inclusive
// cumsum of lw and c_excl = c - lw:
//     y_t = (r_t exp(c_excl_t)) S + sum_{j<t} A_tj v_j + (r_t u k_t) v_t,
//     A_tj = sum_k r_tk k_jk exp(c_excl_tk - c_jk)          (j < t only:
//            every exponent is <= 0, so no mask is needed),
//     S <- exp(c_last) S + (k exp(c_last - c))^T v.
// A ragged last chunk loads zeros past S (lw = 0, k = v = 0), which
// changes neither y nor the state; the TPU wrapper instead shrinks L to a
// divisor of S. The result does not depend on L beyond rounding.
//
// What bounds it on an H100: at RWKV-6-3B's prefill (B 4, S 4096, H 40,
// K = V = 64) the kernel moves r, k, v and y in bf16 and lw in fp32, 506 MB
// in all (0.151 ms at 3.35 TB/s), and does about 330 kFLOP per chunk per
// (b, h), 13.5 GFLOP (0.20 ms at the 67 TFLOP/s of fp32 outside the tensor
// cores), plus 7,680 + 3,072 exponentials per chunk per (b, h): bound by
// operations, and by the exponentials' throughput before the FMAs. The
// chunks of one head run in order; the parallelism is across heads and
// across the state's V columns.
//
// Design (simple and right first):
//   * one thread block of 128 threads per (V-column group of 16, h, b): the
//     state's V columns are independent given a chunk's A, so at the 3B
//     shape 160 heads become 640 blocks on 132 SMs; every block of a head
//     recomputes that head's cumsums and A;
//   * the block's (K, 16) slice of the state stays in shared memory in fp32
//     across the S / 16 chunks, walked in order;
//   * per chunk: load r, k, lw and the block's v columns into shared memory
//     (fp32, rows padded by one word); 64 threads take the cumsums and the
//     decayed rows r exp(c_excl) and k exp(c_last - c); 120 threads take one
//     pair (t, j < t) of A each and 16 the diagonal bonus r_t u k_t; 128
//     threads take two outputs y_t[v] each; then every thread updates 8
//     state elements.

#include <cuda_runtime.h>

#include "typed_io.cuh"

namespace {

using namespace typed_io;

constexpr int L = 16;                    // chunk length
constexpr int NP = L * (L - 1) / 2;      // pairs j < t
constexpr int THREADS = 128;

template <int K>
__host__ __device__ constexpr int group_cols() { return K < 16 ? K : 16; }

template <typename T, int K>
__global__ void __launch_bounds__(THREADS)
wkv6_chunk_kernel(const T* __restrict__ r, const T* __restrict__ k,
                  const T* __restrict__ v, const float* __restrict__ lw,
                  const T* __restrict__ u, const float* __restrict__ s_in,
                  T* __restrict__ y, float* __restrict__ s_out, int S, int H,
                  long long u_sb) {
  constexpr int VG = group_cols<K>();
  constexpr int KP = K + 1;
  __shared__ float rs[L][KP], ks[L][KP], cs[L][KP], ce[L][KP];
  __shared__ float rd[L][KP], kd[L][KP];   // r exp(c_excl), k exp(c_last - c)
  __shared__ float vs[L][VG];
  __shared__ float A[L][L + 1];
  __shared__ float bonus[L];
  __shared__ float wl[K];                  // exp(c_last)
  __shared__ float us[K];
  __shared__ float St[K][VG];              // this block's state columns

  const int v0 = blockIdx.x * VG, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const long long ss = (long long)H * K;   // token stride
  const long long head = (long long)b * S * ss + (long long)h * K;
  const long long st = ((long long)b * H + h) * K * K;  // state (K, V)

  for (int e = tid; e < K; e += THREADS)
    us[e] = load(u + b * u_sb + h * K + e);
  for (int e = tid; e < K * VG; e += THREADS) {
    const int kk = e / VG, j = e % VG;
    St[kk][j] = s_in ? s_in[st + (long long)kk * K + v0 + j] : 0.f;
  }

  for (int t0 = 0; t0 < S; t0 += L) {
    for (int e = tid; e < L * K; e += THREADS) {
      const int t = e / K, kk = e % K;
      const bool ok = t0 + t < S;
      const long long at = head + (long long)(t0 + t) * ss + kk;
      rs[t][kk] = ok ? load(r + at) : 0.f;
      ks[t][kk] = ok ? load(k + at) : 0.f;
      ce[t][kk] = ok ? lw[at] : 0.f;       // lw for now
    }
    for (int e = tid; e < L * VG; e += THREADS) {
      const int t = e / VG, j = e % VG;
      vs[t][j] = t0 + t < S
                     ? load(v + head + (long long)(t0 + t) * ss + v0 + j)
                     : 0.f;
    }
    __syncthreads();

    if (tid < K) {
      float c = 0.f;
      for (int t = 0; t < L; ++t) {
        const float lwt = ce[t][tid];
        c += lwt;
        cs[t][tid] = c;
        ce[t][tid] = c - lwt;
        rd[t][tid] = rs[t][tid] * expf(c - lwt);
      }
      wl[tid] = expf(c);
      for (int t = 0; t < L; ++t)
        kd[t][tid] = ks[t][tid] * expf(c - cs[t][tid]);
    }
    __syncthreads();

    for (int w = tid; w < NP + L; w += THREADS) {
      if (w < NP) {
        int t = 1, j = w;
        while (j >= t) j -= t++;
        float a = 0.f;
        for (int kk = 0; kk < K; ++kk)
          a = fmaf(rs[t][kk] * ks[j][kk], expf(ce[t][kk] - cs[j][kk]), a);
        A[t][j] = a;
      } else {
        const int t = w - NP;
        float a = 0.f;
        for (int kk = 0; kk < K; ++kk)
          a = fmaf(rs[t][kk] * us[kk], ks[t][kk], a);
        bonus[t] = a;
      }
    }
    __syncthreads();

    for (int e = tid; e < L * VG; e += THREADS) {
      const int t = e / VG, j = e % VG;
      float inter = 0.f, intra = 0.f;
      for (int kk = 0; kk < K; ++kk) inter = fmaf(rd[t][kk], St[kk][j], inter);
      for (int i = 0; i < t; ++i) intra = fmaf(A[t][i], vs[i][j], intra);
      if (t0 + t < S)
        store(y + head + (long long)(t0 + t) * ss + v0 + j,
              (inter + intra) + bonus[t] * vs[t][j]);
    }
    __syncthreads();

    for (int e = tid; e < K * VG; e += THREADS) {
      const int kk = e / VG, j = e % VG;
      float add = 0.f;
      for (int t = 0; t < L; ++t) add = fmaf(kd[t][kk], vs[t][j], add);
      St[kk][j] = wl[kk] * St[kk][j] + add;
    }
    __syncthreads();
  }

  for (int e = tid; e < K * VG; e += THREADS) {
    const int kk = e / VG, j = e % VG;
    s_out[st + (long long)kk * K + v0 + j] = St[kk][j];
  }
}

template <typename T, int K>
int launch(const void* r, const void* k, const void* v, const float* lw,
           const void* u, const float* s_in, void* y, float* s_out, int B,
           int S, int H, long long u_sb, cudaStream_t stream) {
  const dim3 grid(K / group_cols<K>(), H, B);
  wkv6_chunk_kernel<T, K><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), lw, static_cast<const T*>(u), s_in,
      static_cast<T*>(y), s_out, S, H, u_sb);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_k(int K, const void* r, const void* k, const void* v,
             const float* lw, const void* u, const float* s_in, void* y,
             float* s_out, int B, int S, int H, long long u_sb,
             cudaStream_t st) {
  switch (K) {
    case 16:
      return launch<T, 16>(r, k, v, lw, u, s_in, y, s_out, B, S, H, u_sb, st);
    case 32:
      return launch<T, 32>(r, k, v, lw, u, s_in, y, s_out, B, S, H, u_sb, st);
    case 64:
      return launch<T, 64>(r, k, v, lw, u, s_in, y, s_out, B, S, H, u_sb, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// r, k, v, lw and y: (B, S, H, K) contiguous; u: (H, K) when u_sb is 0,
// else (B, H, K) with u_sb = H * K; s_in (may be null: zeros) and s_out:
// (B, H, K, K) float32. K is 16, 32 or 64. dtype: 0 float32, 1 bfloat16
// (r, k, v, u and y). Launches on `stream` and returns the CUDA status
// right after the launch (0 = launched); does not synchronise and
// allocates nothing.
int wkv6_chunk_launch(const void* r, const void* k, const void* v,
                      const float* lw, const void* u, const float* s_in,
                      void* y, float* s_out, int B, int S, int H, int K,
                      long long u_sb, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == typed_io::F32)
    return launch_k<float>(K, r, k, v, lw, u, s_in, y, s_out, B, S, H, u_sb,
                           st);
  if (dtype == typed_io::BF16)
    return launch_k<__nv_bfloat16>(K, r, k, v, lw, u, s_in, y, s_out, B, S, H,
                                   u_sb, st);
  return (int)cudaErrorInvalidValue;
}

const char* wkv6_chunk_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

}  // extern "C"
