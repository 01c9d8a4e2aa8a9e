// update_mlp: out = act(x @ w + b), the GNN layers' update stage.
//
// Replaces the Pallas TPU kernel src/repro/kernels/update_mlp.py:_kernel
// (called by update_mlp; its epilogue is update_epilogue).
//
// Inputs: x (M, K) f32, w (K, N) f32, both row-major; b (N,) f32;
// act 0 none, 1 relu, 2 the tanh-form gelu (activation.cuh, the same code
// the fused kernels apply). Output: out (M, N) f32. Any M, K and N.
//
// What bounds it on an H100: 2*M*K*N flops against (M*K + K*N + M*N) * 4
// bytes. At the paper's layer-0 update (26,624 x 602 @ 602 x 128) that is
// 4.10 GFLOP, 61 us at the published 67 TFLOP/s of fp32 outside the tensor
// cores, against 77 MB, 23 us at 3.35 TB/s: bound by operations.
//
// Design (a register-tiled fp32 GEMM, simple and right; tensor cores are
// later work):
//   * one thread block per 128 x 128 output tile; 256 threads as a 16 x 16
//     grid, thread (ty, tx) holding rows ty*8 .. ty*8+7 and columns
//     tx*4 .. tx*4+3 and 64+tx*4 .. 64+tx*4+3 in registers (64 fp32
//     accumulators);
//   * K runs in chunks of BK = 16: the x chunk is staged transposed in
//     shared memory (rows padded to 132 floats, so each thread's 8 rows
//     load as two float4), the w chunk as it is;
//   * plain fp32 FMA, no TF32, each output summing over K in order;
//   * edges masked: out-of-range x and w elements load as zeros, stores
//     past M and N are skipped; the bias and activation are applied in the
//     epilogue, as the TPU kernel does on its last K step.

#include <climits>
#include <cuda_runtime.h>

#include "activation.cuh"

namespace {

using namespace activation;

constexpr int BM = 128, BN = 128, BK = 16;
constexpr int TX = 16, TY = 16;
constexpr int THREADS = TX * TY;
constexpr int TM = BM / TY;       // rows per thread (8)
constexpr int TN = BN / TX;       // columns per thread (8), in two halves
constexpr int XS_LD = BM + 4;     // padded row of the transposed x chunk

__global__ void __launch_bounds__(THREADS, 2)
update_mlp_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ b, float* __restrict__ out,
                  int M, int K, int N, int act) {
  __shared__ __align__(16) float Xs[BK][XS_LD];   // Xs[kk][m] = x[m][k0+kk]
  __shared__ __align__(16) float Ws[BK][BN];

  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;

  float acc[TM][TN];
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[m][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = threadIdx.x; e < BM * BK; e += THREADS) {
      const int mm = e / BK, kk = e % BK;
      const long long row = m0 + mm;
      const int k = k0 + kk;
      Xs[kk][mm] = (row < M && k < K) ? x[row * K + k] : 0.f;
    }
    for (int e = threadIdx.x; e < BK * BN; e += THREADS) {
      const int kk = e / BN, n = n0 + e % BN;
      const int k = k0 + kk;
      Ws[kk][e % BN] = (k < K && n < N) ? w[(long long)k * N + n] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&Xs[kk][ty * TM]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&Xs[kk][ty * TM + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Ws[kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Ws[kk][BN / 2 + tx * 4]);
      const float av[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[TN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int m = 0; m < TM; ++m)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[m][j] = fmaf(av[m], bv[j], acc[m][j]);
    }
    __syncthreads();  // every thread is done with Xs and Ws
  }

#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const long long row = m0 + ty * TM + m;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + (j < 4 ? tx * 4 + j : BN / 2 + tx * 4 + j - 4);
      if (n >= N) continue;
      out[row * N + n] = act_apply(acc[m][j] + b[n], act);
    }
  }
}

}  // namespace

extern "C" {

// Launches on `stream`; returns the CUDA status right after the launch
// (0 = launched). Does not synchronise and allocates nothing.
int update_mlp_launch(const float* x, const float* w, const float* b,
                      float* out, int M, int K, int N, int act,
                      void* stream) {
  const long long grid_m = ((long long)M + BM - 1) / BM;
  const int grid_n = (N + BN - 1) / BN;
  if (grid_m <= 0 || grid_m > INT_MAX || grid_n <= 0 || grid_n > 65535)
    return (int)cudaErrorInvalidConfiguration;
  update_mlp_kernel<<<dim3((unsigned)grid_m, grid_n), THREADS, 0,
                      (cudaStream_t)stream>>>(x, w, b, out, M, K, N, act);
  return (int)cudaGetLastError();
}

const char* update_mlp_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

}  // extern "C"
