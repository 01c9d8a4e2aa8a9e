// update_mlp: out = act(x @ w + b), the GNN layers' update stage.
//
// Replaces the Pallas TPU kernel src/repro/kernels/update_mlp.py:_kernel
// (called by update_mlp; its epilogue is update_epilogue).
//
// Inputs: x (M, K) f32, w (K, N) f32, both row-major; b (N,) f32;
// act 0 none, 1 relu, 2 the tanh-form gelu (activation.cuh, the same code
// the fused kernels apply). Output: out (M, N) f32. Any M, K and N.
//
// What bounds it on an H100: 2*M*K*N flops against (M*K + K*N + N + M*N)
// * 4 bytes. At the paper's layer-0 update (26,624 x 602 @ 602 x 128) that
// is 4.10 GFLOP, 8.3 us at the 495 TFLOP/s of TF32 tensor-core work (the
// fastest the card multiplies fp32 inputs), against 78 MB, 23 us at 3.35
// TB/s: bound by bytes. The 3xTF32 split does three TF32 products per
// product, so on mma.sync the kernel's own ceiling is below that rate.
//
// Design:
//   * the products run on the tensor cores as mma.sync m16n8k8 TF32 with
//     the 3xTF32 split of mma_tf32.cuh (each step of 8 terms sums its three
//     products from zero, then joins the fp32 accumulator by a rounded
//     add), which keeps fp32's accuracy;
//   * two tile shapes, chosen by the wrapper from the output's size
//     (kernels/update_mlp.py: plan): BIG, 64 x 128 tiles for 4 warps each
//     owning 32 x 64, so the layer-0 shape runs 416 thread blocks, all
//     resident at once (4 per SM by shared memory and registers), instead
//     of 208 of 128 x 128 of which 76 SMs ran two in series; SMALL, 16 x 64
//     tiles for 4 warps of 16 x 16, so the layer-1 shape (1,024 x 41) runs
//     64 blocks instead of 8. At the layer-0 shape, 64 x 128 tiles for 8
//     warps (two or three stages), 64 x 64 and 32 x 128 tiles all ran as
//     fast as BIG or slower, and 16 x 64 tiles clearly slower;
//   * K runs in chunks of BK = 32 staged with cp.async in a ring (2 stages
//     for BIG, 3 for SMALL), the next chunk's copies in flight under this
//     one's products; rows padded (BK + 4, BN + 8 floats) so the fragment
//     loads meet no bank conflict;
//   * x's rows are K * 4 bytes apart, only 8-byte aligned at K = 602: the
//     copies take V = 4, 2 or 1 floats as K, N and the bases allow (the
//     launcher picks the widest), never a 16-byte copy of a misaligned
//     row;
//   * edges masked: out-of-range x and w elements are zero-filled by the
//     copies (the K tail's last step multiplies zeros), stores past M and N
//     are skipped; the bias and activation are applied in the epilogue, as
//     the TPU kernel does on its last K step.
//
// What limits it now (chip_smoke.py's launch lines, PERF.md): at the
// layer-0 shape it runs within a few percent of torch.addmm (faster than
// addmm followed by relu), still ~5x its bound; every tile plan tried
// landed within a few percent, so the cost is per product (the splits,
// the per-step adds), not the grid. At layer 1 it is faster than
// torch.addmm.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "activation.cuh"
#include "mma_tf32.cuh"

namespace {

using namespace activation;
using namespace mma_tf32;

constexpr int BK = 32;

template <int BM_, int BN_, int WARPS_M_, int WARPS_N_, int STAGES_,
          int MIN_BLOCKS_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, STAGES = STAGES_;
  static constexpr int MIN_BLOCKS = MIN_BLOCKS_;  // resident per SM
  static constexpr int WARPS_M = WARPS_M_, WARPS_N = WARPS_N_;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int WTM = BM / WARPS_M, WTN = BN / WARPS_N;  // per warp
  static constexpr int MT = WTM / 16, NT = WTN / 8;             // mma tiles
  static constexpr int X_LD = BK + 4, W_LD = BN + 8;
  static constexpr int STAGE_FLOATS = BM * X_LD + BK * W_LD;
  static constexpr int SMEM_BYTES = STAGES * STAGE_FLOATS * 4;
};

using Big = Tile<64, 128, 2, 2, 2, 4>;    // plan 0
using Small = Tile<16, 64, 1, 4, 3, 4>;   // plan 1

// V: floats per cp.async (4, 2 or 1); K and N are multiples of V
template <class C, int V>
__global__ void __launch_bounds__(C::THREADS, C::MIN_BLOCKS)
update_mlp_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ b, float* __restrict__ out,
                  int M, int K, int N, int act) {
  extern __shared__ __align__(16) float smem[];
  const long long m0 = (long long)blockIdx.x * C::BM;
  const int n0 = blockIdx.y * C::BN;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp % C::WARPS_M, wn = warp / C::WARPS_M;
  const int g = lane / 4, t = lane % 4;
  const int chunks = (K + BK - 1) / BK;

  // each thread copies one column piece of every XR-th x row and every
  // WR-th w row, walking one pointer down the rows (unrolled copies with
  // their own addresses took registers enough to spill)
  constexpr int XC = BK / V, WC = C::BN / V;   // pieces per row
  static_assert(C::THREADS % XC == 0 && C::THREADS % WC == 0,
                "a pass of the block must cover whole rows");
  constexpr int XR = C::THREADS / XC, WR = C::THREADS / WC;
  const int xr0 = tid / XC, xk = (tid % XC) * V;
  const int wr0 = tid / WC, wcol = n0 + (tid % WC) * V;
  auto load_chunk = [&](int c, int st) {
    float* Xs = smem + st * C::STAGE_FLOATS;
    float* Ws = Xs + C::BM * C::X_LD;
    const int k0 = c * BK;
    const bool x_in = k0 + xk < K;
    const float* xs = x + (m0 + xr0) * K + k0 + xk;
#pragma unroll 2
    for (int r = xr0; r < C::BM; r += XR, xs += (long long)XR * K) {
      const bool in = x_in && m0 + r < M;
      cp_async<4 * V>(Xs + r * C::X_LD + xk, in ? xs : x, in ? 4 * V : 0);
    }
    const bool w_in = wcol < N;
    const float* ws = w + (long long)(k0 + wr0) * N + wcol;
#pragma unroll 2
    for (int r = wr0; r < BK; r += WR, ws += (long long)WR * N) {
      const bool in = w_in && k0 + r < K;
      cp_async<4 * V>(Ws + r * C::W_LD + wcol - n0, in ? ws : w,
                      in ? 4 * V : 0);
    }
  };

  float acc[C::MT][C::NT][4];
#pragma unroll
  for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

#pragma unroll
  for (int c = 0; c < C::STAGES - 1; ++c) {
    if (c < chunks) load_chunk(c, c);
    cp_async_commit();  // an empty group keeps the count uniform
  }
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<C::STAGES - 2>();  // this thread's copies of c landed
    __syncthreads();  // everyone's landed; everyone is done with chunk c-1
    if (c + C::STAGES - 1 < chunks)
      load_chunk(c + C::STAGES - 1, (c + C::STAGES - 1) % C::STAGES);
    cp_async_commit();

    const float* Xs = smem + (c % C::STAGES) * C::STAGE_FLOATS
                      + wm * C::WTM * C::X_LD;
    const float* Ws = smem + (c % C::STAGES) * C::STAGE_FLOATS
                      + C::BM * C::X_LD + wn * C::WTN;
#pragma unroll
    for (int k8 = 0; k8 < BK; k8 += 8) {
      uint32_t a_hi[C::MT][4], a_lo[C::MT][4];
#pragma unroll
      for (int mt = 0; mt < C::MT; ++mt)
        load_a(Xs + mt * 16 * C::X_LD + k8, C::X_LD, g, t, a_hi[mt],
               a_lo[mt]);
#pragma unroll
      for (int nt = 0; nt < C::NT; ++nt) {
        uint32_t b_hi[2], b_lo[2];
        load_b(Ws + k8 * C::W_LD + nt * 8, C::W_LD, g, t, b_hi, b_lo);
#pragma unroll
        for (int mt = 0; mt < C::MT; ++mt)
          mma_step(acc[mt][nt], a_hi[mt], a_lo[mt], b_hi, b_lo);
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the block

#pragma unroll
  for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long row = m0 + wm * C::WTM + mt * 16 + g + 8 * half;
      if (row >= M) continue;
#pragma unroll
      for (int nt = 0; nt < C::NT; ++nt) {
        const int n = n0 + wn * C::WTN + nt * 8 + 2 * t;
        if (n < N)
          out[row * N + n] = act_apply(acc[mt][nt][2 * half] + b[n], act);
        if (n + 1 < N)
          out[row * N + n + 1] =
              act_apply(acc[mt][nt][2 * half + 1] + b[n + 1], act);
      }
    }
}

template <class C, int V>
int launch(const float* x, const float* w, const float* b, float* out, int M,
           int K, int N, int act, cudaStream_t stream) {
  const long long grid_m = ((long long)M + C::BM - 1) / C::BM;
  const int grid_n = (N + C::BN - 1) / C::BN;
  if (grid_m <= 0 || grid_m > INT_MAX || grid_n <= 0 || grid_n > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const cudaError_t err = cudaFuncSetAttribute(
      update_mlp_kernel<C, V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  update_mlp_kernel<C, V><<<dim3((unsigned)grid_m, grid_n), C::THREADS,
                            C::SMEM_BYTES, stream>>>(x, w, b, out, M, K, N,
                                                     act);
  return (int)cudaGetLastError();
}

template <class C>
int launch_v(const float* x, const float* w, const float* b, float* out,
             int M, int K, int N, int act, cudaStream_t stream) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(x)
                      | reinterpret_cast<uintptr_t>(w);
  if (K % 4 == 0 && N % 4 == 0 && (a & 15) == 0)
    return launch<C, 4>(x, w, b, out, M, K, N, act, stream);
  if (K % 2 == 0 && N % 2 == 0 && (a & 7) == 0)
    return launch<C, 2>(x, w, b, out, M, K, N, act, stream);
  return launch<C, 1>(x, w, b, out, M, K, N, act, stream);
}

}  // namespace

extern "C" {

// Dynamic shared memory of one thread block of tile plan `plan`.
int update_mlp_smem_bytes(int plan) {
  return plan == 0 ? Big::SMEM_BYTES : Small::SMEM_BYTES;
}

// plan: 0 the 64 x 128 tiles, 1 the 16 x 64 tiles (kernels/update_mlp.py:
// plan). Launches on `stream`; returns the CUDA status right after the
// launch (0 = launched). Does not synchronise and allocates nothing.
int update_mlp_launch(const float* x, const float* w, const float* b,
                      float* out, int M, int K, int N, int act, int plan,
                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (plan == 0) return launch_v<Big>(x, w, b, out, M, K, N, act, st);
  if (plan == 1) return launch_v<Small>(x, w, b, out, M, K, N, act, st);
  return (int)cudaErrorInvalidValue;
}

const char* update_mlp_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

}  // extern "C"
