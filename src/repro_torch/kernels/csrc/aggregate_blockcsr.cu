// aggregate_blockcsr: out = A @ h, with the sampled adjacency A in padded
// block-CSR form over dense 128x128 tiles (aggregate_backend="pallas").
//
// Replaces the Pallas TPU kernel src/repro/kernels/aggregate.py:_kernel
// (called by aggregate_blockcsr; through aggregate_blockcsr_vjp and
// aggregate_compact_vjp the same kernel over the tiles of A^T is the
// backward, dh = A^T @ g).
//
// Inputs, for one layer with n_dstb destination blocks of BLK rows:
//   blocks (n_dstb, max_blk, 128, 128) f32    dense tiles, unused slots zero
//   cols   (n_dstb, max_blk)           int32  source block of each slot
//   h      (n_src, F)                  f32    n_src = n_srcb*128
// Output: out (n_dstb*128, F) f32, out[i-block] = sum over k of
// blocks[i, k] @ h[cols[i, k]*128 : +128].
//
// What bounds it on an H100: the kernel multiplies every slot, as the TPU
// kernel does, 2*128*128*F flops each. At layer 0 of the paper's GraphSAGE
// batch (208 destination blocks x 1,280 slots, F = 602) that is 5.25 TFLOP,
// 78 ms at the published 67 TFLOP/s of fp32 outside the tensor cores,
// against 17.45 GB of tiles read once, 5.2 ms at 3.35 TB/s. Only ~4% of
// the slots hold an edge, though, so the work the data needs is bound by
// reading the tiles. chip_smoke.py prints both counts for the batch it
// runs; PERF.md has the measured times beside them.
//
// Design (a simple kernel that is right; tensor cores, TMA and skipping the
// empty slots are later work):
//   * one thread block per (destination block i, slice of FS = 64 feature
//     columns), the slice index varying fastest in the 1-D grid, so the
//     slices of one destination block run together and re-read the same A
//     tiles from L2;
//   * 256 threads as a 16 x 16 grid; thread (ty, tx) holds rows ty*8 ..
//     ty*8+7 and columns tx*4 .. tx*4+3 of the 128 x 64 output tile in
//     registers;
//   * the slots run in order k = 0 .. max_blk-1, as the TPU grid's
//     sequential k axis does; each slot's product runs over K-chunks of
//     KC = 32: A[:, kc:kc+32] is staged transposed in shared memory (rows
//     padded to 132 floats, so each thread's 8 rows load as two float4) and
//     the 32 rows of h that cols[i, k] names, columns f0 .. f0+64, beside
//     it;
//   * plain fp32 FMA, so no TF32; every output element adds its terms in
//     slot order, then tile-column order: one order on every run;
//   * ragged F is masked on load and store (the reference pads F to its
//     feature block); 64-bit offsets (the layer-0 tiles take 17.45 GB).

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int BLK = 128;
constexpr int FS = 64;            // feature columns per thread block
constexpr int KC = 32;            // tile columns (h rows) per staged chunk
constexpr int TX = 16, TY = 16;
constexpr int THREADS = TX * TY;
constexpr int TM = BLK / TY;      // rows per thread (8)
constexpr int TN = FS / TX;       // columns per thread (4)
constexpr int AS_LD = BLK + 4;    // padded row of the transposed A chunk

__global__ void __launch_bounds__(THREADS)
aggregate_blockcsr_kernel(const float* __restrict__ blocks,
                          const int* __restrict__ cols,
                          const float* __restrict__ h,
                          float* __restrict__ out, int n_slices,
                          int max_blk, long long n_src, int F) {
  __shared__ __align__(16) float As[KC][AS_LD];   // As[kk][r] = A[r][kc+kk]
  __shared__ __align__(16) float Hs[KC][FS];      // h rows kc .. kc+KC

  const long long i = blockIdx.x / n_slices;
  const int f0 = (blockIdx.x % n_slices) * FS;
  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;

  float acc[TM][TN];
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[m][j] = 0.f;

  for (int k = 0; k < max_blk; ++k) {
    const long long slot = i * max_blk + k;
    const long long c = cols[slot];
    if (c < 0 || (c + 1) * BLK > n_src) __trap();
    const float* a = blocks + slot * (BLK * BLK);
    const float* hb = h + c * BLK * F;
    for (int kc = 0; kc < BLK; kc += KC) {
      for (int x = threadIdx.x; x < BLK * KC / 4; x += THREADS) {
        const int r = x / (KC / 4), q = x % (KC / 4);
        const float4 v =
            *reinterpret_cast<const float4*>(a + r * BLK + kc + 4 * q);
        As[4 * q + 0][r] = v.x;
        As[4 * q + 1][r] = v.y;
        As[4 * q + 2][r] = v.z;
        As[4 * q + 3][r] = v.w;
      }
      for (int x = threadIdx.x; x < KC * FS; x += THREADS) {
        const int kk = x / FS, f = f0 + x % FS;
        Hs[kk][x % FS] = f < F ? hb[(long long)(kc + kk) * F + f] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < KC; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
        const float4 a1 =
            *reinterpret_cast<const float4*>(&As[kk][ty * TM + 4]);
        const float4 b = *reinterpret_cast<const float4*>(&Hs[kk][tx * TN]);
        const float av[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int m = 0; m < TM; ++m)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[m][j] = fmaf(av[m], bv[j], acc[m][j]);
      }
      __syncthreads();  // every thread is done with As and Hs
    }
  }

#pragma unroll
  for (int m = 0; m < TM; ++m) {
    float* orow = out + (i * BLK + ty * TM + m) * F;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int f = f0 + tx * TN + j;
      if (f < F) orow[f] = acc[m][j];
    }
  }
}

}  // namespace

extern "C" {

// Launches on `stream`; returns the CUDA status right after the launch
// (0 = launched). Does not synchronise and allocates nothing. blocks must
// be 16-byte aligned.
int aggregate_blockcsr_launch(const float* blocks, const int* cols,
                              const float* h, float* out, int n_dstb,
                              int max_blk, long long n_src, int F,
                              void* stream) {
  const int n_slices = (F + FS - 1) / FS;
  const long long grid = (long long)n_dstb * n_slices;
  if (grid <= 0 || grid > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  aggregate_blockcsr_kernel<<<(unsigned)grid, THREADS, 0,
                              (cudaStream_t)stream>>>(
      blocks, cols, h, out, n_slices, max_blk, n_src, F);
  return (int)cudaGetLastError();
}

const char* aggregate_blockcsr_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

}  // extern "C"
