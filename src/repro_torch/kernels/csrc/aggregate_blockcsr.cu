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
//   nblk   (n_dstb,) int32 or null            slots to walk per block
//   order  (n_dstb,) int32 or null            destination blocks, heaviest
//                                             first
//   h      (n_src, F)                  f32    n_src = n_srcb*128
// Output: out (n_dstb*128, F) f32, out[i-block] = sum over k < nblk[i] of
// blocks[i, k] @ h[cols[i, k]*128 : +128] (k < max_blk without nblk).
// The layouts pack a block's real slots first, so the slots past nblk[i]
// hold zero tiles and the terms they drop are exact zeros.
//
// What bounds it on an H100: only the real slots carry work, 2*128*128*F
// flops each. At layer 0 of the paper's GraphSAGE batch (208 destination
// blocks, 10,553 of 266,240 slots real, F = 602) that is 0.208 TFLOP,
// 0.42 ms at the 495 TFLOP/s of TF32 tensor-core work, against the 0.69
// GB of real tiles plus the h rows they name, ~0.4 ms at 3.35 TB/s: the
// two bounds meet. The TPU kernel, and this port's first version, walked
// all 1,280 slots of every destination block (5.25 TFLOP on fp32 FMA, 181
// ms on the card).
//
// Design:
//   * real slots only: each destination block walks k < nblk[i], the count
//     of its real slots, which the wrapper derives on the card from the
//     compact triples; the blocks run heaviest first (`order`), since
//     their counts vary a lot;
//   * one thread block of 256 threads per (destination block, slice of
//     FS = 64 feature columns), the slice index varying fastest in the 1-D
//     grid, so the slices of one destination block run together and
//     re-read its A tiles from L2;
//   * each slot's product runs over K-chunks of KC = 32 tile columns: the
//     128 x 32 chunk of A and the 32 rows of h that cols[i, k] names
//     (columns f0 .. f0+63) are staged with cp.async in a ring of three
//     stages, so the copies of the next two chunks run under the products
//     of this one; rows are padded (36 and 72 floats) so the fragment
//     loads below meet no bank conflict;
//   * the products run on the tensor cores as mma.sync m16n8k8 TF32 with
//     the 3xTF32 split a = a_hi + a_lo (each rounded to TF32): a_lo*b_hi +
//     a_hi*b_lo + a_hi*b_hi keeps fp32's accuracy (the dropped a_lo*b_lo
//     is ~2^-22 of the product). The tensor core truncates the sums it
//     forms, so a step of 8 tile columns sums its three products from zero
//     there and joins the accumulator by a rounded fp32 add: accumulating
//     across steps inside the tensor core erred by 1.2e-5 against fp32's
//     7e-7 at the paper batch's layer-1 backward (values up to 4.9). Eight
//     warps as 4 (rows) x 2 (columns), each owning a 32 x 32 piece of the
//     128 x 64 output tile in registers;
//   * every output element adds its terms in slot order, then step order,
//     then the tensor core's own order: one order on every run;
//   * ragged F is masked on load (zero-filled copies) and on store; h rows
//     are copied 16, 8 or 4 bytes at a time as F and h's alignment allow;
//     64-bit offsets (the layer-0 tiles take 17.45 GB).

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "mma_tf32.cuh"

namespace {

using namespace mma_tf32;

constexpr int BLK = 128;
constexpr int FS = 64;          // feature columns per thread block
constexpr int KC = 32;          // tile columns (h rows) per staged chunk
constexpr int STAGES = 3;
constexpr int THREADS = 256;
constexpr int A_LD = KC + 4;    // padded row of the A chunk
constexpr int H_LD = FS + 8;    // padded row of the h chunk
constexpr int STAGE_FLOATS = BLK * A_LD + KC * H_LD;
constexpr int SMEM_BYTES = STAGES * STAGE_FLOATS * (int)sizeof(float);

// HV: floats per cp.async of an h row (4, 2 or 1)
template <int HV>
__global__ void __launch_bounds__(THREADS, 2)
    aggregate_blockcsr_kernel(const float* __restrict__ blocks,
                              const int* __restrict__ cols,
                              const int* __restrict__ nblk,
                              const int* __restrict__ order,
                              const float* __restrict__ h,
                              float* __restrict__ out, int n_slices,
                              int max_blk, long long n_src, int F) {
  extern __shared__ __align__(16) float smem[];
  const int pos = blockIdx.x / n_slices;
  const long long i = order != nullptr ? order[pos] : pos;
  const int f0 = (blockIdx.x % n_slices) * FS;
  const int n = nblk != nullptr ? min(max(nblk[i], 0), max_blk) : max_blk;
  const int chunks = n * (BLK / KC);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp % 4, wn = warp / 4;  // rows 32 wm, columns 32 wn
  const int g = lane / 4, t = lane % 4;

  // stage chunk c (slot c / 4, tile columns (c % 4) * KC ..) into `st`
  auto load_chunk = [&](int c, int st) {
    float* As = smem + st * STAGE_FLOATS;
    float* Hs = As + BLK * A_LD;
    const long long slot = i * max_blk + c / (BLK / KC);
    const int kc = (c % (BLK / KC)) * KC;
    const long long col = cols[slot];
    if (col < 0 || (col + 1) * BLK > n_src) __trap();
    const float* a = blocks + slot * (BLK * BLK) + kc;
#pragma unroll
    for (int u = 0; u < BLK * KC / 4 / THREADS; ++u) {
      const int x = tid + u * THREADS;
      const int r = x / (KC / 4), q = x % (KC / 4);
      cp_async<16>(As + r * A_LD + 4 * q, a + r * BLK + 4 * q, 16);
    }
    const float* hb = h + (col * BLK + kc) * F;
#pragma unroll
    for (int u = 0; u < KC * FS / HV / THREADS; ++u) {
      const int x = tid + u * THREADS;
      const int r = x / (FS / HV), cv = (x % (FS / HV)) * HV;
      const bool in = f0 + cv < F;  // F is a multiple of HV
      cp_async<HV * 4>(Hs + r * H_LD + cv,
                       in ? hb + (long long)r * F + f0 + cv : h,
                       in ? HV * 4 : 0);
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) {
    if (c < chunks) load_chunk(c, c);
    cp_async_commit();  // an empty group keeps the count uniform
  }
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of chunk c landed
    __syncthreads();  // everyone's landed; everyone is done with chunk c-1
    if (c + STAGES - 1 < chunks)
      load_chunk(c + STAGES - 1, (c + STAGES - 1) % STAGES);
    cp_async_commit();

    const float* As = smem + (c % STAGES) * STAGE_FLOATS;
    const float* Hs = As + BLK * A_LD;
#pragma unroll
    for (int k8 = 0; k8 < KC; k8 += 8) {
      uint32_t a_hi[2][4], a_lo[2][4], b_hi[4][2], b_lo[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const float* ar = As + (wm * 32 + mt * 16 + g) * A_LD + k8 + t;
        split_tf32(ar[0], a_hi[mt][0], a_lo[mt][0]);
        split_tf32(ar[8 * A_LD], a_hi[mt][1], a_lo[mt][1]);
        split_tf32(ar[4], a_hi[mt][2], a_lo[mt][2]);
        split_tf32(ar[8 * A_LD + 4], a_hi[mt][3], a_lo[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float* br = Hs + (k8 + t) * H_LD + wn * 32 + nt * 8 + g;
        split_tf32(br[0], b_hi[nt][0], b_lo[nt][0]);
        split_tf32(br[4 * H_LD], b_hi[nt][1], b_lo[nt][1]);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_step(acc[mt][nt], a_hi[mt], a_lo[mt], b_hi[nt], b_lo[nt]);
    }
  }
  cp_async_wait<0>();  // no copy outlives the block

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float* orow = out + (i * BLK + wm * 32 + mt * 16 + g + 8 * half) * F;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int f = f0 + wn * 32 + nt * 8 + 2 * t;
        if (f < F) orow[f] = acc[mt][nt][2 * half];
        if (f + 1 < F) orow[f + 1] = acc[mt][nt][2 * half + 1];
      }
    }
}

template <int HV>
int launch(const float* blocks, const int* cols, const int* nblk,
           const int* order, const float* h, float* out, int n_dstb,
           int max_blk, long long n_src, int F, cudaStream_t stream) {
  const int n_slices = (F + FS - 1) / FS;
  const long long grid = (long long)n_dstb * n_slices;
  if (grid <= 0 || grid > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  const cudaError_t err = cudaFuncSetAttribute(
      aggregate_blockcsr_kernel<HV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  aggregate_blockcsr_kernel<HV><<<(unsigned)grid, THREADS, SMEM_BYTES,
                                  stream>>>(blocks, cols, nblk, order, h, out,
                                            n_slices, max_blk, n_src, F);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory of one thread block (the three-stage ring).
int aggregate_blockcsr_smem_bytes() { return SMEM_BYTES; }

// nblk and order may be null (every slot, destination blocks in order).
// Launches on `stream`; returns the CUDA status right after the launch
// (0 = launched). Does not synchronise and allocates nothing. blocks must
// be 16-byte aligned.
int aggregate_blockcsr_launch(const float* blocks, const int* cols,
                              const int* nblk, const int* order,
                              const float* h, float* out, int n_dstb,
                              int max_blk, long long n_src, int F,
                              void* stream) {
  if ((reinterpret_cast<uintptr_t>(blocks) & 15) != 0)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = (cudaStream_t)stream;
  const uintptr_t hp = reinterpret_cast<uintptr_t>(h);
  if (F % 4 == 0 && (hp & 15) == 0)
    return launch<4>(blocks, cols, nblk, order, h, out, n_dstb, max_blk,
                     n_src, F, st);
  if (F % 2 == 0 && (hp & 7) == 0)
    return launch<2>(blocks, cols, nblk, order, h, out, n_dstb, max_blk,
                     n_src, F, st);
  return launch<1>(blocks, cols, nblk, order, h, out, n_dstb, max_blk, n_src,
                   F, st);
}

const char* aggregate_blockcsr_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

}  // extern "C"
