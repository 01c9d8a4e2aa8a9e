// mma_tf32.cuh: fp32 products on the tensor cores (mma.sync m16n8k8 TF32
// with the 3xTF32 split) and the cp.async copies that stage their operands,
// shared by aggregate_blockcsr.cu, update_mlp.cu, wkv6_chunk.cu and
// aggregate_fused_bwd.cu.
//
// The 3xTF32 rule every user keeps: split each operand into TF32 parts,
// a = a_hi + a_lo, and form a_lo*b_hi + a_hi*b_lo + a_hi*b_hi (the dropped
// a_lo*b_lo is ~2^-21 of the product or less). The tensor core truncates
// the sums it forms, so no sum runs across steps of 8 terms inside it: each
// step's products start from zero and join the fp32 accumulator by rounded
// adds.
// Accumulating across steps inside the tensor core erred by 1.2e-5
// against fp32's 7e-7 (aggregate_blockcsr, at values up to 4.9).

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace mma_tf32 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// copies BYTES (4, 8 or 16) from global to shared memory, zero-filling
// what `src_bytes` leaves out
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "n"(BYTES), "r"(src_bytes)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// x split into TF32 big and small parts, x ~ hi + lo, each rounded to
// nearest (aggregate_blockcsr's split)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(rest));
}

// The same split with no conversion: hi rounded to nearest (ties away)
// by integer arithmetic on x's bits, bit for bit what cvt.rna gives for a
// finite x, and lo = x - hi exact in fp32, whose low 13 bits the tensor
// core ignores (a TF32 operand). lo's error is then at most 2^-21 |x|
// against 2^-22, and a NaN still reaches the product through lo. The
// conversions run slower than integer and fp32 arithmetic, and update_mlp
// and wkv6_chunk split every operand in each warp that uses it: they run
// faster with this split (PERF.md, PR 16). The fragment loaders below use
// it.
__device__ __forceinline__ void split_tf32_fast(float x, uint32_t& hi,
                                                uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d (16 x 8) += a (16 x 8, row) b (8 x 8, col), TF32 in, fp32 out. Not
// volatile: it has no effect but d, so the compiler may interleave
// independent products to hide the tensor core's latency.
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a b from zero: the same product as mma_tf32 on a zeroed d, with the
// zero read from one register instead of four moved into d
__device__ __forceinline__ void mma_tf32_zero(float* d, const uint32_t* a,
                                              const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f));
}

// acc += a b for one step of 8 terms, 3xTF32: the three products summed
// from zero inside the tensor core, small terms first, then one rounded
// fp32 add per element
__device__ __forceinline__ void mma_step(float* acc, const uint32_t* a_hi,
                                         const uint32_t* a_lo,
                                         const uint32_t* b_hi,
                                         const uint32_t* b_lo) {
  float step[4];
  mma_tf32_zero(step, a_lo, b_hi);
  mma_tf32(step, a_hi, b_lo);
  mma_tf32(step, a_hi, b_hi);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += step[e];
}

// The fragments of one m16n8k8 step, with g = lane / 4 and t = lane % 4:
//   A (16 x 8, row): a0 A[g][t], a1 A[g+8][t], a2 A[g][t+4], a3 A[g+8][t+4]
//   B (8 x 8, col):  b0 B[t][g], b1 B[t+4][g]
//   D (16 x 8):      d0 D[g][2t], d1 D[g][2t+1], d2 D[g+8][2t],
//                    d3 D[g+8][2t+1]
// A row-major A read by rows lands on distinct banks when its row stride
// is 4 (mod 32) words; B and D, read or written by rows of 8 columns, when
// theirs is 8 (mod 32).

// the A fragment at A[0][0] with row stride lda, split
__device__ __forceinline__ void load_a(const float* a, int lda, int g, int t,
                                       uint32_t* hi, uint32_t* lo) {
  split_tf32_fast(a[g * lda + t], hi[0], lo[0]);
  split_tf32_fast(a[(g + 8) * lda + t], hi[1], lo[1]);
  split_tf32_fast(a[g * lda + t + 4], hi[2], lo[2]);
  split_tf32_fast(a[(g + 8) * lda + t + 4], hi[3], lo[3]);
}

// the A fragment of A = X^T, X stored row-major with row stride ldx
// (A[m][k] = X[k][m]), split
__device__ __forceinline__ void load_a_t(const float* x, int ldx, int g,
                                         int t, uint32_t* hi, uint32_t* lo) {
  split_tf32_fast(x[t * ldx + g], hi[0], lo[0]);
  split_tf32_fast(x[t * ldx + g + 8], hi[1], lo[1]);
  split_tf32_fast(x[(t + 4) * ldx + g], hi[2], lo[2]);
  split_tf32_fast(x[(t + 4) * ldx + g + 8], hi[3], lo[3]);
}

// the B fragment at B[0][0] with row stride ldb (B row-major, k by n), split
__device__ __forceinline__ void load_b(const float* b, int ldb, int g, int t,
                                       uint32_t* hi, uint32_t* lo) {
  split_tf32_fast(b[t * ldb + g], hi[0], lo[0]);
  split_tf32_fast(b[(t + 4) * ldb + g], hi[1], lo[1]);
}

}  // namespace mma_tf32
