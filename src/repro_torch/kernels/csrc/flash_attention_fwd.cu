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
// type. D <= 128. The dtype picks one of two routes. Where the caller
// passes an lse buffer, (B, H, Sq) fp32, each route also writes the row's
// log-sum-exp in natural-log units over the scaled, masked scores, m +
// log(max(l, 1e-30)) (the reference's _flash_fwd_scan), which the training
// backward (flash_attention_bwd.cu) reads; a null lse writes nothing more
// and leaves every other instruction as it was.
//
// bfloat16, the dtype the models serve in: the wgmma route (namespace wg).
// What bounds it on an H100: at Llama-3-8B's prefill (B 4, S 4096, H 32,
// D 128, causal) the unmasked half is 2*S^2*D flops per (b, h) for each of
// the two products, 550 GFLOP in all: 0.556 ms at 989 TFLOP/s of dense
// bf16 tensor-core work, against 537 MB of q, k, v and out, 0.160 ms at
// 3.35 TB/s. It is bound by operations, so both products run on the
// tensor cores and the copies run beside them. Design (FA3's shape):
//   * one thread block of 384 threads per (128-row q tile, h, b), the
//     heaviest causal tiles first: two consumer warpgroups of 64 query rows
//     and a producer warpgroup, one thread of which issues every copy;
//     setmaxnreg moves registers from the producer (24 a thread) to the
//     consumers (240), whose scores, output and p take ~180;
//   * q arrives once by TMA; the k and v tiles of 128 keys flow through a
//     two-stage ring in shared memory, bf16 in 128-byte swizzled panels of
//     64 head columns (one panel for D <= 64, two for D <= 128; 160 KB at
//     D = 128), each copy completing on an mbarrier; a stage goes back to
//     the producer on an mbarrier the consumer warps arrive at once its
//     P V product has finished. TMA reads each operand through a 4-d tensor
//     map over (D, head, sequence, batch) built from the caller's strides
//     (cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint), so
//     GQA is the kv head coordinate h / G, and ragged Sq, Sk and D < 64 or
//     128 arrive as TMA's zero-filled out-of-bounds rows and columns;
//   * S = Q K^T runs as wgmma m64n128k16 with both operands in shared
//     memory (K-major) and the 64 x 128 fp32 scores in registers; after
//     wgmma.wait_group 0 the online softmax runs in that accumulator
//     layout, on scores in log2 units (one exp2 of a difference per p): a
//     row lives in the 4 threads of a quad, its max reduces over them
//     with two shuffles, and its sum l stays per thread until the end.
//     The masks apply only on the tiles that reach past the diagonal or
//     past Sk; tiles past the q tile's last row are skipped, which is
//     exact (p = 0, corr = 1);
//   * p is rounded to bf16 in registers, and the score accumulator's layout
//     is the register A operand of the next wgmma: O += P V runs as wgmma
//     m64nDk16 with P from registers and V from shared memory as an
//     MN-major B operand (the transpose bit);
//   * out = O / max(l, 1e-30) in bf16 pairs straight from the registers,
//     masked at Sq and D.
// The two warpgroups overlap each other's softmax and products; overlapping
// them inside a warpgroup, and storing through shared memory, are later
// work. The Hopper pieces (mbarriers, TMA, descriptors, wgmma, the tensor
// map encoder) are hopper.cuh's, shared with flash_attention_bwd.cu.
//
// float32: the FMA route (namespace fma), the path of the fp32
// prefill/decode consistency check and of the tests at the reference's
// tolerances (TF32 would need them restated). Both products are fp32 FMA
// loops outside the tensor cores (67 TFLOP/s at most) that shared-memory
// loads limit to about half that rate; that bounds it.
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

#include <cuda.h>  // CUtensorMap and its enums only: no libcuda is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

#include "hopper.cuh"
#include "typed_io.cuh"

namespace {

// ---------------------------------------------------------------------------
// the float32 route: fp32 FMA
// ---------------------------------------------------------------------------
namespace fma {

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
  float* lse;  // (B, H, Sq) or null
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
    // m and l are the row's own in each of its 16 threads
    if (a.lse != nullptr && tx == 0)
      a.lse[((long long)b * gridDim.y + h) * a.Sq + qi] = m[i] + logf(li);
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

}  // namespace fma

// ---------------------------------------------------------------------------
// the bfloat16 route: TMA, mbarriers and wgmma
// ---------------------------------------------------------------------------
namespace wg {

using namespace hopper;

constexpr int BQ = 128, BK = 128, STAGES = 2;
constexpr int CONSUMERS = 2;                    // warpgroups of 64 q rows
constexpr int THREADS = 128 * (CONSUMERS + 1);  // + the producer warpgroup
constexpr int PANEL_BYTES = 128 * ROW_BYTES;    // 128 rows x 64 columns
constexpr float LN2 = 0.6931471805599453f;
// scores are kept in log2 units (x log2(e)), so exp(x - m) is one exp2 of
// a difference; the causal mask's -1e30 is taken there as -1e30 log2(e)
constexpr float MASKED = -1e30f * LOG2E;

// NP panels of 64 head columns each; every panel starts on a 1024-byte
// boundary, the period of the 128-byte swizzle
template <int NP>
struct __align__(1024) Smem {
  uint8_t q[NP][PANEL_BYTES];
  uint8_t k[STAGES][NP][PANEL_BYTES];
  uint8_t v[STAGES][NP][PANEL_BYTES];
  uint64_t q_full, k_full[STAGES], v_full[STAGES], empty[STAGES];
};

template <int NP>
constexpr int smem_bytes() {
  return (int)sizeof(Smem<NP>) + 1024;  // + aligning the base
}

struct Args {
  __nv_bfloat16* o;
  float* lse;       // (B, H, Sq) or null
  long long os[3];  // (batch, sequence, head) strides of out, elements
  int Sq, Sk, G, D, causal;
  float scale;
};

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// One consumer warpgroup: query rows row_lo .. row_lo + 63 of the block's q
// tile. Thread (warp, lane) holds rows r0 = row_lo + 16 warp + lane / 4 and
// r0 + 8: in wgmma's accumulator layout s[i] is row r0 + 8 ((i % 4) / 2)
// and column 8 (i / 4) + 2 (lane % 4) + i % 2 of the tile, and o likewise
// over head columns.
template <int NP>
__device__ __forceinline__ void consume(Smem<NP>& sm, const Args& a, int q0,
                                        int n_tiles, int wgi, int b, int h) {
  constexpr int DP = 64 * NP;  // head columns the panels hold
  constexpr int NO = DP / 2;   // o registers of a thread
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int row_lo = q0 + 64 * wgi;
  const int r0 = row_lo + 16 * warp + lane / 4;
  const int cq = 2 * (lane % 4);
  float s[64], o[NO];
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float m0 = MASKED, m1 = MASKED, l0 = 0.f, l1 = 0.f;
  const float scale = a.scale * LOG2E;

  const uint32_t q_base = smem_u32(sm.q[0]) + wgi * 64 * ROW_BYTES;
  mbar_wait(&sm.q_full, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % STAGES;
    const uint32_t ph = (j / STAGES) & 1;
    const int k0 = j * BK;

    // S = Q K^T in DP / 16 steps of 16 head columns
    mbar_wait(&sm.k_full[st], ph);
    const uint32_t k_base = smem_u32(sm.k[st][0]);
    fence_operands(s);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks) {
      const uint32_t off = (ks / 4) * PANEL_BYTES + (ks % 4) * 32;
      wgmma_ss_n128(s, kmajor_desc(q_base + off), kmajor_desc(k_base + off),
                    ks > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(s);

    // scale, mask and the online softmax of this tile's 128 keys; the
    // masks apply only where the tile reaches past the diagonal or Sk
    const bool edge = (a.causal && k0 + BK - 1 > row_lo) || k0 + BK > a.Sk;
    float mt0 = -INFINITY, mt1 = -INFINITY;
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      float x = s[i] * scale;
      if (edge) {
        const int kj = k0 + 8 * (i / 4) + cq + i % 2;
        const int qi = r0 + 8 * ((i % 4) / 2);
        if (a.causal && qi < kj) x = MASKED;
        if (kj >= a.Sk) x = -INFINITY;  // no such key
      }
      s[i] = x;
      if (i % 4 < 2)
        mt0 = fmaxf(mt0, x);
      else
        mt1 = fmaxf(mt1, x);
    }
    const float mn0 = fmaxf(m0, quad_max(mt0));
    const float mn1 = fmaxf(m1, quad_max(mt1));
    const float c0 = exp2f(m0 - mn0);
    const float c1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    // p, rounded to bf16, straight into the register A operand of P V: keys
    // 16 kk .. 16 kk + 15 are accumulator groups 2 kk (A registers 0, 1)
    // and 2 kk + 1 (A registers 2, 3), rows r0 (0, 2) and r0 + 8 (1, 3)
    uint32_t pa[BK / 16][4];
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
      const float p0 = exp2f(s[4 * jj + 0] - mn0);
      const float p1 = exp2f(s[4 * jj + 1] - mn0);
      const float p2 = exp2f(s[4 * jj + 2] - mn1);
      const float p3 = exp2f(s[4 * jj + 3] - mn1);
      ps0 += p0 + p1;
      ps1 += p2 + p3;
      pa[jj / 2][(jj % 2) * 2 + 0] = pack_bf16(p0, p1);
      pa[jj / 2][(jj % 2) * 2 + 1] = pack_bf16(p2, p3);
    }
    l0 = l0 * c0 + ps0;  // this thread's share; the quad sums at the end
    l1 = l1 * c1 + ps1;
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] *= (i % 4 < 2) ? c0 : c1;

    // O += P V in BK / 16 steps of 16 keys
    mbar_wait(&sm.v_full[st], ph);
    const uint32_t v_base = smem_u32(sm.v[st][0]);
    fence_operands(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t dv = mnmajor_desc(v_base + kk * 16 * ROW_BYTES,
                                         PANEL_BYTES);
      if constexpr (NP == 1)
        wgmma_rs_n64(o, pa[kk], dv);
      else
        wgmma_rs_n128(o, pa[kk], dv);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(o);
    if (lane == 0) mbar_arrive(&sm.empty[st]);  // this warp is done with st
  }

  l0 = fmaxf(quad_sum(l0), 1e-30f);
  l1 = fmaxf(quad_sum(l1), 1e-30f);
  if (a.lse != nullptr && lane % 4 == 0) {
    // m is in log2 units: the natural-log lse is m ln 2 + ln l
    float* lr = a.lse + ((long long)b * gridDim.y + h) * a.Sq;
    if (r0 < a.Sq) lr[r0] = m0 * LN2 + logf(l0);
    if (r0 + 8 < a.Sq) lr[r0 + 8] = m1 * LN2 + logf(l1);
  }
  __nv_bfloat16* ob = a.o + b * a.os[0] + h * a.os[2];
#pragma unroll
  for (int jj = 0; jj < NO / 4; ++jj) {
    const int d = 8 * jj + cq;  // D is a multiple of 8, so d + 1 < D too
    if (d >= a.D) continue;
    if (r0 < a.Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)r0 * a.os[1] + d) =
          __floats2bfloat162_rn(o[4 * jj] / l0, o[4 * jj + 1] / l0);
    if (r0 + 8 < a.Sq)
      *reinterpret_cast<__nv_bfloat162*>(
          ob + (long long)(r0 + 8) * a.os[1] + d) =
          __floats2bfloat162_rn(o[4 * jj + 2] / l1, o[4 * jj + 3] / l1);
  }
}

template <int NP>
__global__ void __launch_bounds__(THREADS, 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, const Args a) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t pad = (1024 - (smem_u32(smem_raw) & 1023)) & 1023;
  Smem<NP>& sm = *reinterpret_cast<Smem<NP>*>(smem_raw + pad);

  const int n_qt = (a.Sq + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  // under a causal mask, key tiles past the last query row are all masked
  const int k_end = a.causal ? min(a.Sk, q0 + BQ) : a.Sk;
  const int n_tiles = (k_end + BK - 1) / BK;
  const int wgi = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&sm.k_full[st], 1);
      mbar_init(&sm.v_full[st], 1);
      mbar_init(&sm.empty[st], CONSUMERS * 4);  // lane 0 of each warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // one if-else for the two roles, never reconverging (setmaxnreg needs it)
  if (wgi == CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == CONSUMERS * 128) {
      const int hk = h / a.G;
      mbar_expect_tx(&sm.q_full, NP * PANEL_BYTES);
#pragma unroll
      for (int p = 0; p < NP; ++p)
        tma_load(sm.q[p], &tq, &sm.q_full, 64 * p, h, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % STAGES;
        mbar_wait(&sm.empty[st], ((j / STAGES) & 1) ^ 1);  // round 0 passes
        mbar_expect_tx(&sm.k_full[st], NP * PANEL_BYTES);
#pragma unroll
        for (int p = 0; p < NP; ++p)
          tma_load(sm.k[st][p], &tk, &sm.k_full[st], 64 * p, hk, j * BK, b);
        mbar_expect_tx(&sm.v_full[st], NP * PANEL_BYTES);
#pragma unroll
        for (int p = 0; p < NP; ++p)
          tma_load(sm.v[st][p], &tv, &sm.v_full[st], 64 * p, hk, j * BK, b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    consume<NP>(sm, a, q0, n_tiles, wgi, b, h);
  }
}

template <int NP>
int launch(const void* q, const void* k, const void* v, const Args& a,
           const long long* strides, int B, int H, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  const int KH = H / a.G;
  int err = make_map(&tq, q, a.D, H, a.Sq, B, strides, BQ);
  if (err == 0) err = make_map(&tk, k, a.D, KH, a.Sk, B, strides + 3, BK);
  if (err == 0) err = make_map(&tv, v, a.D, KH, a.Sk, B, strides + 6, BK);
  if (err != 0) return err;
  const int bytes = smem_bytes<NP>();
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_wgmma<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.Sq + BQ - 1) / BQ, H, B);
  flash_fwd_wgmma<NP><<<grid, THREADS, bytes, stream>>>(tq, tk, tv, a);
  return (int)cudaGetLastError();
}

}  // namespace wg

}  // namespace

extern "C" {

// Dynamic shared memory of one thread block for head dim D and dtype (0
// float32, 1 bfloat16); 0 if D > 128.
int flash_attention_fwd_smem_bytes(int D, int dtype) {
  if (D <= 0 || D > 128) return 0;
  if (dtype == typed_io::BF16)
    return D <= 64 ? wg::smem_bytes<1>() : wg::smem_bytes<2>();
  return (D <= 64 ? fma::smem_floats<64>() : fma::smem_floats<128>()) *
         (int)sizeof(float);
}

// strides: 12 values, the (batch, sequence, head) strides in elements of
// q, k, v and out, in that order. lse: null, or (B, H, Sq) fp32 contiguous
// for the rows' log-sum-exp. dtype: 0 float32 (the FMA route), 1
// bfloat16 (the wgmma route: base addresses 16-byte aligned, D a multiple
// of 8, the strides of dimensions longer than 1 multiples of 8 elements).
// Launches on `stream` and returns the status right after the launch (0 =
// launched); does not synchronise and allocates nothing.
int flash_attention_fwd_launch(const void* q, const void* k, const void* v,
                               void* out, float* lse, const long long* strides,
                               int B,
                               int H, int G, int Sq, int Sk, int D,
                               int causal, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || G <= 0 || Sq <= 0 || Sk < 0 || D <= 0 || D > 128 ||
      H % G != 0 || B > 65535 || H > 65535 || (Sq + 63) / 64 > INT_MAX / 2)
    return (int)cudaErrorInvalidValue;
  const float scale = (float)(1.0 / sqrt((double)D));  // f32(1/sqrt(D))
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == typed_io::F32) {
    fma::Args a;
    a.q = q;
    a.k = k;
    a.v = v;
    a.o = out;
    a.lse = lse;
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
    a.scale = scale;
    return D <= 64 ? fma::launch<float, 64>(a, B, H, st)
                   : fma::launch<float, 128>(a, B, H, st);
  }
  if (dtype == typed_io::BF16) {
    if (D % 8 != 0 || (reinterpret_cast<uintptr_t>(out) & 15) != 0)
      return (int)cudaErrorInvalidValue;
    wg::Args a;
    a.o = static_cast<__nv_bfloat16*>(out);
    a.lse = lse;
    for (int i = 0; i < 3; ++i) a.os[i] = strides[9 + i];
    a.Sq = Sq;
    a.Sk = Sk;
    a.G = G;
    a.D = D;
    a.causal = causal;
    a.scale = scale;
    return D <= 64 ? wg::launch<1>(q, k, v, a, strides, B, H, st)
                   : wg::launch<2>(q, k, v, a, strides, B, H, st);
  }
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_fwd_error_string(int status) {
  if (status == hopper::NO_ENCODER)
    return "cuTensorMapEncodeTiled is not available from the driver";
  if (status >= hopper::ENCODE_FAILED)
    return "cuTensorMapEncodeTiled refused an operand's tensor map";
  return cudaGetErrorString((cudaError_t)status);
}

}  // extern "C"
