// wkv6_chunk: the RWKV-6 (Finch) WKV recurrence in chunks of 16 tokens,
// the time-mix core of RWKV-6's prefill.
//
// Replaces the Pallas TPU kernel src/repro/kernels/wkv6.py:_kernel
// (called by wkv6_chunk).
//
// The function, per (batch b, head h), with K = V = head size:
//     y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
//     S_t = diag(exp(lw_t)) S_{t-1} + k_t v_t^T
// r, k, v (B, S, H, K) in float32 or bfloat16, lw (B, S, H, K) float32
// log-decays (<= 0), u (H, K) or (B, H, K) in r's type; the (K, V) state is
// float32, read from s_in (zeros when s_in is null: prefill) and written
// to s_out after the last token, which the TPU kernel keeps in VMEM and
// drops (the model's decode needs it). y (B, S, H, V) in r's type. Every
// tensor contiguous; r, k, v, lw and y 16-byte aligned. Inside a chunk of
// L = 16 tokens, with c the inclusive cumsum of lw and c_excl = c - lw:
//     y_t = (r_t exp(c_excl_t)) S + sum_{j<=t} A_tj v_j,
//     A_tj = sum_k r_tk k_jk exp(c_excl_tk - c_jk)   (j < t: every exponent
//            is <= 0, so none overflows however strong the decays),
//     A_tt = sum_k r_tk u_k k_tk                      (the bonus),
//     S <- exp(c_last) S + (k exp(c_last - c))^T v.
// A ragged last chunk loads zeros past S (lw = 0, k = v = 0), which
// changes neither y nor the state; the TPU wrapper instead shrinks L to a
// divisor of S. The result does not depend on L beyond rounding.
//
// What bounds it on an H100: at RWKV-6-3B's prefill (B 4, S 4096, H 40,
// K = V = 64) the kernel moves r, k, v and y in bf16 and lw in fp32, 506 MB
// in all (0.151 ms at 3.35 TB/s). Per chunk and head it does three small
// products (r~ S, A v, k~^T v: ~0.3 MFLOP, 12 GFLOP in all, 0.025 ms at
// the 495 TFLOP/s of TF32), 7,680 pairwise exponentials plus 2,112 others
// (0.4e9, ~0.1 ms at the SFU's 16 a clock per SM) and ~31k pairwise
// multiply-adds (1.9 GFLOP, 0.03 ms at 67 TFLOP/s): bound by bytes. But
// the chunks of one head run in order, and a head has 256 of them, so what
// the card can reach is set by one chunk's latency on the serial chain.
//
// Design:
//   * 256 threads per (h, b), holding all V columns of the state: a
//     chunk's cumsums, exponentials and A are computed once per head (the
//     first version recomputed them in each of four column-group blocks;
//     only 8 of the 120 pairs are formed twice, by lanes that would idle).
//     When the heads outnumber the SMs, a block runs two heads in step
//     (512 threads, each head on its own shared memory): at the 3B shape,
//     80 blocks of 2 x 103,936 bytes in bf16. Two heads as two blocks on
//     an SM ran slower, and so did one head per block in two waves;
//   * the state-free work is split from the serial chain and the two run
//     side by side, a chunk apart. Warps 0-3 (producers) take chunk c+1:
//     the cumsums (in log2 units: lw is scaled by log2(e) on load, so each
//     exponential is one ex2.approx), r exp(c_excl), k exp(c_last - c),
//     exp(c_last), the 120 pairwise sums of A (each pair's K terms split
//     over 16 lanes, then one 15-shuffle transpose-reduce per 16 pairs) and
//     the bonus, and A v on the tensor cores. Warps 4-7 (consumers) take
//     chunk c's serial part only: y = (r exp(c_excl)) S + A v, stored
//     from their registers, and S <- exp(c_last) S + k~^T v, both products
//     on the tensor cores, the state in their registers as mma
//     accumulators and mirrored to shared memory as the next chunk's B
//     operand. One block-wide barrier per chunk; the
//     producers' phases meet at a named barrier of their own;
//   * every product is mma.sync m16n8k8 TF32 with the 3xTF32 split of
//     mma_tf32.cuh (each step of 8 terms sums its three products from zero
//     and joins the fp32 accumulator by a rounded add): nothing inside is
//     rounded to bf16 or to a single TF32 value;
//   * the next chunks' r, k, v and lw are copied with 16-byte cp.async into
//     a ring (two chunks ahead in bf16, one in fp32) while chunk c is
//     computed;
//   * shared-memory rows are padded (K + 4 floats for an A operand read by
//     rows, K + 8 for a B operand or an accumulator) so fragment loads and
//     stores meet no bank conflict.
//
// What limits it now (chip_smoke.py's launch line, PERF.md): ~5.5x its
// bound. Each role's warps run their chunk's instructions one dependent
// step at a time, so one head alone is latency-bound, and two heads on an
// SM share its issue slots and its tensor and special-function units; not
// memory. Unrolling the consumer's k loop fully made it slower (the
// kernel's code already outgrows the instruction cache), and so did
// rolling phase 2 into a loop of shuffled sums, and a cluster of two
// blocks per head exchanging the state-free terms through distributed
// shared memory.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "mma_tf32.cuh"
#include "typed_io.cuh"

namespace {

using namespace mma_tf32;
using namespace typed_io;

constexpr int L = 16;                    // chunk length
constexpr int CW = 4;                    // consumer warps
constexpr int PRODUCERS = 128;           // 4 producer warps
constexpr int THREADS = PRODUCERS + 32 * CW;   // a head's warps
constexpr int A_LD = L + 4;              // row of the chunk's A
constexpr float LOG2E = 1.4426950408889634f;
constexpr int BAR_PRODUCERS = 1, BAR_CONSUMERS = 2;  // named barriers

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// N consecutive floats from shared memory (N * 4-byte aligned)
template <int N>
__device__ __forceinline__ void lds(float (&d)[N], const float* p) {
  if constexpr (N == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    d[0] = v.x, d[1] = v.y, d[2] = v.z, d[3] = v.w;
  } else if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    d[0] = v.x, d[1] = v.y;
  } else {
    d[0] = p[0];
  }
}

// One step of phase 2's 16-lane transpose-reduce: lanes OFF apart swap
// halves of their OFF live slots, each keeping the half its bit OFF names
// and adding its partner's; after steps 8, 4, 2, 1 lane q holds the sum of
// slot q over the 16 lanes. b2 and b1 are summed outright. (Written out
// per step: a loop over OFF would leave part[] in local memory.)
template <int OFF>
__device__ __forceinline__ void reduce_step(float (&part)[16], int lane16,
                                            float& b2, float& b1) {
  const bool upper = (lane16 & OFF) != 0;
#pragma unroll
  for (int i = 0; i < OFF; ++i) {
    const float send = upper ? part[i] : part[i + OFF];
    const float keep = upper ? part[i + OFF] : part[i];
    part[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
  }
  b2 += __shfl_xor_sync(0xffffffffu, b2, OFF);
  b1 += __shfl_xor_sync(0xffffffffu, b1, OFF);
}

// four consecutive elements from shared memory as floats (8- or 16-byte
// aligned)
template <typename T>
__device__ __forceinline__ float4 load4(const T* p);
template <>
__device__ __forceinline__ float4 load4<float>(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
template <>
__device__ __forceinline__ float4 load4<__nv_bfloat16>(
    const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// two consecutive outputs to global memory in one store
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// shared memory of one block, in bytes from the start; every array starts
// on a 16-byte boundary
template <typename T, int K>
struct Layout {
  static constexpr int KR = K + 4;   // rows read as an A operand
  static constexpr int KB = K + 8;   // rows read as B or written as D
  // the ring: RING slots of r, k, v (T) and lw (f32) as loaded, [L][K];
  // three in bf16, two in fp32 (a third would keep fp32 at one block per
  // SM at K = 64)
  static constexpr int RING = sizeof(T) == 2 ? 3 : 2;
  static constexpr int RAW_T = L * K * (int)sizeof(T);
  static constexpr int RAW = 3 * RAW_T + L * K * 4;
  // two chunk slots of the producers' results: rd = r exp(c_excl) [L][KR],
  // kd = k exp(c_last - c) [L][KB], v [L][KB], A v [L][KB], exp(c_last) [K]
  static constexpr int SLOT = L * KR + 3 * L * KB + K;
  // producer scratch: r, k, c, c_excl [L][K] (log2 units), A [L][A_LD], u
  static constexpr int SCRATCH = 4 * L * K + L * A_LD + K;
  static constexpr int STATE = K * KB;   // the state, as a B operand
  static constexpr int BYTES =
      RING * RAW + 4 * (2 * SLOT + SCRATCH + STATE);
};

// HPB heads per block (1 or 2): the wrapper runs two when the heads
// outnumber the SMs, so a second head shares its SM in step with the
// first (same code, 128 registers a thread) rather than as a second block
// on its own schedule; one head alone may take up to 255 registers
template <typename T, int K, int HPB>
__global__ void __launch_bounds__(HPB * THREADS, 1)
wkv6_chunk_kernel(const T* __restrict__ r, const T* __restrict__ k,
                  const T* __restrict__ v, const float* __restrict__ lw,
                  const T* __restrict__ u, const float* __restrict__ s_in,
                  T* __restrict__ y, float* __restrict__ s_out, int B, int S,
                  int H, long long u_sb) {
  using Lay = Layout<T, K>;
  constexpr int KR = Lay::KR, KB = Lay::KB;
  constexpr int NT = K / 8, MT = K / 16;      // 8-column, 16-row mma tiles
  constexpr int NTW = (NT + CW - 1) / CW;     // y tiles per consumer warp
  constexpr int SPW = (MT * NT + CW - 1) / CW;  // state tiles per consumer
                                                // warp
  constexpr int KPT = K / 16;                 // K terms per lane of a pair
  static_assert(NT % SPW == 0, "a consumer warp's tiles share a tile row");
  extern __shared__ __align__(16) unsigned char smem_all[];
  // each of the block's HPB heads runs on its own THREADS threads and
  // its own shared memory, in step with the others
  const int grp = threadIdx.x / THREADS;
  unsigned char* smem = smem_all + grp * Lay::BYTES;
  const int bar_p = BAR_PRODUCERS + 2 * grp, bar_c = BAR_CONSUMERS + 2 * grp;
  const int hb = blockIdx.x * HPB + grp;
  const bool valid = hb < B * H;   // a spare head in the last block
                                   // reruns head 0 and writes nothing
  constexpr int RING = Lay::RING;
  float* slots = reinterpret_cast<float*>(smem + RING * Lay::RAW);
  float* rf = slots + 2 * Lay::SLOT;
  float* kf = rf + L * K;
  float* c2 = kf + L * K;
  float* ce2 = c2 + L * K;
  float* Am = ce2 + L * K;
  float* us = Am + L * A_LD;
  float* Sb = us + K;

  const int h = valid ? hb % H : 0, b = valid ? hb / H : 0;
  const int tid = threadIdx.x % THREADS, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const long long ss = (long long)H * K;     // token stride
  const long long head = (long long)b * S * ss + (long long)h * K;
  const long long st = ((long long)b * H + h) * K * K;  // state (K, V)
  const int n_chunks = (S + L - 1) / L;

  // the chunk slot's arrays
  auto rd_of = [&](int s) { return slots + s * Lay::SLOT; };
  auto kd_of = [&](int s) { return rd_of(s) + L * KR; };
  auto vf_of = [&](int s) { return kd_of(s) + L * KB; };
  auto yl_of = [&](int s) { return vf_of(s) + L * KB; };
  auto wl_of = [&](int s) { return yl_of(s) + L * KB; };
  auto raw_of = [&](int c) {  // chunk c's ring slot
    return smem + (c % RING) * Lay::RAW;
  };

  // producers: copy chunk c's rows into its ring slot, zeros past S
  auto load_chunk = [&](int c) {
    T* rr = reinterpret_cast<T*>(raw_of(c));
    T* kr = rr + L * K;
    T* vr = kr + L * K;
    float* lr = reinterpret_cast<float*>(raw_of(c) + 3 * Lay::RAW_T);
    constexpr int PT = K * (int)sizeof(T) / 16, ET = 16 / (int)sizeof(T);
    for (int e = tid; e < L * PT; e += PRODUCERS) {
      const int row = e / PT, col = (e % PT) * ET;
      const bool in = c * L + row < S;
      const long long at = head + (long long)(c * L + row) * ss + col;
      const int n = in ? 16 : 0;
      cp_async<16>(rr + row * K + col, in ? r + at : r, n);
      cp_async<16>(kr + row * K + col, in ? k + at : k, n);
      cp_async<16>(vr + row * K + col, in ? v + at : v, n);
    }
    for (int e = tid; e < L * K / 4; e += PRODUCERS) {
      const int row = e / (K / 4), col = (e % (K / 4)) * 4;
      const bool in = c * L + row < S;
      const long long at = head + (long long)(c * L + row) * ss + col;
      cp_async<16>(lr + row * K + col, in ? lw + at : lw, in ? 16 : 0);
    }
  };

  // ---- set-up: the bonus row, A's upper triangle, the initial state ----
  for (int e = tid; e < K; e += THREADS)
    us[e] = load(u + b * u_sb + h * K + e);
  for (int e = tid; e < L * A_LD; e += THREADS) Am[e] = 0.f;
  const int cw = warp - 4;   // consumer warp
  float Sacc[SPW][4];
#pragma unroll
  for (int q = 0; q < SPW; ++q) {
    const int idx = cw * SPW + q;
    const int m = idx / NT, nn = idx % NT;
    const int r0 = m * 16 + g, c0 = nn * 8 + 2 * t;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + 8 * (e / 2), col = c0 + e % 2;
      Sacc[q][e] = 0.f;
      if (warp >= 4 && idx < MT * NT) {
        if (s_in != nullptr) Sacc[q][e] = s_in[st + (long long)row * K + col];
        Sb[row * KB + col] = Sacc[q][e];
      }
    }
  }
  if (warp < 4) {
#pragma unroll
    for (int c = 0; c < RING - 1; ++c) {
      if (c < n_chunks) load_chunk(c);
      cp_async_commit();  // an empty group keeps the count uniform
    }
  }
  __syncthreads();

  // ---- the chunks: producers on chunk it, consumers on chunk it - 1 ----
  for (int it = 0; it <= n_chunks; ++it) {
    if (warp < 4) {
      const int ptid = tid;
      if (it + RING - 1 < n_chunks) load_chunk(it + RING - 1);
      cp_async_commit();
      if (it < n_chunks) {
        const int s = it & 1;
        cp_async_wait<RING - 1>();  // this thread's copies of chunk it
        bar_sync(bar_p, PRODUCERS);

        // phase 1: cumsums and the decayed rows, one column per thread
        const T* rr = reinterpret_cast<const T*>(raw_of(it));
        const T* kr = rr + L * K;
        const T* vr = kr + L * K;
        const float* lr =
            reinterpret_cast<const float*>(raw_of(it) + 3 * Lay::RAW_T);
        float* vf = vf_of(s);
        for (int e = 4 * ptid; e < L * K; e += 4 * PRODUCERS)
          *reinterpret_cast<float4*>(vf + (e / K) * KB + e % K) =
              load4(vr + e);
        // each column's loads first: the stores below may alias them as
        // far as the compiler knows, and would hold every load back
        if (ptid < K) {           // r exp(c_excl); c and c_excl for A
          const int kk = ptid;
          float* rd = rd_of(s);
          float rv[L], lv[L];
#pragma unroll
          for (int tt = 0; tt < L; ++tt) {
            rv[tt] = load(rr + tt * K + kk);
            lv[tt] = lr[tt * K + kk];
          }
          float c = 0.f;
#pragma unroll
          for (int tt = 0; tt < L; ++tt) {
            rf[tt * K + kk] = rv[tt];
            ce2[tt * K + kk] = c;
            rd[tt * KR + kk] = rv[tt] * ex2(c);
            c += lv[tt] * LOG2E;
            c2[tt * K + kk] = c;
          }
        } else if (ptid < 2 * K) {  // k exp(c_last - c), exp(c_last)
          const int kk = ptid - K;
          float* kd = kd_of(s);
          float cs[L], kv[L];
          float c = 0.f;
#pragma unroll
          for (int tt = 0; tt < L; ++tt) {
            c += lr[tt * K + kk] * LOG2E;
            cs[tt] = c;
            kv[tt] = load(kr + tt * K + kk);
          }
          wl_of(s)[kk] = ex2(c);
#pragma unroll
          for (int tt = 0; tt < L; ++tt) {
            kf[tt * K + kk] = kv[tt];
            kd[tt * KB + kk] = kv[tt] * ex2(c - cs[tt]);
          }
        }
        bar_sync(bar_p, PRODUCERS);

        // phase 2: A. Sixteen lanes per pair of rows (t2, t1), t1 + t2 = 16
        // (and (8, 0)), each lane over K / 16 of the terms. Evaluation
        // e < t2 is pair (t2, e), else (t1, e - t2): sixteen independent
        // evaluations, then one transpose-reduce leaves evaluation e's sum
        // over the 16 lanes in lane e
        {
          const int grp = ptid / 16, kq = ptid % 16, k0 = kq * KPT;
          const int t2 = 15 - grp, t1 = grp == 7 ? 0 : grp + 1;
          float r2[KPT], e2[KPT], r1[KPT], e1[KPT], k2[KPT], k1[KPT];
          float u_[KPT];
          lds(r2, rf + t2 * K + k0);
          lds(e2, ce2 + t2 * K + k0);
          lds(r1, rf + t1 * K + k0);
          lds(e1, ce2 + t1 * K + k0);
          lds(k2, kf + t2 * K + k0);
          lds(k1, kf + t1 * K + k0);
          lds(u_, us + k0);
          float part[16];
#pragma unroll
          for (int e = 0; e < 16; ++e) {
            // the last group's second half (t1 = 0 has no pairs) repeats
            // pairs (8, j < 8) in lanes that would idle, and drops them: a
            // guard here made the launch 13% slower. t2 >= 8, so the first
            // eight evaluations are row t2's, known at compile time
            const bool first = e < 8 || e < t2 || t1 == 0;
            const int j = (e < 8 || e < t2) ? e : e - t2;
            float cj[KPT], kj[KPT];
            lds(cj, c2 + j * K + k0);
            lds(kj, kf + j * K + k0);
            float p = 0.f;
#pragma unroll
            for (int i = 0; i < KPT; ++i)
              p = fmaf((first ? r2[i] : r1[i]) * kj[i],
                       ex2((first ? e2[i] : e1[i]) - cj[i]), p);
            part[e] = p;
          }
          float b2 = 0.f, b1 = 0.f;   // the bonus of rows t2 and t1
#pragma unroll
          for (int i = 0; i < KPT; ++i) {
            b2 = fmaf(r2[i] * u_[i], k2[i], b2);
            b1 = fmaf(r1[i] * u_[i], k1[i], b1);
          }
          reduce_step<8>(part, kq, b2, b1);
          reduce_step<4>(part, kq, b2, b1);
          reduce_step<2>(part, kq, b2, b1);
          reduce_step<1>(part, kq, b2, b1);
          if (kq < t2)
            Am[t2 * A_LD + kq] = part[0];
          else if (kq - t2 < t1)
            Am[t1 * A_LD + kq - t2] = part[0];
          if (kq == 0) {
            Am[t2 * A_LD + t2] = b2;
            Am[t1 * A_LD + t1] = b1;
          }
        }
        bar_sync(bar_p, PRODUCERS);

        // phase 3: y = A v on the tensor cores, into the slot's y
        {
          uint32_t ah[2][4], al[2][4];
          load_a(Am, A_LD, g, t, ah[0], al[0]);
          load_a(Am + 8, A_LD, g, t, ah[1], al[1]);
          float* yl = yl_of(s);
#pragma unroll
          for (int q = 0; q < NTW; ++q) {
            const int nn = warp + 4 * q;
            if (NT % 4 != 0 && nn >= NT) break;
            float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int ks = 0; ks < 2; ++ks) {
              uint32_t bh[2], bl[2];
              load_b(vf + ks * 8 * KB + nn * 8, KB, g, t, bh, bl);
              mma_step(acc, ah[ks], al[ks], bh, bl);
            }
            *reinterpret_cast<float2*>(yl + g * KB + nn * 8 + 2 * t) =
                make_float2(acc[0], acc[1]);
            *reinterpret_cast<float2*>(yl + (g + 8) * KB + nn * 8 + 2 * t) =
                make_float2(acc[2], acc[3]);
          }
        }
      }
    } else if (it >= 1 && it <= n_chunks) {
      // consumers: chunk it-1's serial part
      const int s = (it - 1) & 1;
      const float* rd = rd_of(s);
      const float* kd = kd_of(s);
      const float* vf = vf_of(s);
      const float* wl = wl_of(s);
      float* yl = yl_of(s);
      // y += (r exp(c_excl)) S, S as it stood before this chunk
      float yacc[NTW][4];
#pragma unroll
      for (int q = 0; q < NTW; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) yacc[q][e] = 0.f;
#pragma unroll 2   // fully unrolled was slower: the code outgrows the
      for (int k8 = 0; k8 < K; k8 += 8) {  // instruction cache
        uint32_t ah[4], al[4];
        load_a(rd + k8, KR, g, t, ah, al);
#pragma unroll
        for (int q = 0; q < NTW; ++q) {
          const int nn = cw + CW * q;
          if (NT % CW != 0 && nn >= NT) break;
          uint32_t bh[2], bl[2];
          load_b(Sb + k8 * KB + nn * 8, KB, g, t, bh, bl);
          mma_step(yacc[q], ah, al, bh, bl);
        }
      }
      // S <- exp(c_last) S + (k exp(c_last - c))^T v, in registers. A
      // warp's state tiles share one row of tiles (NT % SPW == 0), so the
      // k~^T fragments are split once for all of them
      {
        const int m = cw * SPW / NT;
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int ks = 0; ks < 2; ++ks)
          load_a_t(kd + ks * 8 * KB + m * 16, KB, g, t, ah[ks], al[ks]);
        const float w0 = wl[m * 16 + g], w1 = wl[m * 16 + g + 8];
#pragma unroll
        for (int q = 0; q < SPW; ++q) {
          const int idx = cw * SPW + q;
          if (MT * NT % CW != 0 && idx >= MT * NT) break;
          const int nn = idx % NT;
          Sacc[q][0] *= w0;
          Sacc[q][1] *= w0;
          Sacc[q][2] *= w1;
          Sacc[q][3] *= w1;
#pragma unroll
          for (int ks = 0; ks < 2; ++ks) {
            uint32_t bh[2], bl[2];
            load_b(vf + ks * 8 * KB + nn * 8, KB, g, t, bh, bl);
            mma_step(Sacc[q], ah[ks], al[ks], bh, bl);
          }
        }
      }
      // the intra-chunk part A v, from the producers, joins y, which goes
      // out from here (staging it for coalesced stores was slower)
#pragma unroll
      for (int q = 0; q < NTW; ++q) {
        const int nn = cw + CW * q;
        if (NT % CW != 0 && nn >= NT) break;
        float2* p0 = reinterpret_cast<float2*>(yl + g * KB + nn * 8 + 2 * t);
        float2* p1 =
            reinterpret_cast<float2*>(yl + (g + 8) * KB + nn * 8 + 2 * t);
        const float2 a = *p0, c = *p1;
        const int row0 = (it - 1) * L + g, col = nn * 8 + 2 * t;
        if (valid && row0 < S)
          store2(y + head + (long long)row0 * ss + col, yacc[q][0] + a.x,
                 yacc[q][1] + a.y);
        if (valid && row0 + 8 < S)
          store2(y + head + (long long)(row0 + 8) * ss + col,
                 yacc[q][2] + c.x, yacc[q][3] + c.y);
      }
      bar_sync(bar_c, THREADS - PRODUCERS);  // S fully read
#pragma unroll
      for (int q = 0; q < SPW; ++q) {
        const int idx = cw * SPW + q;
        if (MT * NT % CW != 0 && idx >= MT * NT) break;
        const int m = idx / NT, nn = idx % NT;
        float* p = Sb + (m * 16 + g) * KB + nn * 8 + 2 * t;
        *reinterpret_cast<float2*>(p) = make_float2(Sacc[q][0], Sacc[q][1]);
        *reinterpret_cast<float2*>(p + 8 * KB) =
            make_float2(Sacc[q][2], Sacc[q][3]);
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();  // no copy outlives the block

  if (warp >= 4 && valid) {
#pragma unroll
    for (int q = 0; q < SPW; ++q) {
      const int idx = cw * SPW + q;
      if (MT * NT % CW != 0 && idx >= MT * NT) break;
      const int m = idx / NT, nn = idx % NT;
      float* p = s_out + st + (long long)(m * 16 + g) * K + nn * 8 + 2 * t;
      *reinterpret_cast<float2*>(p) = make_float2(Sacc[q][0], Sacc[q][1]);
      *reinterpret_cast<float2*>(p + 8 * K) =
          make_float2(Sacc[q][2], Sacc[q][3]);
    }
  }
}

template <typename T, int K, int HPB>
int launch(const void* r, const void* k, const void* v, const float* lw,
           const void* u, const float* s_in, void* y, float* s_out, int B,
           int S, int H, long long u_sb, cudaStream_t stream) {
  const int bytes = HPB * Layout<T, K>::BYTES;
  const cudaError_t err = cudaFuncSetAttribute(
      wkv6_chunk_kernel<T, K, HPB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const long long heads = (long long)B * H;
  wkv6_chunk_kernel<T, K, HPB><<<(unsigned)((heads + HPB - 1) / HPB),
                                 HPB * THREADS, bytes, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), lw, static_cast<const T*>(u), s_in,
      static_cast<T*>(y), s_out, B, S, H, u_sb);
  return (int)cudaGetLastError();
}

template <typename T, int HPB>
int launch_k(int K, const void* r, const void* k, const void* v,
             const float* lw, const void* u, const float* s_in, void* y,
             float* s_out, int B, int S, int H, long long u_sb,
             cudaStream_t st) {
  switch (K) {
    case 16:
      return launch<T, 16, HPB>(r, k, v, lw, u, s_in, y, s_out, B, S, H, u_sb,
                                st);
    case 32:
      return launch<T, 32, HPB>(r, k, v, lw, u, s_in, y, s_out, B, S, H, u_sb,
                                st);
    case 64:
      return launch<T, 64, HPB>(r, k, v, lw, u, s_in, y, s_out, B, S, H, u_sb,
                                st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch_h(int hpb, int K, const void* r, const void* k, const void* v,
             const float* lw, const void* u, const float* s_in, void* y,
             float* s_out, int B, int S, int H, long long u_sb,
             cudaStream_t st) {
  if (hpb == 1)
    return launch_k<T, 1>(K, r, k, v, lw, u, s_in, y, s_out, B, S, H, u_sb,
                          st);
  if (hpb == 2)
    return launch_k<T, 2>(K, r, k, v, lw, u, s_in, y, s_out, B, S, H, u_sb,
                          st);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int smem_k(int K) {
  switch (K) {
    case 16: return Layout<T, 16>::BYTES;
    case 32: return Layout<T, 32>::BYTES;
    case 64: return Layout<T, 64>::BYTES;
    default: return -1;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory of one thread block of hpb heads (-1 for a K or
// dtype it does not take).
int wkv6_chunk_smem_bytes(int K, int dtype, int hpb) {
  if (dtype == typed_io::F32) return hpb * smem_k<float>(K);
  if (dtype == typed_io::BF16) return hpb * smem_k<__nv_bfloat16>(K);
  return -1;
}

// r, k, v, lw and y: (B, S, H, K) contiguous, 16-byte aligned; u: (H, K)
// when u_sb is 0, else (B, H, K) with u_sb = H * K; s_in (may be null:
// zeros) and s_out: (B, H, K, K) float32. K is 16, 32 or 64. dtype: 0
// float32, 1 bfloat16 (r, k, v, u and y). hpb: heads per thread block, 1
// or 2 (kernels/wkv6.py: heads_per_block). Launches on `stream` and returns
// the CUDA status right after the launch (0 = launched); does not
// synchronise and allocates nothing.
int wkv6_chunk_launch(const void* r, const void* k, const void* v,
                      const float* lw, const void* u, const float* s_in,
                      void* y, float* s_out, int B, int S, int H, int K,
                      long long u_sb, int dtype, int hpb, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || (long long)B * H > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const uintptr_t a = reinterpret_cast<uintptr_t>(r)
                      | reinterpret_cast<uintptr_t>(k)
                      | reinterpret_cast<uintptr_t>(v)
                      | reinterpret_cast<uintptr_t>(lw)
                      | reinterpret_cast<uintptr_t>(y);
  if ((a & 15) != 0) return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == typed_io::F32)
    return launch_h<float>(hpb, K, r, k, v, lw, u, s_in, y, s_out, B, S, H,
                           u_sb, st);
  if (dtype == typed_io::BF16)
    return launch_h<__nv_bfloat16>(hpb, K, r, k, v, lw, u, s_in, y, s_out, B,
                                   S, H, u_sb, st);
  return (int)cudaErrorInvalidValue;
}

const char* wkv6_chunk_error_string(int status) {
  return cudaGetErrorString((cudaError_t)status);
}

}  // extern "C"
