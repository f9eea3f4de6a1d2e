// Flash attention backward (causal, full, sliding-window; GQA; T != S) for
// Hopper (sm_90a), plain C interface.
//
// Replaces no TPU kernel: the Pallas package has no backward for
// flash_attention_pallas (off the TPU JAX differentiates its plain jnp
// path).  Added so that training every attention arch runs its gradient on
// the card through a hand-written kernel: the counterpart of the forward in
// flash_attention.cu, whose `lse` output (each row's natural log-sum-exp of
// scale * q.k) it reads to recompute P without a second softmax.
//
//   P = exp(scale q k^T - lse) on the visible pairs (the forward's Mask),
//   dV = P^T dO,  dP = dO V^T,  delta = rowsum(dO o O),
//   dS = P o (dP - delta),  dQ = scale dS K,  dK = scale dS^T Q,
//
// with dK and dV summed over the query heads of each KV head's group.
//
// What bounds it: operations.  Five products over the visible pairs (S, dP,
// dV, dK, dQ: 10 D flops a pair, 2.5 times the forward); at Gemma3's
// training shape (B=1, Hq 4, T=4096, D=256, causal) about 8.6e10 flops,
// 87 us at 989 TFLOP/s bf16, against 42 MB of q/k/v/o/dO/dq/dk/dv.
//
// Design (FA2's, deterministic: no atomics).  Three launches on one stream:
// - `delta`: one warp a row, rowsum(dO o O) in f32.
// - dK/dV: one block per (batch, KV head, 64 keys); each of its 4 warps
//   owns 16 keys and keeps their dK and dV rows in registers (mma.sync
//   accumulators) while the block walks, for every query head of the group
//   and every tile of queries the mask lets see its keys (`query_range`),
//   the Q and dO tiles through shared memory: S^T = K Q^T, P^T from the
//   saved lse, dV += P^T dO, dP^T = V dO^T, dS^T, dK += dS^T Q.  The GQA
//   sum stays inside the block.  At D = 256 the dK and dV rows together
//   would take 256 registers a thread, so the block sweeps twice: dV first,
//   then dK (S recomputed: six products instead of five).
// - dQ: one block per (batch, query head, 64 queries), 16 a warp, walking
//   the key tiles its rows see: S = Q K^T, dP = dO V^T, dS, dQ += dS K.
// bf16 runs on the tensor cores through mma.sync.m16n8k16 (f32 sums),
// fragments loaded by ldmatrix (.trans where the product wants the tile's
// columns) from rows padded by 16 bytes, so the 8 rows of each 8x8 matrix
// fall in distinct banks; P and dS are rounded to bf16 as the product's A
// operand.  A dK/dV block's query tiles shrink to 32 at D >= 64, and a dQ
// block's key tiles at D >= 128, so the accumulators, S and dP fit a
// thread's registers without spilling.
// float32 (the reduced models, and the qwen2-100m example at D = 96) runs
// on CUDA cores with f32 products throughout (no TF32): dK/dV blocks of 32
// keys (8 a warp, lanes over the output columns), dQ blocks of 16 queries
// (4 a warp, a lane a key of the tile, as the forward's f32 kernel).
// Later work: wgmma and TMA (as the forward), a persistent schedule that
// balances the causal triangle's uneven blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_mask.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int NT = 128;              // threads of every block but delta's: 4 warps

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a b: a 16x16 bf16 (4 registers), b 16x8 bf16 (2), d 16x8 f32.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// delta = rowsum(dO o O), f32
// ---------------------------------------------------------------------------

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T>
__global__ void __launch_bounds__(NT, 1) flash_bwd_delta_kernel(const T* __restrict__ o,
                                                             const T* __restrict__ dout,
                                                             float* __restrict__ delta,
                                                             long rows, int D) {
  const long row = (long)blockIdx.x * (NT / 32) + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  float s = 0.f;
  for (int c = lane; c < D; c += 32)
    s = fmaf(to_f32(o[row * D + c]), to_f32(dout[row * D + c]), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) delta[row] = s;
}

// ---------------------------------------------------------------------------
// bf16: mma.sync
// ---------------------------------------------------------------------------

template <int D>
struct BwdPlan {
  static constexpr int LD = D + 8;                // padded shared row, elements
  static constexpr int BKV = 64;                  // keys of a dK/dV block, 16 a warp
  static constexpr int BQ = D >= 64 ? 32 : 64;    // queries of a dK/dV block's tile
  static constexpr int BKQ = D >= 128 ? 32 : 64;  // keys of a dQ block's tile
  static constexpr bool SPLIT = D == 256;         // dV, then dK, in two sweeps
  static constexpr int SMEM_KV = (2 * BKV + 2 * BQ) * LD * 2 + 2 * BQ * 4;
  static constexpr int SMEM_Q = (2 * 64 + 2 * BKQ) * LD * 2;
};

// Rows [r0, r0 + n) of a (rows, D) bf16 matrix into shared memory at stride
// LD, 16 bytes a thread a step; rows at or past `rows` are zero.
template <int D, int LD>
__device__ __forceinline__ void load_rows(bf16* s, const bf16* __restrict__ g, int r0, int n,
                                          int rows) {
  constexpr int VPR = D / 8;
  for (int i = threadIdx.x; i < n * VPR; i += NT) {
    const int r = i / VPR, c = (i - r * VPR) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < rows) val = *reinterpret_cast<const uint4*>(g + (size_t)(r0 + r) * D + c);
    *reinterpret_cast<uint4*>(s + r * LD + c) = val;
  }
}

// s (16 x 8 NB) = Y[r0 .. r0 + 16) X^T: Y's rows and X's NB * 8 rows are
// both D wide in shared memory at stride LD (the product runs over D).
template <int D, int LD, int NB>
__device__ __forceinline__ void mma_rows_xt(float (&s)[NB][4], uint32_t sY, int r0, uint32_t sX,
                                            int lane) {
#pragma unroll
  for (int i = 0; i < NB; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    uint32_t a[4];
    ldsm_x4(a, sY + ((r0 + (lane & 15)) * LD + ks * 16 + (lane >> 4) * 8) * 2);
#pragma unroll
    for (int nb = 0; nb < NB / 2; ++nb) {
      uint32_t b[4];
      ldsm_x4(b, sX + ((nb * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + ks * 16 +
                       ((lane >> 3) & 1) * 8) * 2);
      mma16816(s[2 * nb], a, b[0], b[1]);
      mma16816(s[2 * nb + 1], a, b[2], b[3]);
    }
  }
}

// acc (16 x D) += A X: A the bf16 fragments of KS k16 steps (16 x 16 KS), X
// the KS * 16 rows of a D-wide tile in shared memory at stride LD.
template <int D, int LD, int KS>
__device__ __forceinline__ void mma_acc(float (&acc)[D / 8][4], const uint32_t (&a)[KS][4],
                                        uint32_t sX, int lane) {
#pragma unroll
  for (int j = 0; j < KS; ++j)
#pragma unroll
    for (int nd = 0; nd < D / 16; ++nd) {
      uint32_t b[4];
      ldsm_x4_t(b, sX + ((j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + nd * 16 +
                         (lane >> 4) * 8) * 2);
      mma16816(acc[2 * nd], a[j], b[0], b[1]);
      mma16816(acc[2 * nd + 1], a[j], b[2], b[3]);
    }
}

// The accumulator tiles of a 16 x 16 KS product, rounded to bf16, as the
// A fragments of the next product's KS k16 steps.
template <int KS>
__device__ __forceinline__ void pack_a(uint32_t (&a)[KS][4], const float (&s)[2 * KS][4]) {
#pragma unroll
  for (int j = 0; j < KS; ++j) {
    a[j][0] = pack_bf16(s[2 * j][0], s[2 * j][1]);
    a[j][1] = pack_bf16(s[2 * j][2], s[2 * j][3]);
    a[j][2] = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
    a[j][3] = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
  }
}

template <int D>
__device__ __forceinline__ void zero_acc(float (&acc)[D / 8][4]) {
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
}

// Rows r_lo (+ 8) of a warp's 16-row accumulator, times `mul`, as bf16.
template <int D>
__device__ __forceinline__ void store_acc(bf16* __restrict__ g, const float (&acc)[D / 8][4],
                                          int r_lo, int rows, float mul, int lane) {
  const int col0 = 2 * (lane % 4);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r_lo + lane / 4 + 8 * h;
    if (r >= rows) continue;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
      *reinterpret_cast<__nv_bfloat162*>(g + (size_t)r * D + nd * 8 + col0) =
          __floats2bfloat162_rn(acc[nd][2 * h] * mul, acc[nd][2 * h + 1] * mul);
  }
}

template <int D>
__global__ void __launch_bounds__(NT, 1) flash_bwd_dkdv_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv, int Hq,
    int Hkv, Mask mask, float scale) {
  using P = BwdPlan<D>;
  constexpr int LD = P::LD, BQ = P::BQ, NB = BQ / 8, KS = BQ / 16;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + P::BKV * LD;
  bf16* sQ = sV + P::BKV * LD;
  bf16* sO = sQ + BQ * LD;                                  // the dO tile
  float* sL = reinterpret_cast<float*>(sO + BQ * LD);       // lse * log2 e of its rows
  float* sDl = sL + BQ;                                     // delta of its rows

  const int group = Hq / Hkv;
  const int bkv = blockIdx.y, b = bkv / Hkv, hkv = bkv - b * Hkv;
  const int k0 = blockIdx.x * P::BKV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kw = k0 + warp * 16;                 // this warp's keys kw .. kw + 15
  const size_t kv_off = (size_t)bkv * mask.S * D;
  load_rows<D, LD>(sK, k + kv_off, k0, P::BKV, mask.S);
  load_rows<D, LD>(sV, v + kv_off, k0, P::BKV, mask.S);
  int qlo, qhi, wlo, whi;
  mask.query_range(k0, k0 + P::BKV, qlo, qhi);
  mask.query_range(kw, kw + 16, wlo, whi);
  const bool w_any = kw < mask.S && wlo < whi;
  const float sl2 = scale * kLog2e;
  const uint32_t aK = smem_addr(sK), aV = smem_addr(sV), aQ = smem_addr(sQ),
                 aO = smem_addr(sO);
  const int g = lane / 4, c2 = 2 * (lane % 4);

  float acc_a[D / 8][4];                        // dV; dK in the second sweep at D = 256
  float acc_b[D / 8][4];                        // dK (one sweep; unused at D = 256)
  for (int pass = 0; pass < (P::SPLIT ? 2 : 1); ++pass) {
    const bool want_dv = pass == 0, want_dk = !P::SPLIT || pass == 1;
    zero_acc<D>(acc_a);
    if constexpr (!P::SPLIT) zero_acc<D>(acc_b);
    for (int gi = 0; gi < group; ++gi) {
      const int bh = b * Hq + hkv * group + gi;
      const size_t q_off = (size_t)bh * mask.T * D;
      for (int q0 = (qlo / BQ) * BQ; q0 < qhi; q0 += BQ) {
        __syncthreads();                        // the previous tile is consumed
        load_rows<D, LD>(sQ, q + q_off, q0, BQ, mask.T);
        load_rows<D, LD>(sO, dout + q_off, q0, BQ, mask.T);
        for (int i = threadIdx.x; i < BQ; i += NT) {
          const bool in = q0 + i < mask.T;
          sL[i] = in ? lse[(size_t)bh * mask.T + q0 + i] * kLog2e : INFINITY;
          sDl[i] = in ? delta[(size_t)bh * mask.T + q0 + i] : 0.f;
        }
        __syncthreads();
        if (!w_any || whi <= q0 || wlo >= q0 + BQ) continue;   // warp-uniform
        const bool whole = mask.all_visible(q0, q0 + BQ, kw, kw + 16);
        // S^T (16 keys x BQ queries), then P^T in place.
        float s[NB][4];
        mma_rows_xt<D, LD, NB>(s, aK, warp * 16, aQ, lane);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = nb * 8 + c2 + (e & 1), key = kw + g + 8 * (e >> 1);
            const float p = exp2f(s[nb][e] * sl2 - sL[qi]);
            s[nb][e] = whole || mask.visible(q0 + qi, key) ? p : 0.f;
          }
        uint32_t pa[KS][4];
        pack_a<KS>(pa, s);
        if (want_dv) mma_acc<D, LD, KS>(acc_a, pa, aO, lane);
        if (want_dk) {
          float dp[NB][4];
          mma_rows_xt<D, LD, NB>(dp, aV, warp * 16, aO, lane);
#pragma unroll
          for (int nb = 0; nb < NB; ++nb)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              dp[nb][e] = s[nb][e] * (dp[nb][e] - sDl[nb * 8 + c2 + (e & 1)]);
          pack_a<KS>(pa, dp);
          if constexpr (P::SPLIT)
            mma_acc<D, LD, KS>(acc_a, pa, aQ, lane);
          else
            mma_acc<D, LD, KS>(acc_b, pa, aQ, lane);
        }
      }
    }
    if (want_dv) store_acc<D>(dv + kv_off, acc_a, kw, mask.S, 1.f, lane);
    if constexpr (P::SPLIT) {
      if (pass == 1) store_acc<D>(dk + kv_off, acc_a, kw, mask.S, scale, lane);
    } else {
      store_acc<D>(dk + kv_off, acc_b, kw, mask.S, scale, lane);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NT, 1) flash_bwd_dq_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dq, int Hq, int Hkv, Mask mask,
    float scale) {
  using P = BwdPlan<D>;
  constexpr int LD = P::LD, BK = P::BKQ, NB = BK / 8, KS = BK / 16;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sO = sQ + 64 * LD;
  bf16* sK = sO + 64 * LD;
  bf16* sV = sK + BK * LD;

  const int bh = blockIdx.y, b = bh / Hq, hq = bh - b * Hq;
  const int bkv = b * Hkv + hq / (Hq / Hkv);
  const int q0 = blockIdx.x * 64;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rw = q0 + warp * 16;                 // this warp's rows rw .. rw + 15
  const size_t q_off = (size_t)bh * mask.T * D, kv_off = (size_t)bkv * mask.S * D;
  load_rows<D, LD>(sQ, q + q_off, q0, 64, mask.T);
  load_rows<D, LD>(sO, dout + q_off, q0, 64, mask.T);
  const int g = lane / 4, c2 = 2 * (lane % 4);
  float l2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = rw + g + 8 * h;
    l2[h] = r < mask.T ? lse[(size_t)bh * mask.T + r] * kLog2e : INFINITY;
    dl[h] = r < mask.T ? delta[(size_t)bh * mask.T + r] : 0.f;
  }
  int lo, hi, wlo, whi;
  mask.key_range(q0, q0 + 64, lo, hi);
  mask.key_range(rw, rw + 16, wlo, whi);
  const bool w_any = rw < mask.T && wlo < whi;
  const float sl2 = scale * kLog2e;
  const uint32_t aK = smem_addr(sK), aV = smem_addr(sV), aQ = smem_addr(sQ),
                 aO = smem_addr(sO);

  float acc[D / 8][4];
  zero_acc<D>(acc);
  for (int kb = (lo / BK) * BK; kb < hi; kb += BK) {
    __syncthreads();
    load_rows<D, LD>(sK, k + kv_off, kb, BK, mask.S);
    load_rows<D, LD>(sV, v + kv_off, kb, BK, mask.S);
    __syncthreads();
    if (!w_any || whi <= kb || wlo >= kb + BK) continue;       // warp-uniform
    const bool whole = mask.all_visible(rw, rw + 16, kb, kb + BK);
    float s[NB][4], dp[NB][4];
    mma_rows_xt<D, LD, NB>(s, aQ, warp * 16, aK, lane);
    mma_rows_xt<D, LD, NB>(dp, aO, warp * 16, aV, lane);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, key = kb + nb * 8 + c2 + (e & 1);
        float p = exp2f(s[nb][e] * sl2 - l2[h]);
        if (!whole && !mask.visible(rw + g + 8 * h, key)) p = 0.f;
        dp[nb][e] = p * (dp[nb][e] - dl[h]);
      }
    uint32_t da[KS][4];
    pack_a<KS>(da, dp);
    mma_acc<D, LD, KS>(acc, da, aK, lane);
  }
  store_acc<D>(dq + q_off, acc, rw, mask.T, scale, lane);
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int F_KEYS = 32;   // keys of a dK/dV block, 8 a warp
constexpr int F_KW = 8;
constexpr int F_BQ = 16;     // queries of a tile
constexpr int F_RPW = 4;     // dQ: query rows a warp
constexpr int F_BK = 32;     // dQ: keys a tile, one a lane

template <int D>
__global__ void __launch_bounds__(NT, 1) flash_bwd_dkdv_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv, int Hq,
    int Hkv, Mask mask, float scale) {
  constexpr int CPL = D / 32, ST = D + 1;       // columns a lane; padded rows
  extern __shared__ __align__(16) float smf[];
  float* sK = smf;                              // F_KEYS x ST
  float* sV = sK + F_KEYS * ST;
  float* sQ = sV + F_KEYS * ST;                 // F_BQ x ST
  float* sO = sQ + F_BQ * ST;
  float* sL = sO + F_BQ * ST;                   // F_BQ
  float* sDl = sL + F_BQ;
  float* sP = sDl + F_BQ;                       // 4 warps x F_KW x F_BQ
  float* sS = sP + 4 * F_KW * F_BQ;

  const int group = Hq / Hkv;
  const int bkv = blockIdx.y, b = bkv / Hkv, hkv = bkv - b * Hkv;
  const int k0 = blockIdx.x * F_KEYS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kw = k0 + warp * F_KW;
  const size_t kv_off = (size_t)bkv * mask.S * D;
  for (int i = threadIdx.x; i < F_KEYS * D; i += NT) {
    const int r = i / D, c = i - r * D;
    const bool in = k0 + r < mask.S;
    sK[r * ST + c] = in ? k[kv_off + (size_t)(k0 + r) * D + c] : 0.f;
    sV[r * ST + c] = in ? v[kv_off + (size_t)(k0 + r) * D + c] : 0.f;
  }
  int qlo, qhi, wlo, whi;
  mask.query_range(k0, k0 + F_KEYS, qlo, qhi);
  mask.query_range(kw, kw + F_KW, wlo, whi);
  const bool w_any = kw < mask.S && wlo < whi;
  float* wP = sP + warp * F_KW * F_BQ;
  float* wS = sS + warp * F_KW * F_BQ;
  const float sl2 = scale * kLog2e;

  float ak[F_KW][CPL], av[F_KW][CPL];
#pragma unroll
  for (int j = 0; j < F_KW; ++j)
#pragma unroll
    for (int c = 0; c < CPL; ++c) ak[j][c] = av[j][c] = 0.f;

  for (int gi = 0; gi < group; ++gi) {
    const int bh = b * Hq + hkv * group + gi;
    const size_t q_off = (size_t)bh * mask.T * D;
    for (int q0 = (qlo / F_BQ) * F_BQ; q0 < qhi; q0 += F_BQ) {
      __syncthreads();
      for (int i = threadIdx.x; i < F_BQ * D; i += NT) {
        const int r = i / D, c = i - r * D;
        const bool in = q0 + r < mask.T;
        sQ[r * ST + c] = in ? q[q_off + (size_t)(q0 + r) * D + c] : 0.f;
        sO[r * ST + c] = in ? dout[q_off + (size_t)(q0 + r) * D + c] : 0.f;
      }
      for (int i = threadIdx.x; i < F_BQ; i += NT) {
        const bool in = q0 + i < mask.T;
        sL[i] = in ? lse[(size_t)bh * mask.T + q0 + i] * kLog2e : INFINITY;
        sDl[i] = in ? delta[(size_t)bh * mask.T + q0 + i] : 0.f;
      }
      __syncthreads();
      if (!w_any || whi <= q0 || wlo >= q0 + F_BQ) continue;   // warp-uniform
      // P and dS of the warp's 8 keys x 16 queries, four pairs a lane.
#pragma unroll
      for (int r = 0; r < F_KW * F_BQ / 32; ++r) {
        const int pi = lane + 32 * r, j = pi / F_BQ, i = pi - j * F_BQ;
        const float* kr = sK + (warp * F_KW + j) * ST;
        const float* vr = sV + (warp * F_KW + j) * ST;
        float s = 0.f, dp = 0.f;
        for (int c = 0; c < D; ++c) {
          s = fmaf(sQ[i * ST + c], kr[c], s);
          dp = fmaf(sO[i * ST + c], vr[c], dp);
        }
        const float p = mask.visible(q0 + i, kw + j) ? exp2f(s * sl2 - sL[i]) : 0.f;
        wP[j * F_BQ + i] = p;
        wS[j * F_BQ + i] = p * (dp - sDl[i]);
      }
      __syncwarp();
      for (int i = 0; i < F_BQ; ++i) {
        float o_c[CPL], q_c[CPL];
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          o_c[c] = sO[i * ST + lane + 32 * c];
          q_c[c] = sQ[i * ST + lane + 32 * c];
        }
#pragma unroll
        for (int j = 0; j < F_KW; ++j) {
          const float p = wP[j * F_BQ + i], ds = wS[j * F_BQ + i];
#pragma unroll
          for (int c = 0; c < CPL; ++c) {
            av[j][c] = fmaf(p, o_c[c], av[j][c]);
            ak[j][c] = fmaf(ds, q_c[c], ak[j][c]);
          }
        }
      }
      __syncwarp();
    }
  }
#pragma unroll
  for (int j = 0; j < F_KW; ++j) {
    if (kw + j >= mask.S) continue;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const size_t at = kv_off + (size_t)(kw + j) * D + lane + 32 * c;
      dk[at] = ak[j][c] * scale;
      dv[at] = av[j][c];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NT, 1) flash_bwd_dq_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq, int Hq, int Hkv, Mask mask,
    float scale) {
  constexpr int CPL = D / 32, ST = D + 1;
  extern __shared__ __align__(16) float smf[];
  float* sQ = smf;                              // F_BQ x D (rows read in broadcast)
  float* sO = sQ + F_BQ * D;
  float* sK = sO + F_BQ * D;                    // F_BK x ST (lane j reads row j)
  float* sV = sK + F_BK * ST;

  const int bh = blockIdx.y, b = bh / Hq, hq = bh - b * Hq;
  const size_t kv_off = (size_t)(b * Hkv + hq / (Hq / Hkv)) * mask.S * D;
  const size_t q_off = (size_t)bh * mask.T * D;
  const int q0 = blockIdx.x * F_BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = threadIdx.x; i < F_BQ * D; i += NT) {
    const bool in = q0 + i / D < mask.T;
    sQ[i] = in ? q[q_off + (size_t)q0 * D + i] : 0.f;
    sO[i] = in ? dout[q_off + (size_t)q0 * D + i] : 0.f;
  }
  float lr[F_RPW], dl[F_RPW], acc[F_RPW][CPL];
#pragma unroll
  for (int rr = 0; rr < F_RPW; ++rr) {
    const int r = q0 + warp * F_RPW + rr;
    lr[rr] = r < mask.T ? lse[(size_t)bh * mask.T + r] * kLog2e : INFINITY;
    dl[rr] = r < mask.T ? delta[(size_t)bh * mask.T + r] : 0.f;
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[rr][c] = 0.f;
  }
  int lo, hi;
  mask.key_range(q0, q0 + F_BQ, lo, hi);
  const float sl2 = scale * kLog2e;
  for (int kb = (lo / F_BK) * F_BK; kb < hi; kb += F_BK) {
    __syncthreads();
    for (int i = threadIdx.x; i < F_BK * D; i += NT) {
      const int r = i / D, c = i - r * D;
      const bool in = kb + r < mask.S;
      sK[r * ST + c] = in ? k[kv_off + (size_t)(kb + r) * D + c] : 0.f;
      sV[r * ST + c] = in ? v[kv_off + (size_t)(kb + r) * D + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < F_RPW; ++rr) {
      const int rl = warp * F_RPW + rr;
      float s = 0.f, dp = 0.f;
      for (int c = 0; c < D; ++c) {
        s = fmaf(sQ[rl * D + c], sK[lane * ST + c], s);
        dp = fmaf(sO[rl * D + c], sV[lane * ST + c], dp);
      }
      const float p = mask.visible(q0 + rl, kb + lane) ? exp2f(s * sl2 - lr[rr]) : 0.f;
      const float ds = p * (dp - dl[rr]);
#pragma unroll 8
      for (int j = 0; j < F_BK; ++j) {
        const float dsj = __shfl_sync(0xffffffffu, ds, j);
#pragma unroll
        for (int c = 0; c < CPL; ++c) acc[rr][c] = fmaf(dsj, sK[j * ST + lane + 32 * c], acc[rr][c]);
      }
    }
  }
#pragma unroll
  for (int rr = 0; rr < F_RPW; ++rr) {
    const int r = q0 + warp * F_RPW + rr;
    if (r >= mask.T) continue;
#pragma unroll
    for (int c = 0; c < CPL; ++c) dq[q_off + (size_t)r * D + lane + 32 * c] = acc[rr][c] * scale;
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

template <typename T>
int launch_delta(const void* o, const void* dout, float* delta, long rows, int D,
                 cudaStream_t s) {
  const long blocks = (rows + NT / 32 - 1) / (NT / 32);
  flash_bwd_delta_kernel<T><<<(unsigned)blocks, NT, 0, s>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, rows, D);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                const float* delta, void* dq, void* dk, void* dv, int B, int Hq, int Hkv,
                const Mask& mask, float scale, cudaStream_t s) {
  using P = BwdPlan<D>;
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM_KV);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             P::SMEM_Q);
  if (e != cudaSuccess) return (int)e;
  const bf16 *q_ = static_cast<const bf16*>(q), *k_ = static_cast<const bf16*>(k),
             *v_ = static_cast<const bf16*>(v), *do_ = static_cast<const bf16*>(dout);
  dim3 g_kv((mask.S + P::BKV - 1) / P::BKV, B * Hkv);
  flash_bwd_dkdv_kernel<D><<<g_kv, NT, P::SMEM_KV, s>>>(
      q_, k_, v_, do_, lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), Hq, Hkv, mask,
      scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dim3 g_q((mask.T + 63) / 64, B * Hq);
  flash_bwd_dq_kernel<D><<<g_q, NT, P::SMEM_Q, s>>>(q_, k_, v_, do_, lse, delta,
                                                    static_cast<bf16*>(dq), Hq, Hkv, mask, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, const void* dout, const float* lse,
               const float* delta, void* dq, void* dk, void* dv, int B, int Hq, int Hkv,
               const Mask& mask, float scale, cudaStream_t s) {
  constexpr int ST = D + 1;
  const int smem_kv =
      (2 * F_KEYS * ST + 2 * F_BQ * ST + 2 * F_BQ + 2 * 4 * F_KW * F_BQ) * (int)sizeof(float);
  const int smem_q = (2 * F_BQ * D + 2 * F_BK * ST) * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dkdv_f32_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(flash_bwd_dq_f32_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_q);
  if (e != cudaSuccess) return (int)e;
  const float *q_ = static_cast<const float*>(q), *k_ = static_cast<const float*>(k),
              *v_ = static_cast<const float*>(v), *do_ = static_cast<const float*>(dout);
  dim3 g_kv((mask.S + F_KEYS - 1) / F_KEYS, B * Hkv);
  flash_bwd_dkdv_f32_kernel<D><<<g_kv, NT, smem_kv, s>>>(
      q_, k_, v_, do_, lse, delta, static_cast<float*>(dk), static_cast<float*>(dv), Hq, Hkv,
      mask, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dim3 g_q((mask.T + F_BQ - 1) / F_BQ, B * Hq);
  flash_bwd_dq_f32_kernel<D><<<g_q, NT, smem_q, s>>>(q_, k_, v_, do_, lse, delta,
                                                     static_cast<float*>(dq), Hq, Hkv, mask,
                                                     scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, out, dout, dq: (B, Hq, T, D); k, v, dk, dv: (B, Hkv, S, D); all
// contiguous, one dtype: 0 = float32, 1 = bfloat16 (16-byte aligned).  lse:
// (B, Hq, T) f32 from the forward (flash_attention_fwd's `lse`); delta: (B,
// Hq, T) f32 scratch the call fills.  D in {32, 64, 128, 256}, and 96 in
// f32; Hkv | Hq.  causal: 0 or 1; window < 1 means none; scale as the
// forward's.  Returns 0 or the cudaError_t of the first launch that failed.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* out, const void* dout, const float* lse,
                                   float* delta, void* dq, void* dk, void* dv, int B, int Hq,
                                   int Hkv, int T, int S, int D, int causal, int window,
                                   float scale, int dtype, void* stream) {
  if (B < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv || T < 1 || S < 1 || B * Hq > 65535)
    return (int)cudaErrorInvalidValue;
  const Mask mask{T, S, S - T, window, causal ? 1 : 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long rows = (long)B * Hq * T;
  if (dtype == 1) {
    int err = launch_delta<bf16>(out, dout, delta, rows, D, s);
    if (err) return err;
    switch (D) {
      case 32: return launch_bf16<32>(q, k, v, dout, lse, delta, dq, dk, dv, B, Hq, Hkv, mask, scale, s);
      case 64: return launch_bf16<64>(q, k, v, dout, lse, delta, dq, dk, dv, B, Hq, Hkv, mask, scale, s);
      case 128: return launch_bf16<128>(q, k, v, dout, lse, delta, dq, dk, dv, B, Hq, Hkv, mask, scale, s);
      case 256: return launch_bf16<256>(q, k, v, dout, lse, delta, dq, dk, dv, B, Hq, Hkv, mask, scale, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (dtype == 0) {
    int err = launch_delta<float>(out, dout, delta, rows, D, s);
    if (err) return err;
    switch (D) {
      case 32: return launch_f32<32>(q, k, v, dout, lse, delta, dq, dk, dv, B, Hq, Hkv, mask, scale, s);
      case 64: return launch_f32<64>(q, k, v, dout, lse, delta, dq, dk, dv, B, Hq, Hkv, mask, scale, s);
      case 96: return launch_f32<96>(q, k, v, dout, lse, delta, dq, dk, dv, B, Hq, Hkv, mask, scale, s);
      case 128: return launch_f32<128>(q, k, v, dout, lse, delta, dq, dk, dv, B, Hq, Hkv, mask, scale, s);
      case 256: return launch_f32<256>(q, k, v, dout, lse, delta, dq, dk, dv, B, Hq, Hkv, mask, scale, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaErrorInvalidValue;
}
