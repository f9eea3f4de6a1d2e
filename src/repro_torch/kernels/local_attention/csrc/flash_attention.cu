// Flash attention (causal, full, sliding-window; GQA) for Hopper (sm_90a),
// plain C interface.
//
// Replaces: src/repro/kernels/local_attention/kernel.py:flash_attention_pallas,
// the attention of every `local` layer in a cache-free forward (RecurrentGemma:
// causal, window 2048, Hq 10 over Hkv 1, head width 256, bf16).
//
//   out[b, h, i] = softmax_j(scale * q[b, h, i] . k[b, h / group, j]) v[..., j]
//
// over the visible pairs only: key j < S, query i < T and, with the decode
// offset o = S - T, causal j <= i + o and (window W) j > i + o - W, or
// non-causal with a window |j - i| < W.  A row that sees no key gives 0.
//
// What bounds it: operations.  At B=1, T=4096, W=2048, Hq=10, D=256 the
// visible pairs are about 10 * 4096 * 2048 and each costs 4 D flops (q.k and
// p.v): about 6.4e10 flops, 65 us at 989 TFLOP/s bf16, against 46 MB of
// q/k/v/out (14 us at 3.35 TB/s).
//
// Design.  The Pallas kernel swept a (B*H, q-block, kv-step) grid with the
// online-softmax state (m, l, acc) in VMEM scratch across the kv steps.
// Here the kv steps are a loop inside one block per (batch * head, 128
// query rows), walking only the K/V tiles the mask can reach (the window's
// band, as `_kv_block_index` does), with (m, l, acc) in registers for the
// whole walk.  GQA: a block reads the K/V of head h / group.  Heads are the
// grid's fast axis and query tiles run from the last, so the longest causal
// bands start first and the blocks in flight share K/V tiles in L2.
//
// bf16 (`flash_wgmma_kernel`), every head width of HEAD_DIMS: three
// warpgroups.  One thread of the producer warpgroup loads the block's Q tile
// once by TMA, then K and V tiles (BK keys x D) into a two-slot ring, K and
// V each with a full and an empty mbarrier per slot: S = Q K^T starts before
// V has landed, and a K slot is refilled as soon as its S is computed, while
// its V is still in use.  The tensor maps are 3-D, (D, T,
// B*Hq) and (D, S, B*Hkv), so rows past T or S of a head arrive as zeros
// rather than as the next head's rows.  A row of D=256 is 512 bytes, so each
// tile is D/64 boxes of 64 columns with the 128-byte swizzle (D=32: one box
// of 32 columns, 64-byte swizzle).  Two consumer warpgroups own 64 query
// rows each: S = Q K^T is wgmma SS (m64nBKk16 over D/16 steps), the online
// softmax runs in registers in exp2 with the per-element mask only on tiles
// the band's edge cuts, P is rounded to bf16 in registers and O += P V is
// wgmma RS (P the register A operand, V N-major through the transpose bit).
// A tile's P V is issued behind the next tile's Q K^T, so it runs on the
// tensor cores while the warpgroup computes that tile's softmax; O is
// rescaled once it has landed.  A warpgroup whose 64 rows see no key of a
// tile skips its products but still waits for the tile and releases it.
// setmaxnreg gives the producer 24 registers and the consumers 240.
// Budget: BK = 64 at D = 256, else 128.  Shared memory, D = 256: Q 64 KB +
// 2 stages x (K 32 KB + V 32 KB) = 192 KB of 227; D = 128: 160 KB.
// Registers of a consumer thread at D = 256: O 128 f32, S 32, the pending
// P 16.
// float32 inputs take a CUDA-core kernel with f32 products throughout (no
// TF32), one warp per four query rows, at head widths 32 to 256 and 96 (the
// qwen2-100m training example's width); only the reduced f32 models use it.
// Training launches also write each row's log-sum-exp (the `lse` output,
// from the m and l the walk ends with), which the backward kernels of
// flash_attention_bwd.cu read to recompute P; serving launches pass none
// and run a bf16 instantiation without that store.
// Later work: sharing K/V across a GQA group by cluster multicast, FA3's
// ping-pong of the two consumer warpgroups (named barriers ordering their
// softmax against each other's products), fp8.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_mask.cuh"
#include "sm90.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int NW = 4;                 // warps per block of the f32 kernel

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// ---------------------------------------------------------------------------
// bf16: wgmma fed by TMA, warp-specialised
// ---------------------------------------------------------------------------

constexpr int FA_THREADS = 384;       // producer warpgroup + 2 consumers

template <int D>
struct FlashPlan {
  static constexpr int SW = D >= 64 ? 128 : 64;   // swizzle bytes = one row of a box
  static constexpr int CW = SW / 2;               // box width, elements
  static constexpr int NCH = D / CW;              // boxes per row
  static constexpr int BQ = 128;                  // query rows per block
  static constexpr int BK = D == 256 ? 64 : 128;  // keys per K/V tile
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;     // one K or V tile
  static constexpr int SMEM = Q_BYTES + 2 * 2 * KV_BYTES + 1024;
};

template <int N>
__device__ __forceinline__ void keep_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    asm volatile("" : "+r"(r[i][0]), "+r"(r[i][1]), "+r"(r[i][2]), "+r"(r[i][3])::"memory");
}

// Issues (does not wait for) S = Q K^T of one tile: 64 query rows of the
// warpgroup (K-major at `q_base`) against BK keys (K-major at `sK`).
template <int D, int BK, int SW>
__device__ __forceinline__ void issue_qk(float (&s)[BK / 2], uint32_t q_base, uint32_t sK) {
  sm90::wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
    sm90::wgmma_ss<BK, 0>(s, sm90::desc_kmajor<SW>(q_base, ks, 128 * SW),
                          sm90::desc_kmajor<SW>(sK, ks, BK * SW), ks > 0 ? 1 : 0);
  sm90::wgmma_commit();
}

// Issues (does not wait for) O += P V of one tile: P the bf16 A fragments
// of the BK/16 k16 steps, V N-major at `sV`.
template <int D, int BK, int SW>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], uint32_t (&pa)[BK / 16][4],
                                         uint32_t sV) {
  sm90::fence_regs(o);
  sm90::wgmma_fence();
#pragma unroll
  for (int j = 0; j < BK / 16; ++j)
    sm90::wgmma_rs<D, 1>(o, pa[j], sm90::desc_mnmajor<SW>(sV, j, BK * SW), 1);
  sm90::wgmma_commit();
}

// One tile's online-softmax step on S in registers (the wgmma accumulator
// layout): mask (only where the band's edge cuts the tile: !whole), scale
// into the log2 domain, take the new row maxima over the quad of threads
// that holds each row, and turn S into P (unrounded) with its sum added to
// this thread's share of l.  alpha: each row's rescale of O and l.
template <int BK>
__device__ __forceinline__ void online_softmax(float (&s)[BK / 2], const Mask& mask, bool whole,
                                               int row0, int col0, int kb, float scale_log2,
                                               float (&m_run)[2], float (&l_run)[2],
                                               float (&alpha)[2]) {
  float mx[2] = {neg_inf(), neg_inf()};
#pragma unroll
  for (int i = 0; i < BK / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float val = s[4 * i + e] * scale_log2;
      if (!whole && !mask.visible(row0 + (e >> 1) * 8, kb + 8 * i + col0 + (e & 1)))
        val = neg_inf();
      s[4 * i + e] = val;
      mx[e >> 1] = fmaxf(mx[e >> 1], val);
    }
  float base[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(m_run[h], mx[h]);
    base[h] = m_new == neg_inf() ? 0.f : m_new;   // no key seen yet: all p = 0
    alpha[h] = exp2f(m_run[h] - base[h]);
    m_run[h] = m_new;
    l_run[h] *= alpha[h];
  }
#pragma unroll
  for (int i = 0; i < BK / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2f(s[4 * i + e] - base[e >> 1]);
      s[4 * i + e] = p;
      l_run[e >> 1] += p;
    }
}

// P rounded to bf16: the accumulator pairs of S are the A fragments of the
// k16 steps of P V.
template <int BK>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[BK / 16][4], const float (&s)[BK / 2]) {
#pragma unroll
  for (int j = 0; j < BK / 16; ++j) {
    pa[j][0] = sm90::pack_bf16(s[8 * j + 0], s[8 * j + 1]);
    pa[j][1] = sm90::pack_bf16(s[8 * j + 2], s[8 * j + 3]);
    pa[j][2] = sm90::pack_bf16(s[8 * j + 4], s[8 * j + 5]);
    pa[j][3] = sm90::pack_bf16(s[8 * j + 6], s[8 * j + 7]);
  }
}

// LSE: write each row's log-sum-exp (training); serving's instantiation
// (false) holds no trace of it.
template <int D, bool LSE>
__global__ void __launch_bounds__(FA_THREADS, 1) flash_wgmma_kernel(
    const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
    const __grid_constant__ CUtensorMap map_v, bf16* __restrict__ out,
    float* __restrict__ lse, int Hq, int group, Mask mask, float scale_log2) {
  using P = FlashPlan<D>;
  constexpr int BK = P::BK, SW = P::SW;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t q_full, k_full[2], v_full[2], k_empty[2], v_empty[2];
  uint8_t* smem = smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sQ = smem;
  uint8_t* sKV = smem + P::Q_BYTES;     // slot s: K at 2 s KV_BYTES, V after it

  // Heads run fastest and query tiles from the last: the longest causal
  // bands start first, and the blocks in flight share K/V tiles in L2.
  const int bh = blockIdx.x;
  const int b = bh / Hq, hq = bh - b * Hq;
  const int bkv = b * (Hq / group) + hq / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * P::BQ;
  int lo, hi;
  mask.key_range(q0, q0 + P::BQ, lo, hi);
  const int kb_first = (lo / BK) * BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    sm90::mbar_init(&q_full, 1);
    for (int s = 0; s < 2; ++s) {
      sm90::mbar_init(&k_full[s], 1);
      sm90::mbar_init(&v_full[s], 1);
      sm90::mbar_init(&k_empty[s], 8);         // lane 0 of each consumer warp
      sm90::mbar_init(&v_empty[s], 8);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    sm90::reg_dealloc<24>();
    if (threadIdx.x == 0) {
      sm90::tma_prefetch_map(&map_q);
      sm90::tma_prefetch_map(&map_k);
      sm90::tma_prefetch_map(&map_v);
      sm90::mbar_arrive_expect_tx(&q_full, P::Q_BYTES);
#pragma unroll
      for (int c = 0; c < P::NCH; ++c)
        sm90::tma_load_3d(sQ + c * P::BQ * SW, &map_q, &q_full, c * P::CW, q0, bh);
      int stage = 0, phase = 0;
      for (int kb = kb_first; kb < hi; kb += BK) {
        uint8_t* sK = sKV + stage * 2 * P::KV_BYTES;
        uint8_t* sV = sK + P::KV_BYTES;
        sm90::mbar_wait(&k_empty[stage], phase ^ 1);
        sm90::mbar_arrive_expect_tx(&k_full[stage], P::KV_BYTES);
#pragma unroll
        for (int c = 0; c < P::NCH; ++c)
          sm90::tma_load_3d(sK + c * BK * SW, &map_k, &k_full[stage], c * P::CW, kb, bkv);
        sm90::mbar_wait(&v_empty[stage], phase ^ 1);
        sm90::mbar_arrive_expect_tx(&v_full[stage], P::KV_BYTES);
#pragma unroll
        for (int c = 0; c < P::NCH; ++c)
          sm90::tma_load_3d(sV + c * BK * SW, &map_v, &v_full[stage], c * P::CW, kb, bkv);
        if (++stage == 2) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    sm90::reg_alloc<240>();
    const int cw = wg - 1;
    const int t = threadIdx.x - 128 * wg, warp = t / 32, lane = t % 32;
    const int r_lo = q0 + cw * 64;                  // this warpgroup's 64 rows
    const int row0 = r_lo + warp * 16 + lane / 4;   // this thread's rows: row0, row0 + 8
    const int col0 = 2 * (lane % 4);
    const uint32_t q_base = sm90::smem_u32(sQ) + cw * 64 * SW;
    auto k_at = [&](int i) { return sm90::smem_u32(sKV + (i & 1) * 2 * P::KV_BYTES); };
    auto v_at = [&](int i) { return k_at(i) + P::KV_BYTES; };

    // The block's tiles are i = 0 .. n_tiles-1 (keys kb_first + i BK), tile
    // i in slot i % 2 at phase (i / 2) % 2.  The rows of this warpgroup see
    // the contiguous run [i_first, i_end) of them; the others it only waits
    // for and hands back.  Peeling the run's first and last products keeps
    // every wgmma of the pipelined loop out of a branch: ptxas serialises
    // wgmma whose groups stay in flight across a divergent path.
    const int n_tiles = hi > kb_first ? (hi - kb_first + BK - 1) / BK : 0;
    int w_lo, w_hi;
    mask.key_range(r_lo, r_lo + 64, w_lo, w_hi);
    const bool any = r_lo < mask.T && w_lo < w_hi;
    int i_first = any ? (w_lo - kb_first) / BK : 0;
    const int i_end = any ? min(n_tiles, (w_hi - kb_first + BK - 1) / BK) : 0;
    auto pass = [&](int i) {
      sm90::mbar_wait(&k_full[i & 1], (i >> 1) & 1);
      if (lane == 0) sm90::mbar_arrive(&k_empty[i & 1]);
      sm90::mbar_wait(&v_full[i & 1], (i >> 1) & 1);
      if (lane == 0) sm90::mbar_arrive(&v_empty[i & 1]);
    };

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m_run[2] = {neg_inf(), neg_inf()};
    float l_run[2] = {0.f, 0.f};              // this thread's share of each row sum
    sm90::mbar_wait(&q_full, 0);

    for (int i = 0; i < i_first; ++i) pass(i);
    if (i_first < i_end) {
      // The first tile: S, softmax, P.  O is still 0, so no rescale.
      uint32_t pa[BK / 16][4];
      {
        const int i = i_first, kb = kb_first + i * BK;
        float s[BK / 2], alpha[2];
        sm90::mbar_wait(&k_full[i & 1], (i >> 1) & 1);
        issue_qk<D, BK, SW>(s, q_base, k_at(i));
        sm90::wgmma_wait<0>();
        sm90::fence_regs(s);
        if (lane == 0) sm90::mbar_arrive(&k_empty[i & 1]);
        online_softmax<BK>(s, mask, mask.all_visible(r_lo, r_lo + 64, kb, kb + BK), row0,
                           col0, kb, scale_log2, m_run, l_run, alpha);
        pack_p<BK>(pa, s);
      }
      // Each next tile: its S = Q K^T, then the previous tile's O += P V
      // behind it on the tensor cores while this tile's softmax runs.
      for (int i = i_first + 1; i < i_end; ++i) {
        const int kb = kb_first + i * BK;
        float s[BK / 2], alpha[2];
        sm90::mbar_wait(&k_full[i & 1], (i >> 1) & 1);
        issue_qk<D, BK, SW>(s, q_base, k_at(i));
        sm90::mbar_wait(&v_full[(i - 1) & 1], ((i - 1) >> 1) & 1);
        issue_pv<D, BK, SW>(o, pa, v_at(i - 1));
        sm90::wgmma_wait<1>();                 // S is ready; P V may still run
        sm90::fence_regs(s);
        if (lane == 0) sm90::mbar_arrive(&k_empty[i & 1]);
        online_softmax<BK>(s, mask, mask.all_visible(r_lo, r_lo + 64, kb, kb + BK), row0,
                           col0, kb, scale_log2, m_run, l_run, alpha);
        sm90::wgmma_wait<0>();                 // the previous P V has landed
        sm90::fence_regs(o);
        keep_regs(pa);
        if (lane == 0) sm90::mbar_arrive(&v_empty[(i - 1) & 1]);
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          o[4 * n + 0] *= alpha[0];
          o[4 * n + 1] *= alpha[0];
          o[4 * n + 2] *= alpha[1];
          o[4 * n + 3] *= alpha[1];
        }
        pack_p<BK>(pa, s);
      }
      // The last tile's P V.
      const int last = i_end - 1;
      sm90::mbar_wait(&v_full[last & 1], (last >> 1) & 1);
      issue_pv<D, BK, SW>(o, pa, v_at(last));
      sm90::wgmma_wait<0>();
      sm90::fence_regs(o);
      keep_regs(pa);
      if (lane == 0) sm90::mbar_arrive(&v_empty[last & 1]);
    }
    for (int i = max(i_first, i_end); i < n_tiles; ++i) pass(i);

    bf16* og = out + (size_t)bh * mask.T * D;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float l = l_run[h];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int r = row0 + 8 * h;
      if (r >= mask.T) continue;
      const float inv = l > 0.f ? 1.f / l : 0.f;
      // The row's natural log-sum-exp of scale * q.k for the backward: m_run
      // and l are in the log2 domain; +inf where the row sees no key.
      if constexpr (LSE) {
        if ((lane & 3) == 0)
          lse[(size_t)bh * mask.T + r] = l > 0.f ? (m_run[h] + log2f(l)) * kLn2 : INFINITY;
      }
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
        *reinterpret_cast<__nv_bfloat162*>(og + (size_t)r * D + 8 * i + col0) =
            __floats2bfloat162_rn(o[4 * i + 2 * h] * inv, o[4 * i + 2 * h + 1] * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// float32: CUDA-core kernel
// ---------------------------------------------------------------------------

constexpr int F_BQ = 16;     // query rows per block
constexpr int F_RPW = 4;     // query rows per warp
constexpr int F_BK = 32;     // keys per tile (one per lane)

template <int D>
__global__ void __launch_bounds__(NW * 32, 1) flash_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out, float* __restrict__ lse, int Hq,
    int group, Mask mask, float scale) {
  constexpr int CPL = D / 32;         // output columns per lane
  constexpr int KSTR = D + 1;         // padded K rows: lane j reads row j
  extern __shared__ __align__(16) float smf[];
  float* sQ = smf;                    // F_BQ x D
  float* sK = sQ + F_BQ * D;          // F_BK x KSTR
  float* sV = sK + F_BK * KSTR;       // F_BK x D

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bh = blockIdx.y;
  const int b = bh / Hq, hq = bh - b * Hq;
  const size_t kv_off = (size_t)(b * (Hq / group) + hq / group) * mask.S * D;
  const float* qg = q + (size_t)bh * mask.T * D;
  const int q0 = blockIdx.x * F_BQ;
  for (int i = threadIdx.x; i < F_BQ * D; i += blockDim.x) {
    const int r = i / D;
    sQ[i] = q0 + r < mask.T ? qg[(size_t)q0 * D + i] : 0.f;
  }
  int lo, hi;
  mask.key_range(q0, q0 + F_BQ, lo, hi);

  float acc[F_RPW][CPL];
  float m_run[F_RPW], l_run[F_RPW];
#pragma unroll
  for (int r = 0; r < F_RPW; ++r) {
    m_run[r] = neg_inf();
    l_run[r] = 0.f;
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[r][c] = 0.f;
  }

  for (int kb = (lo / F_BK) * F_BK; kb < hi; kb += F_BK) {
    __syncthreads();
    for (int i = threadIdx.x; i < F_BK * D; i += blockDim.x) {
      const int r = i / D, c = i - r * D;
      const bool in = kb + r < mask.S;
      sK[r * KSTR + c] = in ? k[kv_off + (size_t)(kb + r) * D + c] : 0.f;
      sV[i] = in ? v[kv_off + (size_t)(kb + r) * D + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < F_RPW; ++rr) {
      const int rl = warp * F_RPW + rr;
      float sc = 0.f;
      for (int c = 0; c < D; ++c) sc = fmaf(sQ[rl * D + c], sK[lane * KSTR + c], sc);
      sc = mask.visible(q0 + rl, kb + lane) ? sc * scale : neg_inf();
      float mx = sc;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run[rr], mx);
      const float base = m_new == neg_inf() ? 0.f : m_new;
      const float alpha = expf(m_run[rr] - base);
      const float p = expf(sc - base);
      float ps = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l_run[rr] = l_run[rr] * alpha + ps;
      m_run[rr] = m_new;
#pragma unroll
      for (int c = 0; c < CPL; ++c) acc[rr][c] *= alpha;
      for (int j = 0; j < F_BK; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
        for (int c = 0; c < CPL; ++c) acc[rr][c] = fmaf(pj, sV[j * D + lane + 32 * c], acc[rr][c]);
      }
    }
  }

  float* og = out + (size_t)bh * mask.T * D;
#pragma unroll
  for (int rr = 0; rr < F_RPW; ++rr) {
    const int r = q0 + warp * F_RPW + rr;
    if (r >= mask.T) continue;
    const float inv = l_run[rr] > 0.f ? 1.f / l_run[rr] : 0.f;
    if (lse != nullptr && lane == 0)
      lse[(size_t)bh * mask.T + r] = l_run[rr] > 0.f ? m_run[rr] + logf(l_run[rr]) : INFINITY;
#pragma unroll
    for (int c = 0; c < CPL; ++c) og[(size_t)r * D + lane + 32 * c] = acc[rr][c] * inv;
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* out, float* lse, int B,
                int Hq, int Hkv, const Mask& mask, float scale, cudaStream_t s) {
  using P = FlashPlan<D>;
  CUtensorMap map_q, map_k, map_v;
  const uint64_t dims_q[3] = {(uint64_t)D, (uint64_t)mask.T, (uint64_t)B * Hq};
  const uint64_t strides_q[2] = {(uint64_t)D * 2, (uint64_t)mask.T * D * 2};
  const uint32_t box_q[3] = {(uint32_t)P::CW, (uint32_t)P::BQ, 1};
  const uint64_t dims_kv[3] = {(uint64_t)D, (uint64_t)mask.S, (uint64_t)B * Hkv};
  const uint64_t strides_kv[2] = {(uint64_t)D * 2, (uint64_t)mask.S * D * 2};
  const uint32_t box_kv[3] = {(uint32_t)P::CW, (uint32_t)P::BK, 1};
  int err = sm90::encode_bf16_map(&map_q, 3, q, dims_q, strides_q, box_q, P::SW);
  if (!err) err = sm90::encode_bf16_map(&map_k, 3, k, dims_kv, strides_kv, box_kv, P::SW);
  if (!err) err = sm90::encode_bf16_map(&map_v, 3, v, dims_kv, strides_kv, box_kv, P::SW);
  if (err) return err;
  auto kernel = lse != nullptr ? flash_wgmma_kernel<D, true> : flash_wgmma_kernel<D, false>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(B * Hq, (mask.T + P::BQ - 1) / P::BQ);
  kernel<<<grid, FA_THREADS, P::SMEM, s>>>(map_q, map_k, map_v, static_cast<bf16*>(out), lse, Hq,
                                           Hq / Hkv, mask, scale * kLog2e);
  return (int)cudaGetLastError();
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* out, float* lse, int B,
               int Hq, int group, const Mask& mask, float scale, cudaStream_t s) {
  const int smem = (F_BQ * D + F_BK * (D + 1) + F_BK * D) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((mask.T + F_BQ - 1) / F_BQ, B * Hq);
  flash_f32_kernel<D><<<grid, NW * 32, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, Hq, group, mask, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (B, Hq, T, D); k, v: (B, Hkv, S, D); out: (B, Hq, T, D); all contiguous,
// one dtype: 0 = float32, 1 = bfloat16 (16-byte aligned: TMA reads it).
// lse: null (serving) or (B, Hq, T) f32, each row's natural log-sum-exp of
// scale * q.k over its visible keys (+inf for a row that sees none), which
// the backward (flash_attention_bwd.cu) reads.
// D in {32, 64, 128, 256}, and 96 in f32; Hkv | Hq.  causal: 0 or 1; window
// < 1 means none.
// Returns 0, a cudaError_t, or sm90::kTensorMapError + a CUresult.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* out, float* lse, int B, int Hq, int Hkv, int T,
                                   int S, int D, int causal, int window,
                                   float scale, int dtype, void* stream) {
  if (B < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv || T < 1 || S < 1 ||
      B * Hq > 65535)
    return (int)cudaErrorInvalidValue;
  const Mask mask{T, S, S - T, window, causal ? 1 : 0};
  const int group = Hq / Hkv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    switch (D) {
      case 32: return launch_bf16<32>(q, k, v, out, lse, B, Hq, Hkv, mask, scale, s);
      case 64: return launch_bf16<64>(q, k, v, out, lse, B, Hq, Hkv, mask, scale, s);
      case 128: return launch_bf16<128>(q, k, v, out, lse, B, Hq, Hkv, mask, scale, s);
      case 256: return launch_bf16<256>(q, k, v, out, lse, B, Hq, Hkv, mask, scale, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (dtype == 0) {
    switch (D) {
      case 32: return launch_f32<32>(q, k, v, out, lse, B, Hq, group, mask, scale, s);
      case 64: return launch_f32<64>(q, k, v, out, lse, B, Hq, group, mask, scale, s);
      case 96: return launch_f32<96>(q, k, v, out, lse, B, Hq, group, mask, scale, s);
      case 128: return launch_f32<128>(q, k, v, out, lse, B, Hq, group, mask, scale, s);
      case 256: return launch_f32<256>(q, k, v, out, lse, B, Hq, group, mask, scale, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaErrorInvalidValue;
}
