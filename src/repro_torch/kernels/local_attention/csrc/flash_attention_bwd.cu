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
// training microbatch (B=4, Hq 4, T=2048, D=256, causal) about 8.6e10
// flops, 87 us at 989 TFLOP/s bf16, against 42 MB of q/k/v/o/dO/dq/dk/dv.
//
// Design, bf16 (every head width of HEAD_DIMS): the forward's shape
// (flash_attention.cu) in both directions, deterministic (no atomics).
// Three launches on one stream:
// - `prep`: one warp a row, delta = rowsum(dO o O) in f32 beside lse *
//   log2 e, both into a (B*Hq, Tp) scratch padded to 128 rows (+inf and 0
//   past T), so a ring stage takes a query tile's rows by one bulk copy.
// - dK/dV (`flash_bwd_dkdv_wgmma_kernel`): a block owns BKV keys of one
//   (batch, KV head); a producer warp loads its K and V tiles once by TMA
//   (3-D maps, so rows past S arrive as zeros), then fills a ring of
//   `stages` stages with the Q and dO tiles (64 queries) of every query
//   tile the mask lets the block's keys see (`Mask::query_range`), each
//   with its rows of lse * log2 e and delta by bulk copy; a full and an
//   empty mbarrier a stage.  Two consumer warpgroups run, per tile, S^T =
//   K Q^T and dP^T = V dO^T (wgmma SS), P^T and dS^T in registers (the
//   per-element mask only on tiles the band's edge cuts), both rounded to
//   bf16 into shared memory, then dV += P^T dO and dK += dS^T Q (wgmma SS,
//   dO and Q N-major through the transpose bit): four products in one
//   sweep.  D <= 128: BKV = 128, a warpgroup owns 64 keys and every column
//   of their dK and dV.  D = 256: dK and dV rows of 64 keys would take 256
//   registers a thread, so BKV = 64 and the two warpgroups split the work
//   by columns: each takes half the queries of S^T and dP^T and half the
//   columns of dK and dV (128 accumulator registers a thread); P^T and dS^T
//   meet in shared memory, behind a named barrier.
//   GQA: a cluster of `cluster` blocks (a divisor of the group, at most 8,
//   from the wrapper's plan) shares one key tile; block rank r walks query
//   heads [r, r + 1) * group / cluster.  After the walk each block leaves
//   its f32 dK and dV partials in its own shared memory, and block r sums a
//   1/cluster share of the elements over ranks 0, 1, .. in that order
//   through distributed shared memory (mapa / ld.shared::cluster), so the
//   sum is the same in every run.  Key tiles are the grid's slow axis, the
//   lowest first: under a causal mask they see the most queries.
// - dQ (`flash_bwd_dq_wgmma_kernel`): the forward's kernel with dO beside
//   Q: a block owns 128 queries of one (batch, query head), 64 a consumer
//   warpgroup; the producer loads Q and dO once and K and V tiles into a
//   ring; S = Q K^T and dP = dO V^T (wgmma SS), dS in registers, rounded to
//   bf16 as the A operand of dQ += dS K (wgmma RS, K N-major).  D = 256
//   takes 32-key tiles (Q and dO hold 128 KB of shared memory).
// setmaxnreg gives the producer warpgroup 24 registers and the consumers
// 240.  Shared memory: flash_bwd_smem below (the planner's mirror,
// local_attention/kernel.py:bwd_smem_bytes, must agree).
// float32 (the reduced models, and the qwen2-100m example at D = 96) runs
// on CUDA cores with f32 products throughout (no TF32): dK/dV blocks of 32
// keys (8 a warp, lanes over the output columns), dQ blocks of 16 queries
// (4 a warp, a lane a key of the tile, as the forward's f32 kernel).
// What limits it now: at D = 256 the two-stage ring leaves no room to issue
// a tile's S^T and dP^T behind the previous tile's products (tried: each
// stage is then released half a tile later and the ring starves, 30%
// slower; the dQ kernel likewise 40% slower), and S^T and dP^T run as
// m64n32 products, which read 3 KB of shared memory per 32K multiply-adds
// (by count, about 1.5 times their tensor-core time).  A GQA cluster of 4
// occupies at most 120 of the 132 SMs at once.  Later work: S^T
// and dP^T as one m64n64 product a warpgroup (one computes P^T, the other
// dS^T from it), a persistent schedule over the causal triangle.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_mask.cuh"
#include "sm90.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int NT = 128;              // threads of the f32 blocks and of `delta` / `prep`

// ---------------------------------------------------------------------------
// delta = rowsum(dO o O), f32
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(NT, 1) flash_bwd_delta_kernel(const float* __restrict__ o,
                                                             const float* __restrict__ dout,
                                                             float* __restrict__ delta,
                                                             long rows, int D) {
  const long row = (long)blockIdx.x * (NT / 32) + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  float s = 0.f;
  for (int c = lane; c < D; c += 32) s = fmaf(o[row * D + c], dout[row * D + c], s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) delta[row] = s;
}

// ---------------------------------------------------------------------------
// bf16: wgmma fed by TMA rings, warp-specialised
// ---------------------------------------------------------------------------

constexpr int BW_THREADS = 384;      // producer warpgroup + 2 consumer warpgroups
constexpr int MAX_STAGES = 4;        // ring depth at most
constexpr int MAX_CLUSTER = 8;       // blocks of a GQA cluster at most
constexpr int PAD_ROWS = 128;        // the prep scratch's rows pad to this
constexpr int BAR_BYTES = 256;       // the mbarriers, after the tiles
constexpr int ALIGN_SLACK = 1024;    // tiles start on a 1024-byte boundary
constexpr int SMEM_LIMIT = 232448;   // dynamic shared memory a block may take

template <int D>
struct BwdTiles {
  static constexpr int SW = D >= 64 ? 128 : 64;   // swizzle bytes = one row of a box
  static constexpr int CW = SW / 2;               // box width, elements
  static constexpr int NCH = D / CW;              // boxes per row
  // dK/dV
  static constexpr int BKV = D == 256 ? 64 : 128; // keys of a block
  static constexpr int BQ = 64;                   // queries of a ring stage
  static constexpr bool COLSPLIT = D == 256;      // warpgroups split columns, not keys
  static constexpr int NS = COLSPLIT ? BQ / 2 : BQ;   // S^T columns of a warpgroup
  static constexpr int ND = COLSPLIT ? D / 2 : D;     // dK, dV columns of a warpgroup
  static constexpr int KV_TILE = BKV * D * 2;
  static constexpr int QT = BQ * D * 2;           // one Q or dO tile
  static constexpr int KV_STAGE = (2 * QT + 2 * BQ * 4 + 1023) / 1024 * 1024;
  static constexpr int PT = BKV * BQ * 2;         // the P^T or dS^T tile
  static constexpr int RS = D + 8;                // row stride (floats) of the partials
  // dQ
  static constexpr int DQ_ROWS = 128;             // queries of a block
  static constexpr int DQ_KEYS = D == 256 ? 32 : 64;  // keys of a ring stage
  static constexpr int DQ_Q = DQ_ROWS * D * 2;    // the Q or dO tile
  static constexpr int DQ_KT = DQ_KEYS * D * 2;   // one K or V tile
};

// Dynamic shared memory of the dK/dV kernel and of the dQ kernel at head
// width D and a ring of `stages`: alignment slack, tiles, barriers.
template <int D>
__host__ __device__ constexpr int dkdv_smem(int stages) {
  using P = BwdTiles<D>;
  return ALIGN_SLACK + 2 * P::KV_TILE + stages * P::KV_STAGE + 2 * P::PT + BAR_BYTES;
}
template <int D>
__host__ __device__ constexpr int dq_smem(int stages) {
  using P = BwdTiles<D>;
  return ALIGN_SLACK + 2 * P::DQ_Q + stages * 2 * P::DQ_KT + BAR_BYTES;
}

template <int N>
__device__ __forceinline__ void keep_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    asm volatile("" : "+r"(r[i][0]), "+r"(r[i][1]), "+r"(r[i][2]), "+r"(r[i][3])::"memory");
}

template <int N>
__device__ __forceinline__ void zero(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.f;
}

// prep: a warp a row of (B*Hq, Tp): lse2 = lse * log2 e and delta =
// rowsum(dO o O) for rows below T; +inf and 0 past it.  16-byte loads.
template <int D>
__global__ void __launch_bounds__(NT) flash_bwd_prep_kernel(
    const bf16* __restrict__ o, const bf16* __restrict__ dout, const float* __restrict__ lse,
    float* __restrict__ lse2, float* __restrict__ delta, long rows, int T, int Tp) {
  const long row = (long)blockIdx.x * (NT / 32) + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const long bh = row / Tp;
  const int t = (int)(row - bh * Tp);
  if (t >= T) {
    if (lane == 0) {
      lse2[row] = INFINITY;
      delta[row] = 0.f;
    }
    return;
  }
  const size_t at = ((size_t)bh * T + t) * D;
  float s = 0.f;
  for (int c = lane * 8; c < D; c += 256) {
    const uint4 vo = *reinterpret_cast<const uint4*>(o + at + c);
    const uint4 vd = *reinterpret_cast<const uint4*>(dout + at + c);
    const __nv_bfloat162* po = reinterpret_cast<const __nv_bfloat162*>(&vo);
    const __nv_bfloat162* pd = reinterpret_cast<const __nv_bfloat162*>(&vd);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 fo = __bfloat1622float2(po[j]), fd = __bfloat1622float2(pd[j]);
      s = fmaf(fo.x, fd.x, s);
      s = fmaf(fo.y, fd.y, s);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) {
    lse2[row] = lse[(size_t)bh * T + t] * kLog2e;
    delta[row] = s;
  }
}

// Issues (does not wait for) S = A B^T and dP = A' B'^T as two groups: A,
// A' 64 rows K-major at `aA`, `aA2` (chunks `rows_a` rows apart); B, B' N
// rows K-major at `aB`, `aB2` (chunks `rows_b` rows apart), over D.
template <int D, int N, int ROWS_A, int SW>
__device__ __forceinline__ void issue_sdp(float (&s)[N / 2], float (&dp)[N / 2], uint32_t aA,
                                          uint32_t aA2, uint32_t aB, uint32_t aB2, int rows_b) {
  sm90::wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
    sm90::wgmma_ss<N, 0>(s, sm90::desc_kmajor<SW>(aA, ks, ROWS_A * SW),
                         sm90::desc_kmajor<SW>(aB, ks, rows_b * SW), ks > 0 ? 1 : 0);
  sm90::wgmma_commit();
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
    sm90::wgmma_ss<N, 0>(dp, sm90::desc_kmajor<SW>(aA2, ks, ROWS_A * SW),
                         sm90::desc_kmajor<SW>(aB2, ks, rows_b * SW), ks > 0 ? 1 : 0);
  sm90::wgmma_commit();
}

template <int D>
__global__ void __launch_bounds__(BW_THREADS, 1) flash_bwd_dkdv_wgmma_kernel(
    const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
    const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_do,
    const float* __restrict__ lse2, const float* __restrict__ delta, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int Hq, int Hkv, int Tp, Mask mask, float scale, int stages,
    int cluster) {
  using P = BwdTiles<D>;
  constexpr int SW = P::SW, CW = P::CW, BKV = P::BKV, BQ = P::BQ, NS = P::NS, ND = P::ND;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sK = smem;
  uint8_t* sV = sK + P::KV_TILE;
  uint8_t* ring = sV + P::KV_TILE;
  uint8_t* sP = ring + stages * P::KV_STAGE;   // P^T, (BKV keys x BQ queries) K-major
  uint8_t* sdS = sP + P::PT;                   // dS^T, the same layout
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sdS + P::PT);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + MAX_STAGES;

  const int group = Hq / Hkv, per = group / cluster;
  const int rank = (int)sm90::cluster_ctarank();
  const int bkv = blockIdx.x / cluster;
  const int b = bkv / Hkv, hkv = bkv - b * Hkv;
  const int k0 = blockIdx.y * BKV;
  const int g0 = rank * per;
  int qlo, qhi;
  mask.query_range(k0, k0 + BKV, qlo, qhi);
  const int qt_first = (qlo / BQ) * BQ;
  const int n_qt = qhi > qlo ? (qhi - qt_first + BQ - 1) / BQ : 0;
  const int n_tiles = per * n_qt;              // (head, query tile) pairs, head-major
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    sm90::mbar_init(kv_full, 1);
    for (int s = 0; s < stages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 8);           // lane 0 of each consumer warp
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    sm90::reg_dealloc<24>();
    if (threadIdx.x == 0 && n_tiles > 0) {
      sm90::tma_prefetch_map(&map_q);
      sm90::tma_prefetch_map(&map_do);
      sm90::mbar_arrive_expect_tx(kv_full, 2 * P::KV_TILE);
#pragma unroll
      for (int c = 0; c < P::NCH; ++c) {
        sm90::tma_load_3d(sK + c * BKV * SW, &map_k, kv_full, c * CW, k0, bkv);
        sm90::tma_load_3d(sV + c * BKV * SW, &map_v, kv_full, c * CW, k0, bkv);
      }
      int stage = 0, phase = 0;
      for (int i = 0; i < n_tiles; ++i) {
        const int bh = b * Hq + hkv * group + g0 + i / n_qt;
        const int q0 = qt_first + (i % n_qt) * BQ;
        uint8_t* st = ring + stage * P::KV_STAGE;
        sm90::mbar_wait(&empty[stage], phase ^ 1);
        sm90::mbar_arrive_expect_tx(&full[stage], 2 * P::QT + 2 * BQ * 4);
#pragma unroll
        for (int c = 0; c < P::NCH; ++c) {
          sm90::tma_load_3d(st + c * BQ * SW, &map_q, &full[stage], c * CW, q0, bh);
          sm90::tma_load_3d(st + P::QT + c * BQ * SW, &map_do, &full[stage], c * CW, q0, bh);
        }
        const size_t row = (size_t)bh * Tp + q0;
        sm90::bulk_load(st + 2 * P::QT, lse2 + row, BQ * 4, &full[stage]);
        sm90::bulk_load(st + 2 * P::QT + BQ * 4, delta + row, BQ * 4, &full[stage]);
        if (++stage == stages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    sm90::reg_alloc<240>();
    const int w = wg - 1;
    const int t = threadIdx.x - 128 * wg, warp = t / 32, lane = t % 32;
    const int kr0 = P::COLSPLIT ? 0 : 64 * w;      // this warpgroup's keys in the block
    const int qc0 = P::COLSPLIT ? NS * w : 0;      // its S^T columns in a query tile
    const int dc0 = P::COLSPLIT ? ND * w : 0;      // its dK and dV columns
    const int rl = kr0 + warp * 16 + lane / 4;     // this thread's keys: rl, rl + 8
    const int col0 = 2 * (lane % 4);
    const float sl2 = scale * kLog2e;
    const uint32_t aK = sm90::smem_u32(sK) + kr0 * SW, aV = sm90::smem_u32(sV) + kr0 * SW;
    const uint32_t aP = sm90::smem_u32(sP) + kr0 * 128, adS = sm90::smem_u32(sdS) + kr0 * 128;
    float dv_acc[ND / 2], dk_acc[ND / 2];
    zero(dv_acc);
    zero(dk_acc);
    // Tile i is in stage i % stages at phase (i / stages) % 2, released
    // once its dV and dK products have landed (see the note at the top on
    // issuing the next tile's products earlier).
    if (n_tiles > 0) sm90::mbar_wait(kv_full, 0);
    int stage = 0, phase = 0;
    for (int i = 0; i < n_tiles; ++i) {
      const int q0 = qt_first + (i % n_qt) * BQ;
      const bool whole = mask.all_visible(q0, q0 + BQ, k0, k0 + BKV);
      const uint8_t* st = ring + stage * P::KV_STAGE;
      const uint32_t aQ = sm90::smem_u32(st), aO = aQ + P::QT;
      const float* L2 = reinterpret_cast<const float*>(st + 2 * P::QT);
      const float* Dl = L2 + BQ;
      sm90::mbar_wait(&full[stage], phase);
      // S^T = K Q^T and dP^T = V dO^T over this warpgroup's keys and queries.
      float s[NS / 2], dp[NS / 2];
      issue_sdp<D, NS, BKV, SW>(s, dp, aK, aV, aQ + qc0 * SW, aO + qc0 * SW, BQ);
      sm90::wgmma_wait<1>();
      sm90::fence_regs(s);
      // P^T from the saved log-sum-exp; the mask only where the band cuts.
#pragma unroll
      for (int i8 = 0; i8 < NS / 8; ++i8) {
        const int qc = qc0 + 8 * i8 + col0;
        const float2 l2 = *reinterpret_cast<const float2*>(L2 + qc);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2f(s[4 * i8 + e] * sl2 - ((e & 1) ? l2.y : l2.x));
          if (!whole && !mask.visible(q0 + qc + (e & 1), k0 + rl + 8 * (e >> 1))) p = 0.f;
          s[4 * i8 + e] = p;
        }
      }
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dp);
#pragma unroll
      for (int i8 = 0; i8 < NS / 8; ++i8) {
        const float2 dl = *reinterpret_cast<const float2*>(Dl + qc0 + 8 * i8 + col0);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[4 * i8 + e] = s[4 * i8 + e] * (dp[4 * i8 + e] - ((e & 1) ? dl.y : dl.x));
      }
      // P^T and dS^T to shared memory (bf16, the 128-byte swizzle) once both
      // warpgroups have finished the last tile's dV and dK products.
      sm90::named_bar_sync(1, 256);
#pragma unroll
      for (int i8 = 0; i8 < NS / 8; ++i8)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = rl + 8 * h;
          const int off = row * 128 + ((((qc0 >> 3) + i8) ^ (row & 7)) << 4) + 4 * (lane & 3);
          *reinterpret_cast<uint32_t*>(sP + off) =
              sm90::pack_bf16(s[4 * i8 + 2 * h], s[4 * i8 + 2 * h + 1]);
          *reinterpret_cast<uint32_t*>(sdS + off) =
              sm90::pack_bf16(dp[4 * i8 + 2 * h], dp[4 * i8 + 2 * h + 1]);
        }
      sm90::fence_proxy_async();
      sm90::named_bar_sync(2, 256);
      // dV += P^T dO, dK += dS^T Q over this warpgroup's keys and columns.
      sm90::fence_regs(dv_acc);
      sm90::fence_regs(dk_acc);
      sm90::wgmma_fence();
#pragma unroll
      for (int j = 0; j < BQ / 16; ++j)
        sm90::wgmma_ss<ND, 1>(dv_acc, sm90::desc_kmajor<128>(aP, j, BKV * 128),
                              sm90::desc_mnmajor<SW>(aO + (dc0 / CW) * BQ * SW, j, BQ * SW), 1);
#pragma unroll
      for (int j = 0; j < BQ / 16; ++j)
        sm90::wgmma_ss<ND, 1>(dk_acc, sm90::desc_kmajor<128>(adS, j, BKV * 128),
                              sm90::desc_mnmajor<SW>(aQ + (dc0 / CW) * BQ * SW, j, BQ * SW), 1);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dv_acc);
      sm90::fence_regs(dk_acc);
      if (lane == 0) sm90::mbar_arrive(&empty[stage]);
      if (++stage == stages) {
        stage = 0;
        phase ^= 1;
      }
    }

    if (cluster == 1) {
      const size_t kv_off = (size_t)bkv * mask.S * D;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = k0 + rl + 8 * h;
        if (r >= mask.S) continue;
#pragma unroll
        for (int i8 = 0; i8 < ND / 8; ++i8) {
          const size_t at = kv_off + (size_t)r * D + dc0 + 8 * i8 + col0;
          *reinterpret_cast<__nv_bfloat162*>(dv + at) =
              __floats2bfloat162_rn(dv_acc[4 * i8 + 2 * h], dv_acc[4 * i8 + 2 * h + 1]);
          *reinterpret_cast<__nv_bfloat162*>(dk + at) = __floats2bfloat162_rn(
              dk_acc[4 * i8 + 2 * h] * scale, dk_acc[4 * i8 + 2 * h + 1] * scale);
        }
      }
    } else {
      // The partials over the tiles no product reads any more: dV rows,
      // then dK rows, RS floats apart.
      sm90::named_bar_sync(1, 256);
      float* red = reinterpret_cast<float*>(smem);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = rl + 8 * h;
#pragma unroll
        for (int i8 = 0; i8 < ND / 8; ++i8) {
          const int col = dc0 + 8 * i8 + col0;
          *reinterpret_cast<float2*>(red + row * P::RS + col) =
              make_float2(dv_acc[4 * i8 + 2 * h], dv_acc[4 * i8 + 2 * h + 1]);
          *reinterpret_cast<float2*>(red + (BKV + row) * P::RS + col) =
              make_float2(dk_acc[4 * i8 + 2 * h], dk_acc[4 * i8 + 2 * h + 1]);
        }
      }
    }
  }

  if (cluster > 1) {
    // Every block's partials are in its shared memory; block `rank` sums
    // its share of the float4s over ranks 0, 1, .. in that order.
    __syncwarp();
    sm90::cluster_arrive();
    sm90::cluster_wait();
    if (wg > 0) {
      constexpr int PER_ROW = D / 4, UNITS = 2 * BKV * PER_ROW;
      const int u_lo = (int)((long)UNITS * rank / cluster);
      const int u_hi = (int)((long)UNITS * (rank + 1) / cluster);
      const uint32_t base = sm90::smem_u32(smem);
      for (int u = u_lo + (int)threadIdx.x - 128; u < u_hi; u += 256) {
        const int row2 = u / PER_ROW, c4 = (u - row2 * PER_ROW) * 4;
        const uint32_t off = (uint32_t)(row2 * P::RS + c4) * 4;
        float4 acc = sm90::ld_cluster_f32x4(sm90::mapa(base + off, 0));
        for (int p = 1; p < cluster; ++p) {
          const float4 v = sm90::ld_cluster_f32x4(sm90::mapa(base + off, p));
          acc.x += v.x;
          acc.y += v.y;
          acc.z += v.z;
          acc.w += v.w;
        }
        const bool is_dk = row2 >= BKV;
        const int key = k0 + row2 - (is_dk ? BKV : 0);
        if (key >= mask.S) continue;
        const float mul = is_dk ? scale : 1.f;
        bf16* g = (is_dk ? dk : dv) + ((size_t)bkv * mask.S + key) * D + c4;
        __nv_bfloat162 lo = __floats2bfloat162_rn(acc.x * mul, acc.y * mul);
        __nv_bfloat162 hi = __floats2bfloat162_rn(acc.z * mul, acc.w * mul);
        uint2 pack;
        pack.x = *reinterpret_cast<uint32_t*>(&lo);
        pack.y = *reinterpret_cast<uint32_t*>(&hi);
        *reinterpret_cast<uint2*>(g) = pack;
      }
    }
    // No block leaves while a peer may still read its partials.
    sm90::cluster_arrive();
    sm90::cluster_wait();
  }
}

template <int D>
__global__ void __launch_bounds__(BW_THREADS, 1) flash_bwd_dq_wgmma_kernel(
    const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
    const __grid_constant__ CUtensorMap map_v, const __grid_constant__ CUtensorMap map_do,
    const float* __restrict__ lse2, const float* __restrict__ delta, bf16* __restrict__ dq,
    int Hq, int group, int Tp, Mask mask, float scale, int stages) {
  using P = BwdTiles<D>;
  constexpr int SW = P::SW, CW = P::CW, BK = P::DQ_KEYS, BQ = P::DQ_ROWS;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sQ = smem;
  uint8_t* sO = sQ + P::DQ_Q;                  // the dO tile
  uint8_t* ring = sO + P::DQ_Q;                // stage s: K at 2 s DQ_KT, V after it
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ring + stages * 2 * P::DQ_KT);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + MAX_STAGES;

  // Heads run fastest and query tiles from the last: the longest causal
  // bands start first.
  const int bh = blockIdx.x;
  const int b = bh / Hq, hq = bh - b * Hq;
  const int bkv = b * (Hq / group) + hq / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  int lo, hi;
  mask.key_range(q0, q0 + BQ, lo, hi);
  const int kb_first = (lo / BK) * BK;
  const int n_tiles = hi > lo && q0 < mask.T ? (hi - kb_first + BK - 1) / BK : 0;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < stages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 8);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    sm90::reg_dealloc<24>();
    if (threadIdx.x == 0 && n_tiles > 0) {
      sm90::tma_prefetch_map(&map_k);
      sm90::tma_prefetch_map(&map_v);
      sm90::mbar_arrive_expect_tx(q_full, 2 * P::DQ_Q);
#pragma unroll
      for (int c = 0; c < P::NCH; ++c) {
        sm90::tma_load_3d(sQ + c * BQ * SW, &map_q, q_full, c * CW, q0, bh);
        sm90::tma_load_3d(sO + c * BQ * SW, &map_do, q_full, c * CW, q0, bh);
      }
      int stage = 0, phase = 0;
      for (int i = 0; i < n_tiles; ++i) {
        const int kb = kb_first + i * BK;
        uint8_t* sK = ring + stage * 2 * P::DQ_KT;
        sm90::mbar_wait(&empty[stage], phase ^ 1);
        sm90::mbar_arrive_expect_tx(&full[stage], 2 * P::DQ_KT);
#pragma unroll
        for (int c = 0; c < P::NCH; ++c) {
          sm90::tma_load_3d(sK + c * BK * SW, &map_k, &full[stage], c * CW, kb, bkv);
          sm90::tma_load_3d(sK + P::DQ_KT + c * BK * SW, &map_v, &full[stage], c * CW, kb, bkv);
        }
        if (++stage == stages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    sm90::reg_alloc<240>();
    const int w = wg - 1;
    const int t = threadIdx.x - 128 * wg, warp = t / 32, lane = t % 32;
    const int r_lo = q0 + 64 * w;                   // this warpgroup's 64 rows
    const int row0 = r_lo + warp * 16 + lane / 4;   // this thread's rows: row0, row0 + 8
    const int col0 = 2 * (lane % 4);
    const float sl2 = scale * kLog2e;
    const uint32_t aQ = sm90::smem_u32(sQ) + 64 * w * SW, aO = sm90::smem_u32(sO) + 64 * w * SW;
    float l2[2], dl[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l2[h] = lse2[(size_t)bh * Tp + row0 + 8 * h];
      dl[h] = delta[(size_t)bh * Tp + row0 + 8 * h];
    }
    float acc[D / 2];
    zero(acc);
    // Tile i's stage is released once its dQ product has landed.
    if (n_tiles > 0) sm90::mbar_wait(q_full, 0);
    int stage = 0, phase = 0;
    for (int i = 0; i < n_tiles; ++i) {
      const int kb = kb_first + i * BK;
      const bool whole = mask.all_visible(r_lo, r_lo + 64, kb, kb + BK);
      const uint32_t aK = sm90::smem_u32(ring + stage * 2 * P::DQ_KT), aV = aK + P::DQ_KT;
      sm90::mbar_wait(&full[stage], phase);
      float s[BK / 2], dp[BK / 2];
      issue_sdp<D, BK, BQ, SW>(s, dp, aQ, aO, aK, aV, BK);
      sm90::wgmma_wait<1>();
      sm90::fence_regs(s);
#pragma unroll
      for (int i8 = 0; i8 < BK / 8; ++i8)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2f(s[4 * i8 + e] * sl2 - l2[e >> 1]);
          if (!whole && !mask.visible(row0 + 8 * (e >> 1), kb + 8 * i8 + col0 + (e & 1)))
            p = 0.f;
          s[4 * i8 + e] = p;
        }
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dp);
      // dS, rounded to bf16: the accumulator pairs are the A fragments of
      // the k16 steps of dQ += dS K.
      uint32_t da[BK / 16][4];
#pragma unroll
      for (int j = 0; j < BK / 16; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int e0 = 8 * j + 2 * r;
          const int h = r & 1;
          da[j][r] = sm90::pack_bf16(s[e0] * (dp[e0] - dl[h]), s[e0 + 1] * (dp[e0 + 1] - dl[h]));
        }
      sm90::fence_regs(acc);
      sm90::wgmma_fence();
#pragma unroll
      for (int j = 0; j < BK / 16; ++j)
        sm90::wgmma_rs<D, 1>(acc, da[j], sm90::desc_mnmajor<SW>(aK, j, BK * SW), 1);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
      keep_regs(da);
      if (lane == 0) sm90::mbar_arrive(&empty[stage]);
      if (++stage == stages) {
        stage = 0;
        phase ^= 1;
      }
    }
    bf16* g = dq + (size_t)bh * mask.T * D;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + 8 * h;
      if (r >= mask.T) continue;
#pragma unroll
      for (int i8 = 0; i8 < D / 8; ++i8)
        *reinterpret_cast<__nv_bfloat162*>(g + (size_t)r * D + 8 * i8 + col0) =
            __floats2bfloat162_rn(acc[4 * i8 + 2 * h] * scale, acc[4 * i8 + 2 * h + 1] * scale);
    }
  }
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

int launch_delta(const void* o, const void* dout, float* delta, long rows, int D,
                 cudaStream_t s) {
  const long blocks = (rows + NT / 32 - 1) / (NT / 32);
  flash_bwd_delta_kernel<<<(unsigned)blocks, NT, 0, s>>>(
      static_cast<const float*>(o), static_cast<const float*>(dout), delta, rows, D);
  return (int)cudaGetLastError();
}

// The rows of the bf16 path's lse2 / delta scratch: T rounded up to PAD_ROWS.
inline int padded_rows(int T) { return (T + PAD_ROWS - 1) / PAD_ROWS * PAD_ROWS; }

// A bf16 (D, rows, heads) tensor map: boxes of CW columns and `box_rows`
// rows, the 128-byte (64-byte at D = 32) swizzle; rows past `rows` of a
// head load as zeros.
template <int D>
int encode_rows(CUtensorMap* map, const void* p, int rows, int heads, int box_rows) {
  using P = BwdTiles<D>;
  const uint64_t dims[3] = {(uint64_t)D, (uint64_t)rows, (uint64_t)heads};
  const uint64_t strides[2] = {(uint64_t)D * 2, (uint64_t)rows * D * 2};
  const uint32_t box[3] = {(uint32_t)P::CW, (uint32_t)box_rows, 1};
  return sm90::encode_bf16_map(map, 3, p, dims, strides, box, P::SW);
}

template <typename Kernel>
cudaError_t launch_cluster(Kernel kernel, dim3 grid, int smem, int cluster, cudaStream_t s,
                           void** args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(BW_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(kernel), args);
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, const void* out, const void* dout,
                const float* lse, float* scratch, void* dq, void* dk, void* dv, int B, int Hq,
                int Hkv, const Mask& mask, float scale, int kv_tile, int kv_stages, int dq_keys,
                int dq_stages, int cluster, cudaStream_t s) {
  using P = BwdTiles<D>;
  static_assert(2 * P::BKV * P::RS * 4 <= 2 * P::KV_TILE + 2 * P::KV_STAGE + 2 * P::PT,
                "the cluster's partials fit the tiles of the shallowest ring");
  const int group = Hq / Hkv;
  if (kv_tile != P::BKV || dq_keys != P::DQ_KEYS || kv_stages < 2 || kv_stages > MAX_STAGES ||
      dq_stages < 2 || dq_stages > MAX_STAGES || dkdv_smem<D>(kv_stages) > SMEM_LIMIT ||
      dq_smem<D>(dq_stages) > SMEM_LIMIT || cluster < 1 || cluster > MAX_CLUSTER ||
      group % cluster != 0)
    return (int)cudaErrorInvalidValue;
  const int Tp = padded_rows(mask.T);
  const long rows = (long)B * Hq * Tp;
  float* lse2 = scratch;
  float* delta = scratch + rows;
  const long blocks = (rows + NT / 32 - 1) / (NT / 32);
  flash_bwd_prep_kernel<D><<<(unsigned)blocks, NT, 0, s>>>(
      static_cast<const bf16*>(out), static_cast<const bf16*>(dout), lse, lse2, delta, rows,
      mask.T, Tp);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  CUtensorMap mq, mdo, mk, mv, mq2, mdo2, mk2, mv2;
  int err = encode_rows<D>(&mq, q, mask.T, B * Hq, P::BQ);
  if (!err) err = encode_rows<D>(&mdo, dout, mask.T, B * Hq, P::BQ);
  if (!err) err = encode_rows<D>(&mk, k, mask.S, B * Hkv, P::BKV);
  if (!err) err = encode_rows<D>(&mv, v, mask.S, B * Hkv, P::BKV);
  if (!err) err = encode_rows<D>(&mq2, q, mask.T, B * Hq, P::DQ_ROWS);
  if (!err) err = encode_rows<D>(&mdo2, dout, mask.T, B * Hq, P::DQ_ROWS);
  if (!err) err = encode_rows<D>(&mk2, k, mask.S, B * Hkv, P::DQ_KEYS);
  if (!err) err = encode_rows<D>(&mv2, v, mask.S, B * Hkv, P::DQ_KEYS);
  if (err) return err;

  const int smem_kv = dkdv_smem<D>(kv_stages), smem_q = dq_smem<D>(dq_stages);
  e = cudaFuncSetAttribute(flash_bwd_dkdv_wgmma_kernel<D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(flash_bwd_dq_wgmma_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_q);
  if (e != cudaSuccess) return (int)e;

  // dK/dV: x = (KV head, cluster rank), y = key tile, the lowest first.
  bf16 *dk_ = static_cast<bf16*>(dk), *dv_ = static_cast<bf16*>(dv);
  int Hq_ = Hq, Hkv_ = Hkv, Tp_ = Tp, st_kv = kv_stages, cl = cluster;
  Mask m = mask;
  float sc = scale;
  void* args_kv[] = {&mq, &mk, &mv, &mdo, &lse2, &delta, &dk_, &dv_, &Hq_, &Hkv_, &Tp_,
                     &m, &sc, &st_kv, &cl};
  const dim3 g_kv(B * Hkv * cluster, (mask.S + P::BKV - 1) / P::BKV);
  e = launch_cluster(flash_bwd_dkdv_wgmma_kernel<D>, g_kv, smem_kv, cluster, s, args_kv);
  if (e == cudaSuccess) e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const dim3 g_q(B * Hq, Tp / P::DQ_ROWS);
  flash_bwd_dq_wgmma_kernel<D><<<g_q, BW_THREADS, smem_q, s>>>(
      mq2, mk2, mv2, mdo2, lse2, delta, static_cast<bf16*>(dq), Hq, group, Tp, mask, scale,
      dq_stages);
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

template <typename Kernel>
int blocks_per_sm(Kernel kernel, int threads, int smem) {
  cudaError_t e = cudaSuccess;
  if (smem > 0)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int n = 0;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, smem);
  return e == cudaSuccess ? n : -(int)e;
}

// Blocks an SM of the bf16 backward's kernel 0 (dK/dV), 1 (dQ) or 2 (prep)
// at a ring of `stages`, with the shared memory its launcher gives it.
template <int D>
int occupancy_bf16(int kernel, int stages) {
  if (kernel == 0) return blocks_per_sm(flash_bwd_dkdv_wgmma_kernel<D>, BW_THREADS, dkdv_smem<D>(stages));
  if (kernel == 1) return blocks_per_sm(flash_bwd_dq_wgmma_kernel<D>, BW_THREADS, dq_smem<D>(stages));
  if (kernel == 2) return blocks_per_sm(flash_bwd_prep_kernel<D>, NT, 0);
  return -(int)cudaErrorInvalidValue;
}

}  // namespace

// q, out, dout, dq: (B, Hq, T, D); k, v, dk, dv: (B, Hkv, S, D); all
// contiguous, one dtype: 0 = float32, 1 = bfloat16 (16-byte aligned).  lse:
// (B, Hq, T) f32 from the forward (flash_attention_fwd's `lse`).  scratch:
// f32, filled by the call: bf16 takes 2 * B * Hq * Tp floats (lse * log2 e
// and delta, Tp = T rounded up to 128), f32 B * Hq * T (delta).  D in {32,
// 64, 128, 256}, and 96 in f32; Hkv | Hq.  causal: 0 or 1; window < 1 means none; scale as
// the forward's.  The bf16 plan, from the wrapper
// (local_attention/kernel.py:plan_flash_bwd): kv_tile keys a dK/dV block
// (64 at D = 256, else 128), a ring of kv_stages; dq_keys keys a dQ ring
// stage (32 at D = 256, else 64), a ring of dq_stages (2..4 each, within
// the shared memory); cluster blocks a KV head's group (1..8, dividing
// Hq / Hkv).  f32 takes no plan (pass zeros).  Returns 0, the cudaError_t
// of the first launch that failed, or sm90::kTensorMapError + a CUresult.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* out, const void* dout, const float* lse,
                                   float* scratch, void* dq, void* dk, void* dv, int B, int Hq,
                                   int Hkv, int T, int S, int D, int causal, int window,
                                   float scale, int dtype, int kv_tile, int kv_stages,
                                   int dq_keys, int dq_stages, int cluster, void* stream) {
  if (B < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv || T < 1 || S < 1 || B * Hq > 65535)
    return (int)cudaErrorInvalidValue;
  const Mask mask{T, S, S - T, window, causal ? 1 : 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    switch (D) {
#define FLASH_BWD_BF16(DD)                                                                       \
  case DD:                                                                                       \
    return launch_bf16<DD>(q, k, v, out, dout, lse, scratch, dq, dk, dv, B, Hq, Hkv, mask,       \
                           scale, kv_tile, kv_stages, dq_keys, dq_stages, cluster, s);
      FLASH_BWD_BF16(32)
      FLASH_BWD_BF16(64)
      FLASH_BWD_BF16(128)
      FLASH_BWD_BF16(256)
#undef FLASH_BWD_BF16
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (dtype == 0) {
    const long rows = (long)B * Hq * T;
    int err = launch_delta(out, dout, scratch, rows, D, s);
    if (err) return err;
    switch (D) {
      case 32: return launch_f32<32>(q, k, v, dout, lse, scratch, dq, dk, dv, B, Hq, Hkv, mask, scale, s);
      case 64: return launch_f32<64>(q, k, v, dout, lse, scratch, dq, dk, dv, B, Hq, Hkv, mask, scale, s);
      case 96: return launch_f32<96>(q, k, v, dout, lse, scratch, dq, dk, dv, B, Hq, Hkv, mask, scale, s);
      case 128: return launch_f32<128>(q, k, v, dout, lse, scratch, dq, dk, dv, B, Hq, Hkv, mask, scale, s);
      case 256: return launch_f32<256>(q, k, v, dout, lse, scratch, dq, dk, dv, B, Hq, Hkv, mask, scale, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaErrorInvalidValue;
}

// The dynamic shared memory (bytes) of one block of the bf16 dK/dV kernel
// (kernel 0) or dQ kernel (kernel 1) at head width d and a ring of `stages`
// (the planner's mirror, local_attention/kernel.py:bwd_smem_bytes); -1 for
// a width that is not compiled.
extern "C" int flash_bwd_smem(int d, int kernel, int stages) {
  switch (d) {
    case 32: return kernel == 0 ? dkdv_smem<32>(stages) : dq_smem<32>(stages);
    case 64: return kernel == 0 ? dkdv_smem<64>(stages) : dq_smem<64>(stages);
    case 128: return kernel == 0 ? dkdv_smem<128>(stages) : dq_smem<128>(stages);
    case 256: return kernel == 0 ? dkdv_smem<256>(stages) : dq_smem<256>(stages);
    default: return -1;
  }
}

// The library's launch query for the bf16 backward (kernel 0 dK/dV, 1 dQ, 2
// prep; p0 the head width, p1 the ring's stages): blocks an SM from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor with the launch's dynamic
// shared memory, or minus a cudaError_t.
extern "C" int flash_attention_bwd_occupancy(int kernel, int p0, int p1, int p2, int p3,
                                             int p4) {
  (void)p2, (void)p3, (void)p4;
  switch (p0) {
    case 32: return occupancy_bf16<32>(kernel, p1);
    case 64: return occupancy_bf16<64>(kernel, p1);
    case 128: return occupancy_bf16<128>(kernel, p1);
    case 256: return occupancy_bf16<256>(kernel, p1);
    default: return -(int)cudaErrorInvalidValue;
  }
}
