// Chunked RWKV6 WKV forward for Hopper (sm_90a), plain C interface.
//
// Replaces: src/repro/kernels/wkv/kernel.py:wkv_pallas (body _wkv_fwd_body,
// launcher _wkv_pallas_call), the prefill of prompts longer than 64 tokens,
// wkv_pallas_train (the same sweep that also writes s_hist, the state
// entering each chunk, for the backward in wkv_bwd.cu), and the segment-
// summary pair wkv_pallas_summary / wkv_pallas_train_summary (the same
// sweeps that also write a_seg, the product of the segment's decays, which
// the sequence-parallel path composes across shards).
//
//   S_t = diag(w_t) S_{t-1} + k_t^T v_t,   o_t = r_t . (S_{t-1} + u k_t^T v_t)
//
// computed per chunk of L tokens in the decay-ratio form of the reference
// (logw = log(clip(w, 1e-8, 1)), inclusive/exclusive cumulative sums, r_dec,
// k_inv, k_rem, a strictly lower score matrix and the u-bonus diagonal), all
// in f32.  The model clips |log w| <= 4, so at L <= 16 no exponent exceeds 64
// and f32 holds every ratio; L is a runtime argument from 1 to 64.
//
// What bounds it.  The card: at the main path's shapes the f32 arithmetic
// on the CUDA cores.  A chunk of L tokens costs L(L-1) Dh (scores) + 2 L^2
// Dh (intra) + 4 L Dh^2 (inter and the state update) operations per
// (batch, head): 0.635 GFLOP at B=4, H=32, T=256, L=16, 9.5 us at 67
// TFLOP/s, against 7.5 us of device-memory bytes (r/k/v/w/out once each,
// S in and out); the training forward adds s_hist, B*H*(T/L)*16 KiB (33.5
// MB there), and is bound by bytes.  This kernel: each block walks its
// chunks one after another, so what holds it is the latency of one chunk's
// chain on few warps.  The old kernel paid DRAM latency at every chunk
// (synchronous loads), scanned the decays serially on 64 threads, and ran
// every product as a 64-long chain of one accumulator behind five barriers
// (8-11 us a chunk).  Probes of this design found three more limits, each
// addressed below: shared-memory bandwidth (every float a thread loads
// costs the SM 1/32 of a cycle, broadcast or not, so a 2 x 2 micro-tile
// reaches a third of the FMA rate), bank conflicts where the lanes of one
// warp read different key quarters, and branches around each token of the
// scan, which kept the compiler from interleaving the tokens.
//
// Design.  The carry is the only serial dependency, and it is one FMA per
// state element: S_{c+1} = diag(w_tot) S_c + U_c with U_c = k_rem^T v, which
// like everything else of a chunk but out += r_dec S_c does not need S.  So
// one block per (batch*head, tile of JT value columns) runs two roles, chunk
// c+1's prep beside chunk c's carry, handing over through two slots of
// shared memory with named barriers (bar.arrive / bar.sync) between them:
//
// - prep (8 warps): waits for chunk c's r, k, w rows and v tile in a ring
//   of shared memory that TMA fills (3-D tensor maps over (B*H, T, 64) with
//   the caller's T stride, so a T-window is read in place; thread 0 issues
//   chunk c+2 as soon as chunk c's stage is read; two stages, one where two
//   do not fit: chunk 64 in f32).  The cumulative log-decay as a scan over
//   four segments of the L tokens per key column (branch-free, the tokens'
//   loads ahead of the math, the segments' totals exchanged by warp
//   shuffles); r_dec, k_inv, k_rem = k_inv w_tot, w_tot; the u-bonus as
//   warp partials of a shuffle tree over the warp's keys; the strictly
//   lower scores (up to chunk 16 their 64 keys in four quarters, one plane
//   each, so each thread's chain is short).  All into the hand-off slot.
// - carry (8 warps): sums the score planes and the bonus partials in a
//   fixed order; S_{c+1} = w_tot S_c + k_rem^T v into the other of two S
//   tiles; out = scores @ v + bonus v + r_dec @ S_c as five partial planes
//   (scores @ v, and r_dec @ S over each key quarter) summed in a fixed
//   order and stored.  With s_hist on, one thread stores S_c, the
//   tile it is reading anyway, to s_hist[c] with a TMA store that runs
//   beside the chunk (a bulk-async group, waited on before the tile is
//   written again).
//
// Every product is a 4 x 4 (scores: 2 x 2 to 4 x 4) outer-product
// micro-tile per thread of k-major tiles with float4 loads, never a 64-long
// chain of one accumulator; tiles above the diagonal or past L are skipped.
// S stays in shared memory for the whole sweep: it touches device memory
// once on the way in, once on the way out, and (training) once a chunk
// through s_hist.  The value-column tile JT (64, 32, 16 or 8) comes from
// the wrapper's plan (kernel.py:plan_columns, one block an SM: 64 columns
// at B=4, 16 at B=1); column j of out and S depends only on column j of v
// and S, and every element is summed in the same order whatever the tile,
// so the outputs are bit-equal across plans.
//
// Segment summary (a_seg not null): a_seg[b, h, i] = prod_t clip(w_t[i],
// 1e-8, 1), in the Pallas order: the carry starts at 1 and each chunk
// multiplies in its w_total = exp(sum of the chunk's log w), which the
// prep thread of key column i computes anyway.  Only the block of the
// first column tile writes it.  A long segment underflows to 0 (denormals
// are kept).  The summary launches may read r/k/v/w in place as a T-window
// of longer tensors: T_stride is the token count between consecutive
// (b, h) rows (T_len for contiguous inputs); out is always contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstring>

#include "sm90.cuh"

namespace {

constexpr int DH = 64;         // key/value width of one WKV head
constexpr int PREP = 256;      // threads of the prep role (8 warps)
constexpr int CARRY = 256;     // threads of the carry role (8 warps)
constexpr int NT = PREP + CARRY;
constexpr int MAX_CHUNK = 64;
constexpr size_t SMEM_LIMIT = 232448;   // dynamic shared memory a block may take
// Named barriers: prep's own; the hand-off slots' full and empty; carry's own.
constexpr int BAR_PREP = 1, BAR_FULL = 2, BAR_EMPTY = 4, BAR_CARRY = 6;
// Score planes a chunk: the scores' keys in four quarters (chunks up to 16,
// whose 2 x 2 tiles are too short a chain over all 64 keys), else one.
__host__ __device__ constexpr int score_planes(int LP) { return LP <= 16 ? 4 : 1; }

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ float logw(float w) { return logf(fminf(fmaxf(w, 1e-8f), 1.0f)); }

__host__ __device__ constexpr size_t up128(size_t x) { return (x + 127) / 128 * 128; }

// The padded chunk: L rounded up to a power of two, at least 4.
constexpr int padded(int L) { return L <= 4 ? 4 : L <= 8 ? 8 : L <= 16 ? 16 : L <= 32 ? 32 : 64; }

// Byte offsets of the shared-memory regions, the same on host and device.
// Tiles named ...T are transposed ([key column or token][token], row
// stride LP + 4).  A hand-off slot holds what prep gives carry for one
// chunk: r_dec^T, k_rem, v (f32), the masked scores^T (one plane per key
// quarter, or one), the bonus's warp partials, w_total.
struct Layout {
  size_t bars, u, ring, stage, r, k, w, v;
  size_t slot, slot_size, rdecT, krem, vf, scT, bpart, wtot;
  size_t kinvT, kinv_size, cbonus, csc, part, S, S_size, total;
  int ns;   // ring stages
};

__host__ __device__ inline Layout layout(int LP, int JT, int E, int ns) {
  Layout y{};
  const size_t LD = LP + 4;
  y.ns = ns;
  y.bars = 0;
  y.u = 128;
  y.ring = up128(y.u + DH * 4);
  y.r = 0;
  y.k = up128((size_t)LP * DH * E);
  y.w = 2 * y.k;
  y.v = 3 * y.k;
  y.stage = up128(y.v + (size_t)LP * JT * E);
  y.slot = y.ring + ns * y.stage;
  y.rdecT = 0;
  y.krem = up128(DH * LD * 4);
  y.vf = y.krem + up128((size_t)LP * DH * 4);
  y.scT = y.vf + up128((size_t)LP * JT * 4);
  y.bpart = y.scT + up128((size_t)score_planes(LP) * LP * LD * 4);
  y.wtot = y.bpart + up128((size_t)(PREP / 32) * LP * 4);
  y.slot_size = y.wtot + up128(DH * 4);
  y.kinvT = y.slot + 2 * y.slot_size;
  y.kinv_size = up128(DH * LD * 4);
  y.cbonus = y.kinvT + 2 * y.kinv_size;
  y.csc = y.cbonus + up128((size_t)LP * 4);
  y.part = y.csc + up128((size_t)LP * LD * 4);
  y.S = y.part + up128((size_t)5 * LP * JT * 4);
  y.S_size = up128((size_t)DH * JT * 4);
  y.total = y.S + 2 * y.S_size;
  return y;
}

// Two ring stages where they fit, else one (chunk 64 in f32).
__host__ __device__ inline Layout fit_layout(int LP, int JT, int E) {
  const Layout two = layout(LP, JT, E, 2);
  return two.total <= SMEM_LIMIT ? two : layout(LP, JT, E, 1);
}

template <int N>
__device__ __forceinline__ void ldv(float (&x)[N], const float* p) {
  if constexpr (N == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    x[0] = q.x; x[1] = q.y; x[2] = q.z; x[3] = q.w;
  } else if constexpr (N == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    x[0] = q.x; x[1] = q.y;
  } else {
    x[0] = *p;
  }
}

// acc[a][b] += sum_{k < K} At[k * lda + a] * B[k * ldb + b]: one thread's
// TM x TN micro-tile of a product whose operands are stored k-major (the
// left one transposed), each element summed over k in order.
template <int TM, int TN>
__device__ __forceinline__ void mm_acc(float (&acc)[TM][TN], const float* At, int lda,
                                       const float* B, int ldb, int K) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float a[TM], b[TN];
    ldv<TM>(a, At + (size_t)k * lda);
    ldv<TN>(b, B + (size_t)k * ldb);
#pragma unroll
    for (int x = 0; x < TM; ++x)
#pragma unroll
      for (int y = 0; y < TN; ++y) acc[x][y] = fmaf(a[x], b[y], acc[x][y]);
  }
}

template <typename T, int LP>
__global__ void __launch_bounds__(NT, 1) wkv_fwd_kernel(
    const __grid_constant__ CUtensorMap map_r, const __grid_constant__ CUtensorMap map_k,
    const __grid_constant__ CUtensorMap map_w, const __grid_constant__ CUtensorMap map_v,
    const __grid_constant__ CUtensorMap map_hist, const T* __restrict__ u,
    const float* __restrict__ h0, T* __restrict__ out, float* __restrict__ s_out,
    float* __restrict__ a_seg, int H, int T_len, int L, int JT, int with_hist) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int E = sizeof(T);
  constexpr int LD = LP + 4;
  const Layout Y = fit_layout(LP, JT, E);
  const int NS = Y.ns;
  auto F = [&](size_t off) { return reinterpret_cast<float*>(smem + off); };
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Y.bars);
  float* s_u = F(Y.u);

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;          // b * H + h
  const int h = bh % H;
  const int j0 = blockIdx.x * JT;     // first value column of this block
  const int n = T_len / L;
  const int jsh = 31 - __clz(JT);     // JT = 1 << jsh
  const size_t st0 = (size_t)bh * DH * DH;
  const size_t out0 = (size_t)bh * T_len * DH;
  auto stage = [&](int c) { return smem + Y.ring + (size_t)(c % NS) * Y.stage; };
  auto slot = [&](int c) { return smem + Y.slot + (size_t)(c & 1) * Y.slot_size; };
  auto S_tile = [&](int c) { return F(Y.S + (size_t)(c & 1) * Y.S_size); };
  auto issue = [&](int c) {
    unsigned char* st = stage(c);
    uint64_t* bar = &full[c % NS];
    sm90::mbar_arrive_expect_tx(bar, (uint32_t)((3 * DH + JT) * L * E));
    sm90::tma_load_3d(st + Y.r, &map_r, bar, 0, c * L, bh);
    sm90::tma_load_3d(st + Y.k, &map_k, bar, 0, c * L, bh);
    sm90::tma_load_3d(st + Y.w, &map_w, bar, 0, c * L, bh);
    sm90::tma_load_3d(st + Y.v, &map_v, bar, j0, c * L, bh);
  };

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) sm90::mbar_init(&full[s], 1);
    sm90::mbar_fence_init();
  }
  if (tid < DH) s_u[tid] = to_f(u[h * DH + tid]);
  // Boundary: the sweep starts from h0 (the Pallas reset_carry at chunk 0).
  {
    float* S0 = S_tile(0);
    for (int idx = tid; idx < DH * JT; idx += NT)
      S0[idx] = h0[st0 + (size_t)(idx >> jsh) * DH + j0 + (idx & (JT - 1))];
  }
  sm90::fence_proxy_async();
  __syncthreads();
  if (tid == 0) {
    sm90::tma_prefetch_map(&map_r);
    sm90::tma_prefetch_map(&map_v);
    for (int c = 0; c < NS && c < n; ++c) issue(c);
  }

  if (tid < PREP) {
    // ---- prep: chunk c's decay factors, bonus and scores ------------------
    constexpr int NSEG = PREP / DH;          // segments of one key column
    constexpr int SEG = LP / NSEG;           // tokens of one segment (LP >= 4)
    constexpr int BLK = SEG < 8 ? SEG : 8;   // tokens whose loads go ahead together
    constexpr int NW = PREP / 32;
    const int i = tid / NSEG, seg = tid % NSEG;
    const int lane = tid & 31, warp = tid >> 5;
    const int gbase = lane & ~(NSEG - 1);
    const int last_seg = min((L - 1) / SEG, NSEG - 1);
    const float u_i = s_u[i];
    float a_run = 1.f;   // key column i's running decay product (seg 0)
    for (int c = 0; c < n; ++c) {
      const unsigned char* st = stage(c);
      const T* rr = reinterpret_cast<const T*>(st + Y.r);
      const T* kk = reinterpret_cast<const T*>(st + Y.k);
      const T* ww = reinterpret_cast<const T*>(st + Y.w);
      const T* vv = reinterpret_cast<const T*>(st + Y.v);
      unsigned char* hs = slot(c);
      float* rdecT = reinterpret_cast<float*>(hs + Y.rdecT);
      float* krem = reinterpret_cast<float*>(hs + Y.krem);
      float* vf = reinterpret_cast<float*>(hs + Y.vf);
      float* scT = reinterpret_cast<float*>(hs + Y.scT);
      float* bpart = reinterpret_cast<float*>(hs + Y.bpart);
      float* wtot = reinterpret_cast<float*>(hs + Y.wtot);
      // Two k_inv^T tiles: the next chunk's scan may write while this
      // chunk's scores still read.
      float* kinvT = F(Y.kinvT + (size_t)(c & 1) * Y.kinv_size);
      if (c >= 2) sm90::named_bar_sync(BAR_EMPTY + (c & 1), NT);   // carry is done with c-2
      sm90::mbar_wait(&full[c % NS], (c / NS) & 1);

      // Decay factors: the inclusive cumulative log-decay of key column i,
      // one segment of tokens per thread, the segments' totals exchanged.
      // Branch-free over the tokens (rows past L of the ring stage are read
      // and their results dropped), so the compiler interleaves them.
      float lw[SEG];
      float tot = 0.f;
#pragma unroll
      for (int a = 0; a < SEG; ++a) {
        const int t = seg * SEG + a;
        const float x = logw(to_f(ww[t * DH + i]));
        lw[a] = t < L ? x : 0.f;
        tot += lw[a];
      }
      float off = 0.f;
#pragma unroll
      for (int g = 0; g < NSEG; ++g) {
        const float x = __shfl_sync(0xffffffffu, tot, gbase + g);
        off += g < seg ? x : 0.f;
      }
      float run = off;
#pragma unroll
      for (int a = 0; a < SEG; ++a) run += lw[a];
      // The column's total: the inclusive sum at token L-1 as its owner
      // computes it below (the segments tile the padded chunk exactly).
      const float last = __shfl_sync(0xffffffffu, run, gbase + last_seg);
      const float wt = expf(last);   // w_total of key column i
      run = off;
#pragma unroll
      for (int a0 = 0; a0 < SEG; a0 += BLK) {
        float rv[BLK], kv[BLK];
#pragma unroll
        for (int b = 0; b < BLK; ++b) {
          const int t = seg * SEG + a0 + b;
          rv[b] = to_f(rr[t * DH + i]);
          kv[b] = to_f(kk[t * DH + i]);
        }
#pragma unroll
        for (int b = 0; b < BLK; ++b) {
          const int t = seg * SEG + a0 + b;
          const bool ok = t < L;
          run += lw[a0 + b];
          const float rd = rv[b] * expf(run - lw[a0 + b]);
          const float ki = kv[b] * expf(-run);
          const float kr = ki * wt;   // k e^{last - incl}
          // The u-bonus r_t . diag(u) k_t: this column's term, summed over
          // the warp's columns (lanes of one segment) in a fixed tree.
          float bp = ok ? rv[b] * u_i * kv[b] : 0.f;
#pragma unroll
          for (int m = NSEG; m < 32; m <<= 1) bp += __shfl_xor_sync(0xffffffffu, bp, m);
          rdecT[i * LD + t] = ok ? rd : 0.f;
          kinvT[i * LD + t] = ok ? ki : 0.f;
          krem[t * DH + i] = ok ? kr : 0.f;
          if (lane < NSEG) bpart[warp * LP + t] = bp;
        }
      }
      if (seg == 0) {
        wtot[i] = wt;
        a_run *= wt;
      }
      for (int idx = tid; idx < LP * JT; idx += PREP) {
        const float x = to_f(vv[idx]);
        vf[idx] = (idx >> jsh) < L ? x : 0.f;
      }
      sm90::named_bar_sync(BAR_PREP, PREP);
      // Chunk c's ring stage is read: load chunk c+NS into it.
      if (tid == 0 && c + NS < n) issue(c + NS);

      // Strictly lower scores A[t][s] = r_dec_t . k_inv_s (s < t), stored
      // transposed and masked, in the hand-off slot; tiles wholly above the
      // diagonal or past L are zeros.
      if constexpr (LP <= 16) {
        // 2 x 2 tiles, the 64 keys in four quarters: one plane each, which
        // carry sums in order.  The quarter varies slowest: a warp reads one
        // quarter's rows.
        constexpr int NB1 = LP / 2;
        for (int it = tid; it < 4 * NB1 * NB1; it += PREP) {
          const int q = it / (NB1 * NB1), tile = it % (NB1 * NB1);
          const int t0 = (tile / NB1) * 2, s0 = (tile % NB1) * 2;
          float acc[2][2] = {};
          if (s0 <= t0 && t0 < L)
            mm_acc<2, 2>(acc, rdecT + q * 16 * LD + t0, LD, kinvT + q * 16 * LD + s0, LD, 16);
#pragma unroll
          for (int a = 0; a < 2; ++a)
#pragma unroll
            for (int b = 0; b < 2; ++b) {
              const int t = t0 + a, s = s0 + b;
              scT[(q * LP + s) * LD + t] = (s < t && t < L) ? acc[a][b] : 0.f;
            }
        }
      } else {
        constexpr int NB1 = LP / 4;
        for (int it = tid; it < NB1 * NB1; it += PREP) {
          const int t0 = (it / NB1) * 4, s0 = (it % NB1) * 4;
          float acc[4][4] = {};
          if (s0 <= t0 && t0 < L) mm_acc<4, 4>(acc, rdecT + t0, LD, kinvT + s0, LD, DH);
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b) {
              const int t = t0 + a, s = s0 + b;
              scT[s * LD + t] = (s < t && t < L) ? acc[a][b] : 0.f;
            }
        }
      }
      sm90::named_bar_arrive(BAR_FULL + (c & 1), NT);
    }
    if (a_seg != nullptr && blockIdx.x == 0 && seg == 0) a_seg[(size_t)bh * DH + i] = a_run;
  } else {
    // ---- carry: S_{c+1} = diag(w_tot) S_c + k_rem^T v; out = scores v +
    //      bonus v + r_dec S_c ---------------------------------------------
    const int ct = tid - PREP;
    const int nbj_sh = jsh - 2;                       // log2 of the 4-column tiles
    const int n_state = (DH / 4) << nbj_sh;
    const int n_out = (LP / 4) << nbj_sh;             // 4 x 4 tiles of (token, column)
    float* part = F(Y.part);
    float* cbonus = F(Y.cbonus);
    float* csc = F(Y.csc);                            // the summed score planes
    constexpr int NSP = score_planes(LP);
    constexpr int NW = PREP / 32;
    const int qs = LP << jsh;                         // one partial plane
    for (int c = 0; c < n; ++c) {
      const unsigned char* hs = slot(c);
      const float* rdecT = reinterpret_cast<const float*>(hs + Y.rdecT);
      const float* krem = reinterpret_cast<const float*>(hs + Y.krem);
      const float* vf = reinterpret_cast<const float*>(hs + Y.vf);
      const float* scT = reinterpret_cast<const float*>(hs + Y.scT);
      const float* bpart = reinterpret_cast<const float*>(hs + Y.bpart);
      const float* wtot = reinterpret_cast<const float*>(hs + Y.wtot);
      const float* Sc = S_tile(c);
      float* Sn = S_tile(c + 1);
      // Also orders the carry threads' writes of S_c (chunk c-1) and of the
      // partial sums before their reads here.
      sm90::named_bar_sync(BAR_FULL + (c & 1), NT);
      if (with_hist && ct == 0) {
        // s_hist[c] = the state entering chunk c, stored beside the chunk.
        sm90::tma_store_3d(&map_hist, Sc, j0, 0, bh * n + c);
        sm90::bulk_commit();
      }
      // The scores: prep's planes summed in order; the u-bonus of each
      // token: prep's warp partials, in order.
      for (int idx = ct; idx < LP * LP + LP; idx += CARRY) {
        if (idx < LP * LP) {
          const int s = idx / LP, t = idx % LP;
          float x = scT[s * LD + t];
#pragma unroll
          for (int p = 1; p < NSP; ++p) x += scT[(p * LP + s) * LD + t];
          csc[s * LD + t] = x;
        } else {
          const int t = idx - LP * LP;
          float x = 0.f;
#pragma unroll
          for (int w8 = 0; w8 < NW; ++w8) x += bpart[w8 * LP + t];
          cbonus[t] = x;
        }
      }
      for (int it = ct; it < n_state; it += CARRY) {
        const int i0 = (it >> nbj_sh) * 4, j = (it & ((1 << nbj_sh) - 1)) * 4;
        float acc[4][4] = {};
        mm_acc<4, 4>(acc, krem + i0, DH, vf + j, JT, LP);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float wt = wtot[i0 + a];
          const float4 s = *reinterpret_cast<const float4*>(Sc + (i0 + a) * JT + j);
          float4 o;
          o.x = fmaf(wt, s.x, acc[a][0]);
          o.y = fmaf(wt, s.y, acc[a][1]);
          o.z = fmaf(wt, s.z, acc[a][2]);
          o.w = fmaf(wt, s.w, acc[a][3]);
          *reinterpret_cast<float4*>(Sn + (i0 + a) * JT + j) = o;
        }
      }
      sm90::named_bar_sync(BAR_CARRY, CARRY);   // the summed scores are in
      // out's partial sums, 4 x 4 tiles: part q < 4 is r_dec @ S_c over
      // keys 16q..16q+15; part 4 is scores @ v (token t sees s < t, so a
      // tile of tokens t0.. sums over s < t0 + 4).
      for (int it = ct; it < 5 * n_out; it += CARRY) {
        const int q = it / n_out, tile = it % n_out;   // a warp reads one part's rows
        const int t0 = (tile >> nbj_sh) * 4, j = (tile & ((1 << nbj_sh) - 1)) * 4;
        float acc[4][4] = {};
        if (t0 < L) {
          if (q < 4)
            mm_acc<4, 4>(acc, rdecT + q * 16 * LD + t0, LD, Sc + q * 16 * JT + j, JT, 16);
          else
            mm_acc<4, 4>(acc, csc + t0, LD, vf + j, JT, t0 + 4);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
          *reinterpret_cast<float4*>(part + q * qs + ((t0 + a) << jsh) + j) =
              make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
      }
      if (with_hist) {
        sm90::fence_proxy_async();                  // S_{c+1} goes out by TMA next chunk
        if (ct == 0) sm90::bulk_wait_read<0>();     // S_c's store has read its tile
      }
      sm90::named_bar_sync(BAR_CARRY, CARRY);
      const size_t obase = out0 + (size_t)c * L * DH;
      for (int idx = ct; idx < (L << jsh); idx += CARRY) {
        const int t = idx >> jsh, j = idx & (JT - 1);
        const float x = ((part[idx] + part[qs + idx]) + part[2 * qs + idx]) + part[3 * qs + idx];
        const float y = fmaf(cbonus[t], vf[idx], part[4 * qs + idx]);
        store(&out[obase + (size_t)t * DH + j0 + j], y + x);
      }
      if (c + 2 < n) sm90::named_bar_arrive(BAR_EMPTY + (c & 1), NT);
    }
    sm90::named_bar_sync(BAR_CARRY, CARRY);
    const float* Sf = S_tile(n);
    for (int idx = ct; idx < DH * JT; idx += CARRY)
      s_out[st0 + (size_t)(idx >> jsh) * DH + j0 + (idx & (JT - 1))] = Sf[idx];
    if (with_hist && ct == 0) sm90::bulk_wait<0>();
  }
}

template <typename T>
constexpr CUtensorMapDataType map_type() {
  return sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

template <typename T, int LP>
int launch(const void* r, const void* k, const void* v, const void* w, const void* u,
           const void* h0, void* out, void* s_out, void* s_hist, void* a_seg, int B, int H,
           int T_len, int T_stride, int L, int JT, cudaStream_t stream) {
  constexpr int E = sizeof(T);
  const Layout Y = fit_layout(LP, JT, E);
  if (Y.total > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(wkv_fwd_kernel<T, LP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Y.total);
  if (err != cudaSuccess) return (int)err;
  const int BH = B * H, n = T_len / L;
  // r/k/w/v: (B*H, T_len, 64) read with the caller's T stride; boxes of L
  // tokens, whole rows for r/k/w, the block's JT columns for v.
  const uint64_t dims[3] = {(uint64_t)DH, (uint64_t)T_len, (uint64_t)BH};
  const uint64_t strides[2] = {(uint64_t)DH * E, (uint64_t)T_stride * DH * E};
  const uint32_t box_row[3] = {(uint32_t)DH, (uint32_t)L, 1};
  const uint32_t box_v[3] = {(uint32_t)JT, (uint32_t)L, 1};
  CUtensorMap mr, mk, mw, mv, mh;
  int e = sm90::encode_plain_map(&mr, map_type<T>(), 3, r, dims, strides, box_row);
  if (!e) e = sm90::encode_plain_map(&mk, map_type<T>(), 3, k, dims, strides, box_row);
  if (!e) e = sm90::encode_plain_map(&mw, map_type<T>(), 3, w, dims, strides, box_row);
  if (!e) e = sm90::encode_plain_map(&mv, map_type<T>(), 3, v, dims, strides, box_v);
  if (e) return e;
  memset(&mh, 0, sizeof(mh));
  if (s_hist != nullptr) {
    // s_hist: (B*H*n, 64, 64) f32; each block stores its 64 x JT tile.
    const uint64_t hd[3] = {(uint64_t)DH, (uint64_t)DH, (uint64_t)BH * n};
    const uint64_t hs[2] = {(uint64_t)DH * 4, (uint64_t)DH * DH * 4};
    const uint32_t hb[3] = {(uint32_t)JT, (uint32_t)DH, 1};
    e = sm90::encode_plain_map(&mh, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, s_hist, hd, hs, hb);
    if (e) return e;
  }
  dim3 grid(DH / JT, BH);
  wkv_fwd_kernel<T, LP><<<grid, NT, Y.total, stream>>>(
      mr, mk, mw, mv, mh, static_cast<const T*>(u), static_cast<const float*>(h0),
      static_cast<T*>(out), static_cast<float*>(s_out), static_cast<float*>(a_seg), H, T_len,
      L, JT, s_hist != nullptr ? 1 : 0);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_padded(const void* r, const void* k, const void* v, const void* w, const void* u,
                  const void* h0, void* out, void* s_out, void* s_hist, void* a_seg, int B,
                  int H, int T_len, int T_stride, int L, int JT, cudaStream_t s) {
  switch (padded(L)) {
    case 4: return launch<T, 4>(r, k, v, w, u, h0, out, s_out, s_hist, a_seg, B, H, T_len, T_stride, L, JT, s);
    case 8: return launch<T, 8>(r, k, v, w, u, h0, out, s_out, s_hist, a_seg, B, H, T_len, T_stride, L, JT, s);
    case 16: return launch<T, 16>(r, k, v, w, u, h0, out, s_out, s_hist, a_seg, B, H, T_len, T_stride, L, JT, s);
    case 32: return launch<T, 32>(r, k, v, w, u, h0, out, s_out, s_hist, a_seg, B, H, T_len, T_stride, L, JT, s);
    default: return launch<T, 64>(r, k, v, w, u, h0, out, s_out, s_hist, a_seg, B, H, T_len, T_stride, L, JT, s);
  }
}

int dispatch(const void* r, const void* k, const void* v, const void* w, const void* u,
             const void* h0, void* out, void* s_out, void* s_hist, void* a_seg, int B, int H,
             int T_len, int T_stride, int Dh, int chunk, int dtype, int JT, void* stream) {
  if (Dh != DH || chunk < 1 || chunk > MAX_CHUNK || T_len < 1 || T_len % chunk != 0 ||
      T_stride < T_len || B < 1 || H < 1 || !(JT == 64 || JT == 32 || JT == 16 || JT == 8))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_padded<float>(r, k, v, w, u, h0, out, s_out, s_hist, a_seg, B, H, T_len,
                                T_stride, chunk, JT, s);
  if (dtype == 1)
    return launch_padded<__nv_bfloat16>(r, k, v, w, u, h0, out, s_out, s_hist, a_seg, B, H,
                                        T_len, T_stride, chunk, JT, s);
  return (int)cudaErrorInvalidValue;
}

// Blocks an SM of the instantiation a plan launches (chunk, column tile,
// dtype), with its dynamic shared memory opted in as the launcher does; or
// minus a cudaError_t.
template <typename T, int LP>
int occupancy_lp(int JT) {
  const Layout Y = fit_layout(LP, JT, sizeof(T));
  if (Y.total > SMEM_LIMIT) return -(int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(wkv_fwd_kernel<T, LP>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Y.total);
  int n = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, wkv_fwd_kernel<T, LP>, NT, (int)Y.total);
  return e == cudaSuccess ? n : -(int)e;
}

template <typename T>
int occupancy(int chunk, int JT) {
  switch (padded(chunk)) {
    case 4: return occupancy_lp<T, 4>(JT);
    case 8: return occupancy_lp<T, 8>(JT);
    case 16: return occupancy_lp<T, 16>(JT);
    case 32: return occupancy_lp<T, 32>(JT);
    default: return occupancy_lp<T, 64>(JT);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (r, k, v, w, u, out); h0 and s_out float32.
// col_tile: the value columns of one block (64, 32, 16 or 8), the wrapper's
// plan.  Returns 0, a cudaError_t, or 10000 + the CUresult of a tensor map.
extern "C" int wkv_chunked_fwd(const void* r, const void* k, const void* v, const void* w,
                               const void* u, const void* h0, void* out, void* s_out, int B,
                               int H, int T_len, int Dh, int chunk, int dtype, int col_tile,
                               void* stream) {
  return dispatch(r, k, v, w, u, h0, out, s_out, nullptr, nullptr, B, H, T_len, T_len, Dh,
                  chunk, dtype, col_tile, stream);
}

// The training forward: as wkv_chunked_fwd, and s_hist (B, H, T/chunk, 64,
// 64) float32 receives the state entering each chunk.
extern "C" int wkv_chunked_train_fwd(const void* r, const void* k, const void* v,
                                     const void* w, const void* u, const void* h0, void* out,
                                     void* s_out, void* s_hist, int B, int H, int T_len,
                                     int Dh, int chunk, int dtype, int col_tile,
                                     void* stream) {
  return dispatch(r, k, v, w, u, h0, out, s_out, s_hist, nullptr, B, H, T_len, T_len, Dh,
                  chunk, dtype, col_tile, stream);
}

// The segment-summary forward: as wkv_chunked_fwd, and a_seg (B, H, 64)
// float32 receives the product of the segment's clipped decays.  r/k/v/w
// may be a T-window of longer tensors: T_stride (>= T_len) tokens lie
// between consecutive (b, h) rows; out is contiguous (B, H, T_len, 64).
extern "C" int wkv_chunked_summary_fwd(const void* r, const void* k, const void* v,
                                       const void* w, const void* u, const void* h0,
                                       void* out, void* s_out, void* a_seg, int B, int H,
                                       int T_len, int T_stride, int Dh, int chunk, int dtype,
                                       int col_tile, void* stream) {
  return dispatch(r, k, v, w, u, h0, out, s_out, nullptr, a_seg, B, H, T_len, T_stride, Dh,
                  chunk, dtype, col_tile, stream);
}

// The training forward with the segment summary: s_hist and a_seg written
// in one sweep (wkv_chunked_train_fwd plus a_seg, with T_stride as above).
extern "C" int wkv_chunked_train_summary_fwd(const void* r, const void* k, const void* v,
                                             const void* w, const void* u, const void* h0,
                                             void* out, void* s_out, void* s_hist,
                                             void* a_seg, int B, int H, int T_len,
                                             int T_stride, int Dh, int chunk, int dtype,
                                             int col_tile, void* stream) {
  return dispatch(r, k, v, w, u, h0, out, s_out, s_hist, a_seg, B, H, T_len, T_stride, Dh,
                  chunk, dtype, col_tile, stream);
}

// The shared memory (bytes) one block takes at this chunk, column tile and
// dtype, or 0 past the card's limit: the wrapper's plan reads it.
extern "C" int wkv_chunked_smem(int chunk, int col_tile, int dtype) {
  const size_t total = fit_layout(padded(chunk), col_tile, dtype == 0 ? 4 : 2).total;
  return total > SMEM_LIMIT ? 0 : (int)total;
}

// The library's launch query (kernel 0, the chunked forward, every entry
// point's; p0 the chunk, p1 the column tile, p2 the dtype): blocks an SM
// from cudaOccupancyMaxActiveBlocksPerMultiprocessor, or minus a
// cudaError_t.
extern "C" int wkv_chunked_occupancy(int kernel, int p0, int p1, int p2, int p3, int p4) {
  (void)p3, (void)p4;
  if (kernel != 0 || p0 < 1 || p0 > MAX_CHUNK) return -(int)cudaErrorInvalidValue;
  if (p2 == 0) return occupancy<float>(p0, p1);
  if (p2 == 1) return occupancy<__nv_bfloat16>(p0, p1);
  return -(int)cudaErrorInvalidValue;
}
