// Chunked RWKV6 WKV backward for Hopper (sm_90a), plain C interface.
//
// Replaces: src/repro/kernels/wkv/bwd.py:wkv_pallas_bwd (body
// wkv_bwd_kernel), the reverse chunk sweep behind the training VJP.
//
// Per chunk of L tokens (entering state S = s_hist[c], exit-state adjoint
// G carried in dS), with the decay-ratio tensors of the forward recomputed
// from the primals in f32 (logw = log(clip(w, 1e-8, 1)), cum_incl,
// cum_excl, r_dec, k_inv, k_rem, the strictly lower scores):
//
//   dscores = mask(do V^T)
//   d_rdec  = dscores k_inv + do S^T          dr = d_rdec e^{excl} + u k (do.v)
//   d_kinv  = dscores^T r_dec                 d_krem = V G^T
//   dk      = d_kinv e^{-incl} + d_krem e^{last-incl} + r u (do.v)
//   dv      = scores^T do + k_rem G + (r.u.k) do
//   dlogw   = suffix sums of the cum_incl / cum_excl adjoints, with the
//             cum_incl[-1] consumers (k_rem, the exit decay) on the last row
//   dw      = dlogw / w where w was not clipped, else 0
//   G_prev  = diag(w_total) G + r_dec^T do     (the carried adjoint)
//
// The seed is d_s_out at the last chunk; dh0 is G after chunk 0; du_part is
// the per-(batch, head) sum of r k (do.v) over the chunks (the caller sums
// it over batch).
//
// What bounds it.  The card: device-memory bytes at the main path's
// shapes.  r/k/v/w/do and the four grads cross HBM once each, s_hist
// (B*H*(T/L)*16 KiB) once, d_s_out and dh0 once: about 75 MB at B=4, H=32,
// T=256, L=16 in bf16, 22.5 us at 3.35 TB/s, while the f32 arithmetic is
// about 1.3 GFLOP (20 us at 67 TFLOP/s).  This kernel: the latency of one
// chunk's chain of phases on 8 warps, the reverse sweep's chunks one after
// another.  The old kernel (one block of a (batch, head), 24 us a chunk)
// loaded the 64 x 64 s_hist tile in 16 synchronous rounds, ran the row
// grads as chains of ~200 dependent FMAs per thread and the suffix sums
// serially.  Probes of this design found, besides, row sums whose lanes
// read one column of a row-major tile (16- to 32-way bank conflicts) and
// products split by lane rather than by warp; both are gone below.
//
// Design.  A cluster of C thread blocks (1, 2 or 4, from the wrapper's
// plan, bwd.py:plan_cluster) runs the reverse sweep of one (batch, head);
// block q of the cluster owns value columns [64q/C, 64(q+1)/C) of S, G, v,
// do and dv, and key columns of the same range for dr, dk, dw and du.  G
// never leaves shared memory between chunks.  Per chunk:
//
// 1. The chunk's r, k, w (whole rows), v and do (the block's columns) and
//    its 64 x 64/C slice of s_hist[c] arrived by TMA while the previous
//    chunk ran: thread 0 issues chunk c-1 into the other stage of a
//    two-stage ring at the top of chunk c.  The decay factors (a
//    branch-free segmented scan: four segments of tokens per key column,
//    their totals exchanged by warp shuffles; r.u.k as a shuffle tree over
//    the warp's keys), and k-major copies of the tiles.
// 2. Every product as 4 x 4 (scores: 2 x 2) outer-product micro-tiles per
//    thread: the scores; the partial sums over the block's value columns of
//    dscores = do V^T, do S^T, V G^T, do.v and the S.G row sums, each into
//    the block's own exchange buffer (two, alternating by chunk).
// 3. A cluster barrier: arrive; then dv = scores^T do + k_rem G + (r.u.k) do
//    (its keys in four quarters, partial planes summed after the barrier)
//    and G_prev = diag(w_total) G + r_dec^T do into registers, which need
//    only the block's columns; wait.  Each block then reads the partials of
//    its key columns from every block of the cluster through distributed
//    shared memory (mapa / ld.shared::cluster, float4 rows, all issued
//    before the sums), summed in rank order, so the grads repeat bit for
//    bit: no atomics anywhere.  d_rdec = dscores k_inv + do S^T and d_kinv =
//    dscores^T r_dec as 4 x 4 tile products of the block's key columns.
// 4. dr, dk, dw and du of the block's key columns, each (token, column)
//    once in the cluster, branch-free over the tokens; dlogw's suffix sums
//    as a segmented scan (log-step shuffles over the segments).
//
// C = 1 keeps everything in one block (no exchange).  Every block of a
// cluster repeats the decay scan and the scores of its (batch, head), so
// the plan takes a cluster only where one block per (batch, head) leaves
// more than half the SMs idle: the sequence-parallel gradient's B=1 shard
// (32 heads, 64 blocks at C = 2).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sm90.cuh"

namespace {

constexpr int DH = 64;         // key/value width of one WKV head
constexpr int NT = 256;        // threads per block
constexpr int NS = 2;          // ring stages
constexpr int MAX_CHUNK = 32;
constexpr int LDT = DH + 4;    // row stride of the [value column][key] tiles
constexpr size_t SMEM_LIMIT = 232448;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ float logw(float w) { return logf(fminf(fmaxf(w, 1e-8f), 1.0f)); }

__host__ __device__ constexpr size_t up128(size_t x) { return (x + 127) / 128 * 128; }

constexpr int padded(int L) { return L <= 4 ? 4 : L <= 8 ? 8 : L <= 16 ? 16 : 32; }

// Byte offsets of the shared-memory regions, the same on host and device.
// Tiles named ...T are k-major copies ([key column][token] with row stride
// LP + 4, or [value column][key] with row stride 68).
struct Layout {
  size_t bars, u, ring, stage, r, k, w, v, d, S;
  size_t incl, rdec, kinv, rdecT, kinvT, kremT, dof, doT, vT, ST, G, GT, sc;
  size_t xch, xch_size, PX, PY, Pdsc, Pdov, PZ;
  size_t dscS, dscT, dovS, ZS, rku, wtot, lastv, rkup, dvp, D1, D2, Ys, total;
};

// Reserves `bytes` (128-byte aligned) at offset o; returns where they start.
__host__ __device__ inline size_t take(size_t& o, size_t bytes) {
  const size_t at = o;
  o += up128(bytes);
  return at;
}

__host__ __device__ inline Layout layout(int LP, int C, int E) {
  Layout y{};
  const size_t LD = LP + 4, NJ = DH / C;
  y.bars = 0;
  y.u = 128;
  y.ring = up128(y.u + DH * 4);
  y.r = 0;
  y.k = up128((size_t)LP * DH * E);
  y.w = 2 * y.k;
  y.v = 3 * y.k;
  y.d = y.v + up128((size_t)LP * NJ * E);
  y.S = y.d + up128((size_t)LP * NJ * E);
  y.stage = y.S + up128((size_t)DH * NJ * 4);
  size_t o = y.ring + NS * y.stage;
  y.incl = take(o, (size_t)LP * DH * 4);
  y.rdec = take(o, (size_t)LP * DH * 4);
  y.kinv = take(o, (size_t)LP * DH * 4);
  y.rdecT = take(o, DH * LD * 4);
  y.kinvT = take(o, DH * LD * 4);
  y.kremT = take(o, DH * LD * 4);
  y.dof = take(o, (size_t)LP * NJ * 4);
  y.doT = take(o, NJ * LD * 4);
  y.vT = take(o, NJ * LD * 4);
  y.ST = take(o, NJ * LDT * 4);
  y.G = take(o, DH * NJ * 4);
  y.GT = take(o, NJ * LDT * 4);
  y.sc = take(o, (size_t)LP * LD * 4);
  y.PX = 0;
  y.PY = up128((size_t)LP * DH * 4);
  y.Pdsc = 2 * y.PY;
  y.Pdov = y.Pdsc + up128((size_t)LP * LD * 4);
  y.PZ = y.Pdov + up128((size_t)LP * 4);
  y.xch_size = y.PZ + up128(DH * 4);
  y.xch = o;
  o += 2 * y.xch_size;
  y.dscS = take(o, (size_t)LP * LD * 4);
  y.dscT = take(o, (size_t)LP * LD * 4);
  y.dovS = take(o, (size_t)LP * 4);
  y.ZS = take(o, DH * 4);
  y.rku = take(o, (size_t)LP * 4);
  y.wtot = take(o, DH * 4);
  y.lastv = take(o, DH * 4);
  y.rkup = take(o, (size_t)(NT / 32) * LP * 4);
  y.dvp = take(o, (size_t)4 * LP * NJ * 4);
  y.D1 = take(o, (size_t)LP * NJ * 4);
  y.D2 = take(o, (size_t)LP * NJ * 4);
  y.Ys = take(o, (size_t)LP * NJ * 4);
  y.total = o;
  return y;
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

// acc[a][b] += sum_{k < K} At[k * lda + a] * B[k * ldb + b] (operands stored
// k-major, each element summed over k in order).
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

template <int TM, int TN>
__device__ __forceinline__ void zero(float (&acc)[TM][TN]) {
#pragma unroll
  for (int x = 0; x < TM; ++x)
#pragma unroll
    for (int y = 0; y < TN; ++y) acc[x][y] = 0.f;
}

template <typename T, int LP>
__global__ void __launch_bounds__(NT, 1) wkv_bwd_kernel(
    const __grid_constant__ CUtensorMap map_r, const __grid_constant__ CUtensorMap map_k,
    const __grid_constant__ CUtensorMap map_w, const __grid_constant__ CUtensorMap map_v,
    const __grid_constant__ CUtensorMap map_do, const __grid_constant__ CUtensorMap map_hist,
    const T* __restrict__ u, const float* __restrict__ d_s_out, T* __restrict__ dr,
    T* __restrict__ dk, T* __restrict__ dv, T* __restrict__ dw, float* __restrict__ du_part,
    float* __restrict__ dh0, int H, int T_len, int L, int C) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int E = sizeof(T);
  constexpr int LD = LP + 4;
  constexpr int TS = LP <= 16 ? 2 : 4;          // score micro-tile
  constexpr int SEGMAX = LP >= 4 ? LP / 4 : 1;  // tokens of a segment, at most
  const Layout Y = layout(LP, C, E);
  auto F = [&](size_t off) { return reinterpret_cast<float*>(smem + off); };
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Y.bars);
  float *s_u = F(Y.u), *incl = F(Y.incl), *rdec = F(Y.rdec), *kinv = F(Y.kinv);
  float *rdecT = F(Y.rdecT), *kinvT = F(Y.kinvT), *kremT = F(Y.kremT);
  float *dof = F(Y.dof), *doT = F(Y.doT), *vT = F(Y.vT), *ST = F(Y.ST);
  float *G = F(Y.G), *GT = F(Y.GT), *sc = F(Y.sc);
  float *dscS = F(Y.dscS), *dscT = F(Y.dscT), *dovS = F(Y.dovS), *ZS = F(Y.ZS), *rku = F(Y.rku);
  float *D1 = F(Y.D1), *D2 = F(Y.D2), *Ys = F(Y.Ys), *rkup = F(Y.rkup), *dvp = F(Y.dvp);
  float *wtot = F(Y.wtot), *lastv = F(Y.lastv);

  const int tid = threadIdx.x;
  const int NJ = DH / C;
  const int njsh = 31 - __clz(NJ);     // NJ = 1 << njsh
  const int q = (int)sm90::cluster_ctarank();
  const int jq = q * NJ;               // first value (and key) column of this block
  const int bh = blockIdx.y;           // b * H + h
  const int h = bh % H;
  const int n = T_len / L;
  const size_t seq0 = (size_t)bh * T_len * DH;   // row (b, h) of d_out and the grads
  const size_t st0 = (size_t)bh * DH * DH;
  auto stage = [&](int m) { return smem + Y.ring + (size_t)(m % NS) * Y.stage; };
  auto issue = [&](int m) {            // the m-th chunk of the sweep, c = n-1-m
    const int c = n - 1 - m;
    unsigned char* st = stage(m);
    uint64_t* bar = &full[m % NS];
    sm90::mbar_arrive_expect_tx(bar, (uint32_t)((3 * DH + 2 * NJ) * L * E + DH * NJ * 4));
    sm90::tma_load_3d(st + Y.r, &map_r, bar, 0, c * L, bh);
    sm90::tma_load_3d(st + Y.k, &map_k, bar, 0, c * L, bh);
    sm90::tma_load_3d(st + Y.w, &map_w, bar, 0, c * L, bh);
    sm90::tma_load_3d(st + Y.v, &map_v, bar, jq, c * L, bh);
    sm90::tma_load_3d(st + Y.d, &map_do, bar, jq, c * L, bh);
    sm90::tma_load_3d(st + Y.S, &map_hist, bar, jq, 0, bh * n + c);
  };

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) sm90::mbar_init(&full[s], 1);
    sm90::mbar_fence_init();
  }
  if (tid < DH) s_u[tid] = to_f(u[h * DH + tid]);
  // Reverse boundary: the last chunk's exit adjoint is d_s_out.
  for (int idx = tid; idx < DH * NJ; idx += NT) {
    const int i = idx / NJ, j = idx % NJ;
    const float g = d_s_out[st0 + (size_t)i * DH + jq + j];
    G[idx] = g;
    GT[j * LDT + i] = g;
  }
  __syncthreads();
  if (tid == 0) issue(0);

  // G_prev of this thread's 4 x 4 tile of (key, value column), carried in
  // registers from step 3 of one chunk to step 1 of the next.
  const int ngt = NJ / 4, n_g = (DH / 4) * ngt;
  const int gi0 = (tid / ngt) * 4, gj = (tid % ngt) * 4;
  float gn[4][4];
  zero(gn);
  float du_acc = 0.f;
  // Step 4's layout: key column i of the block, one segment of tokens.
  const int nseg = NT / NJ;            // 4C
  const int il = tid / nseg, seg = tid % nseg, i4 = jq + il;
  const int seg_len = LP / nseg > 0 ? LP / nseg : 1;
  const int gbase = (tid & 31) & ~(nseg - 1);
  uint32_t peer[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) peer[p] = p < C ? sm90::mapa(sm90::smem_u32(smem + Y.xch), p) : 0;

  for (int m = 0; m < n; ++m) {
    const int c = n - 1 - m, buf = m & 1;
    if (tid == 0 && m + 1 < n) issue(m + 1);   // chunk c-1 loads while chunk c runs
    const unsigned char* st = stage(m);
    const T* rr = reinterpret_cast<const T*>(st + Y.r);
    const T* kk = reinterpret_cast<const T*>(st + Y.k);
    const T* ww = reinterpret_cast<const T*>(st + Y.w);
    const T* vv = reinterpret_cast<const T*>(st + Y.v);
    const T* dd = reinterpret_cast<const T*>(st + Y.d);
    const float* Sr = reinterpret_cast<const float*>(st + Y.S);
    unsigned char* xb = smem + Y.xch + (size_t)buf * Y.xch_size;
    float *PX = reinterpret_cast<float*>(xb + Y.PX), *PY = reinterpret_cast<float*>(xb + Y.PY);
    float *Pdsc = reinterpret_cast<float*>(xb + Y.Pdsc);
    float *Pdov = reinterpret_cast<float*>(xb + Y.Pdov), *PZ = reinterpret_cast<float*>(xb + Y.PZ);
    const size_t base = seq0 + (size_t)c * L * DH;

    // ---- 1. the carried adjoint, the decay factors, k-major tiles --------
    if (m > 0 && tid < n_g) {
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        *reinterpret_cast<float4*>(G + (gi0 + a) * NJ + gj) =
            make_float4(gn[a][0], gn[a][1], gn[a][2], gn[a][3]);
      }
#pragma unroll
      for (int b = 0; b < 4; ++b)
        *reinterpret_cast<float4*>(GT + (gj + b) * LDT + gi0) =
            make_float4(gn[0][b], gn[1][b], gn[2][b], gn[3][b]);
    }
    sm90::mbar_wait(&full[m % NS], (m / NS) & 1);
    {
      constexpr int NSEG = NT / DH, SEG = LP / NSEG;
      const int i = tid / NSEG, sg = tid % NSEG;
      const int last_seg = min((L - 1) / SEG, NSEG - 1);
      const int lb = (tid & 31) & ~(NSEG - 1);
      float lw[SEG], rv[SEG], kv[SEG];
      float tot = 0.f;
#pragma unroll
      for (int a = 0; a < SEG; ++a) {
        const int t = sg * SEG + a;
        const bool ok = t < L;     // rows past L are read and dropped: no branches
        const float x = logw(to_f(ww[t * DH + i]));
        lw[a] = ok ? x : 0.f;
        rv[a] = to_f(rr[t * DH + i]);
        kv[a] = to_f(kk[t * DH + i]);
        tot += lw[a];
      }
      float off = 0.f;
#pragma unroll
      for (int g = 0; g < NSEG; ++g) {
        const float x = __shfl_sync(0xffffffffu, tot, lb + g);
        off += g < sg ? x : 0.f;
      }
      float run = off;
#pragma unroll
      for (int a = 0; a < SEG; ++a) run += lw[a];
      const float last = __shfl_sync(0xffffffffu, run, lb + last_seg);
      run = off;
#pragma unroll
      for (int a = 0; a < SEG; ++a) {
        const int t = sg * SEG + a;
        const bool ok = t < L;
        run += lw[a];
        const float rd = ok ? rv[a] * expf(run - lw[a]) : 0.f;
        const float ki = ok ? kv[a] * expf(-run) : 0.f;
        const float kr = ok ? kv[a] * expf(last - run) : 0.f;
        // r.u.k of token t: this key's term, summed over the warp's keys
        // (lanes of one segment) in a fixed tree.
        float bp = ok ? rv[a] * s_u[i] * kv[a] : 0.f;
#pragma unroll
        for (int msk = NSEG; msk < 32; msk <<= 1) bp += __shfl_xor_sync(0xffffffffu, bp, msk);
        if ((tid & 31) < NSEG) rkup[(tid >> 5) * LP + t] = bp;
        incl[t * DH + i] = run;
        rdec[t * DH + i] = rd;
        kinv[t * DH + i] = ki;
        rdecT[i * LD + t] = rd;
        kinvT[i * LD + t] = ki;
        kremT[i * LD + t] = kr;
      }
      if (sg == 0) {
        lastv[i] = last;
        wtot[i] = expf(last);
      }
    }
    for (int idx = tid; idx < LP * NJ; idx += NT) {
      const int t = idx >> njsh, j = idx & (NJ - 1);
      const bool ok = t < L;
      const float dx = to_f(dd[idx]), vx = to_f(vv[idx]);
      const float dov = ok ? dx : 0.f, vvv = ok ? vx : 0.f;
      dof[idx] = dov;
      doT[j * LD + t] = dov;
      vT[j * LD + t] = vvv;
    }
    for (int idx = tid; idx < DH * NJ; idx += NT) ST[(idx & (NJ - 1)) * LDT + (idx >> njsh)] = Sr[idx];
    __syncthreads();

    // ---- 2. products; the partial sums over this block's value columns --
    {
      const int nx = (LP / 4) * (DH / 4);         // 4 x 4 tiles of (token, key)
      const int nsc = (LP / TS) * (LP / TS);
      const int total = 2 * nx + 2 * nsc + DH + 2 * LP;
      for (int it = tid; it < total; it += NT) {
        if (it < 2 * nx) {
          // X = do S^T and Y = V G^T over this block's columns.
          const bool is_x = it < nx;
          const int e = is_x ? it : it - nx;
          const int t0 = (e / (DH / 4)) * 4, i0 = (e % (DH / 4)) * 4;
          float acc[4][4];
          zero(acc);
          // Separate calls, no pointer select: the operands stay shared loads.
          if (t0 < L) {
            if (is_x)
              mm_acc<4, 4>(acc, doT + t0, LD, ST + i0, LDT, NJ);
            else
              mm_acc<4, 4>(acc, vT + t0, LD, GT + i0, LDT, NJ);
          }
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const float4 o = make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
            if (is_x)
              *reinterpret_cast<float4*>(PX + (t0 + a) * DH + i0) = o;
            else
              *reinterpret_cast<float4*>(PY + (t0 + a) * DH + i0) = o;
          }
        } else if (it < 2 * nx + 2 * nsc) {
          // scores = r_dec k_inv^T (whole rows) and dscores = do V^T (partial);
          // tiles wholly on or above the diagonal, or past L, are zeros.
          const bool is_sc = it < 2 * nx + nsc;
          const int e = it - 2 * nx - (is_sc ? 0 : nsc);
          const int t0 = (e / (LP / TS)) * TS, s0 = (e % (LP / TS)) * TS;
          float acc[TS][TS];
          zero(acc);
          if (s0 <= t0 && t0 < L) {
            if (is_sc)
              mm_acc<TS, TS>(acc, rdecT + t0, LD, kinvT + s0, LD, DH);
            else
              mm_acc<TS, TS>(acc, doT + t0, LD, vT + s0, LD, NJ);
          }
#pragma unroll
          for (int a = 0; a < TS; ++a)
#pragma unroll
            for (int b = 0; b < TS; ++b) {
              const int t = t0 + a, s = s0 + b;
              const float x = (s < t && t < L) ? acc[a][b] : 0.f;
              if (is_sc)
                sc[t * LD + s] = x;
              else
                Pdsc[t * LD + s] = x;
            }
        } else if (it < 2 * nx + 2 * nsc + DH) {
          // The S.G row sum of key row i (partial), from the k-major copies:
          // neighbouring lanes read neighbouring keys.
          const int i = it - 2 * nx - 2 * nsc;
          float acc = 0.f;
          for (int j = 0; j < NJ; ++j) acc = fmaf(ST[j * LDT + i], GT[j * LDT + i], acc);
          PZ[i] = acc;
        } else if (it < 2 * nx + 2 * nsc + DH + LP) {
          // do.v of token t (partial).
          const int t = it - 2 * nx - 2 * nsc - DH;
          float acc = 0.f;
          for (int j = 0; j < NJ; ++j) acc = fmaf(doT[j * LD + t], vT[j * LD + t], acc);
          Pdov[t] = acc;
        } else {
          // The u-bonus weight r.u.k of token t: the scan's eight warp
          // partials, in order.
          const int t = it - 2 * nx - 2 * nsc - DH - LP;
          float acc = 0.f;
#pragma unroll
          for (int w8 = 0; w8 < NT / 32; ++w8) acc += rkup[w8 * LP + t];
          rku[t] = acc;
        }
      }
    }
    __syncthreads();
    sm90::cluster_arrive();

    // ---- 3. the block's own columns while the cluster meets ---------------
    {
      // G_prev = diag(w_total) G + r_dec^T do, kept in registers.
      if (tid < n_g) {
        float acc[4][4];
        zero(acc);
        mm_acc<4, 4>(acc, rdec + gi0, DH, dof + gj, NJ, LP);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b)
            gn[a][b] = fmaf(wtot[gi0 + a], G[(gi0 + a) * NJ + gj + b], acc[a][b]);
      }
      // dv = scores^T do + k_rem G + (r.u.k) do, 4 x 4 tiles of (token,
      // column), k_rem G over four quarters of the keys; scores[s][t] is 0
      // unless s > t, so the first quarter's item adds scores^T do over
      // s >= t0.  The partials are summed after the cluster barrier.
      const int nbo = NJ / 4, n_dv = (LP / 4) * nbo;
      for (int it = (tid + NT - n_g) % NT; it < 4 * n_dv; it += NT) {
        const int kq = it / n_dv, e = it % n_dv;
        const int t0 = (e / nbo) * 4, j = (e % nbo) * 4;
        float acc[4][4];
        zero(acc);
        if (t0 < L) {
          if (kq == 0) mm_acc<4, 4>(acc, sc + t0 * LD + t0, LD, dof + t0 * NJ + j, NJ, LP - t0);
          mm_acc<4, 4>(acc, kremT + kq * 16 * LD + t0, LD, G + kq * 16 * NJ + j, NJ, 16);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
          *reinterpret_cast<float4*>(dvp + kq * LP * NJ + (t0 + a) * NJ + j) =
              make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
      }
    }
    sm90::cluster_wait();
    __syncthreads();   // dv's partials were written after the cluster arrive
    // The cluster's sums, in rank order: dscores and do.v whole, S.G of the
    // block's key rows.
    for (int idx = tid; idx < L * NJ; idx += NT) {
      // dv of the block's columns: the four key quarters' partials in order.
      const int t = idx >> njsh, j = idx & (NJ - 1);
      const float* p = dvp + idx;
      const float x = ((p[0] + p[LP * NJ]) + p[2 * LP * NJ]) + p[3 * LP * NJ];
      store(&dv[base + (size_t)t * DH + jq + j], fmaf(rku[t], dof[idx], x));
    }
    for (int idx = tid; idx < LP * LP + LP + NJ; idx += NT) {
      uint32_t off;
      if (idx < LP * LP)
        off = (uint32_t)(Y.Pdsc + ((idx / LP) * LD + idx % LP) * 4);
      else if (idx < LP * LP + LP)
        off = (uint32_t)(Y.Pdov + (idx - LP * LP) * 4);
      else
        off = (uint32_t)(Y.PZ + (jq + idx - LP * LP - LP) * 4);
      off += (uint32_t)(buf * Y.xch_size);
      float acc = 0.f;
#pragma unroll
      for (int p = 0; p < 4; ++p)
        if (p < C) acc += sm90::ld_cluster_f32(peer[p] + off);
      if (idx < LP * LP) {
        const int t = idx / LP, s = idx % LP;
        dscS[t * LD + s] = acc;
        dscT[s * LD + t] = acc;
      } else if (idx < LP * LP + LP) {
        dovS[idx - LP * LP] = acc;
      } else {
        ZS[jq + idx - LP * LP - LP] = acc;
      }
    }
    __syncthreads();

    // d_rdec = dscores k_inv + do S^T and d_kinv = dscores^T r_dec for this
    // block's key columns as 4 x 4 tiles of (token, key), with V G^T read
    // from the cluster beside them.
    {
      const uint32_t xoff = (uint32_t)(buf * Y.xch_size);
      const int nbi = NJ / 4, n_d = (LP / 4) * nbi;
      for (int it = tid; it < 2 * n_d; it += NT) {
        const bool first = it < n_d;
        const int e = first ? it : it - n_d;
        const int t0 = (e / nbi) * 4, il0 = (e % nbi) * 4;
        float acc[4][4];
        zero(acc);
        if (first)
          mm_acc<4, 4>(acc, dscT + t0, LD, kinv + jq + il0, DH, LP);
        else
          mm_acc<4, 4>(acc, dscS + t0, LD, rdec + jq + il0, DH, LP);
        // The cluster's X (first) or Y rows of this tile, float4 per row and
        // block, all loads issued before the sums (in rank order).
        float4 x4[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const uint32_t o = xoff + (uint32_t)((first ? Y.PX : Y.PY) +
                                               ((t0 + a) * DH + jq + il0) * 4);
#pragma unroll
          for (int p = 0; p < 4; ++p)
            x4[a][p] = p < C ? sm90::ld_cluster_f32x4(peer[p] + o) : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int p = 0; p < 4; ++p)
            if (p < C) {
              x.x += x4[a][p].x;
              x.y += x4[a][p].y;
              x.z += x4[a][p].z;
              x.w += x4[a][p].w;
            }
          const int at = (t0 + a) * NJ + il0;
          if (first) {
            *reinterpret_cast<float4*>(D1 + at) =
                make_float4(acc[a][0] + x.x, acc[a][1] + x.y, acc[a][2] + x.z, acc[a][3] + x.w);
          } else {
            *reinterpret_cast<float4*>(D2 + at) = make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
            *reinterpret_cast<float4*>(Ys + at) = x;
          }
        }
      }
    }
    __syncthreads();

    // ---- 4. dr, dk, dw, du of this block's key columns --------------------
    {
      float dinc[SEGMAX], dexc[SEGMAX];
      float kr_sum = 0.f, du_sum = 0.f;
      const float u_i = s_u[i4], lst = lastv[i4];
#pragma unroll
      for (int a = 0; a < SEGMAX; ++a) {
        const int t = seg * seg_len + a;
        const bool ok = a < seg_len && t < L;
        const int tl = min(t, LP - 1);   // rows past L are read and dropped
        const float inc = incl[tl * DH + i4];
        const float exc = inc - logw(to_f(ww[tl * DH + i4]));
        const float rv = to_f(rr[tl * DH + i4]), kv = to_f(kk[tl * DH + i4]);
        const float bonus = u_i * dovS[tl];
        const float d_rdec = D1[tl * NJ + il];
        const float d_kinv = D2[tl * NJ + il];
        const float yk = Ys[tl * NJ + il];
        const float e_rem = expf(lst - inc);
        const float drv = d_rdec * expf(exc) + bonus * kv;
        const float dkv = d_kinv * expf(-inc) + yk * e_rem + bonus * rv;
        if (ok) {
          store(&dr[base + (size_t)t * DH + i4], drv);
          store(&dk[base + (size_t)t * DH + i4], dkv);
        }
        const float krdk = yk * (kv * e_rem);
        dexc[a] = ok ? d_rdec * rdec[tl * DH + i4] : 0.f;
        dinc[a] = ok ? -d_kinv * kinv[tl * DH + i4] - krdk : 0.f;
        kr_sum += ok ? krdk : 0.f;
        du_sum += ok ? rv * kv * dovS[tl] : 0.f;
      }
      // The column's sums over all its tokens (a butterfly over the
      // segments' lanes), and each segment's suffix offset (a log-step scan
      // from the last segment down): fixed trees, so the sums repeat.
      float seg_tot = 0.f;
#pragma unroll
      for (int a = 0; a < SEGMAX; ++a) seg_tot += dinc[a] + dexc[a];
      float kr_tot = kr_sum, du_tot = du_sum;
      for (int msk = 1; msk < nseg; msk <<= 1) {
        kr_tot += __shfl_xor_sync(0xffffffffu, kr_tot, msk);
        du_tot += __shfl_xor_sync(0xffffffffu, du_tot, msk);
      }
      float incl_suffix = seg_tot;   // sum over segments seg.. of the group
      for (int d = 1; d < nseg; d <<= 1) {
        const float x = __shfl_down_sync(0xffffffffu, incl_suffix, d);
        if (seg + d < nseg) incl_suffix += x;
      }
      // The segments after this one: the next segment's inclusive suffix.
      const float nxt = __shfl_down_sync(0xffffffffu, incl_suffix, 1);
      const float suffix = seg + 1 < nseg ? nxt : 0.f;
      // dlogw[t] = last + sum_{s>=t} d cum_incl[s] + sum_{s>t} d cum_excl[s].
      float acc = kr_tot + wtot[i4] * ZS[i4] + suffix;
#pragma unroll
      for (int a = SEGMAX - 1; a >= 0; --a) {
        const int t = seg * seg_len + a;
        const int tl = min(t, LP - 1);
        acc += dinc[a];
        const float wt = to_f(ww[tl * DH + i4]);
        const bool in_range = wt >= 1e-8f && wt <= 1.0f;
        const float dwv = in_range ? acc / fminf(fmaxf(wt, 1e-8f), 1.0f) : 0.f;
        if (a < seg_len && t < L) store(&dw[base + (size_t)t * DH + i4], dwv);
        acc += dexc[a];
      }
      if (seg == 0) du_acc += du_tot;
    }
    __syncthreads();
  }

  if (tid < n_g)
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) dh0[st0 + (size_t)(gi0 + a) * DH + jq + gj + b] = gn[a][b];
  if (seg == 0) du_part[(size_t)bh * DH + i4] = du_acc;
  // No block leaves while a peer may still read its exchange buffers.
  sm90::cluster_arrive();
  sm90::cluster_wait();
}

template <typename T>
constexpr CUtensorMapDataType map_type() {
  return sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

template <typename T, int LP>
int launch(const void* r, const void* k, const void* v, const void* w, const void* u,
           const void* s_hist, const void* d_out, const void* d_s_out, void* dr, void* dk,
           void* dv, void* dw, void* du_part, void* dh0, int B, int H, int T_len, int T_stride,
           int L, int C, cudaStream_t stream) {
  constexpr int E = sizeof(T);
  const Layout Y = layout(LP, C, E);
  if (Y.total > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(wkv_bwd_kernel<T, LP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Y.total);
  if (err != cudaSuccess) return (int)err;
  const int BH = B * H, n = T_len / L, NJ = DH / C;
  // r/k/v/w: (B*H, T_len, 64) with the caller's T stride; d_out contiguous.
  const uint64_t dims[3] = {(uint64_t)DH, (uint64_t)T_len, (uint64_t)BH};
  const uint64_t strides[2] = {(uint64_t)DH * E, (uint64_t)T_stride * DH * E};
  const uint64_t strides_do[2] = {(uint64_t)DH * E, (uint64_t)T_len * DH * E};
  const uint32_t box_row[3] = {(uint32_t)DH, (uint32_t)L, 1};
  const uint32_t box_col[3] = {(uint32_t)NJ, (uint32_t)L, 1};
  // s_hist: (B*H*n, 64, 64) f32; a block loads its 64 x 64/C slice.
  const uint64_t hd[3] = {(uint64_t)DH, (uint64_t)DH, (uint64_t)BH * n};
  const uint64_t hs[2] = {(uint64_t)DH * 4, (uint64_t)DH * DH * 4};
  const uint32_t hb[3] = {(uint32_t)NJ, (uint32_t)DH, 1};
  CUtensorMap mr, mk, mw, mv, md, mh;
  int e = sm90::encode_plain_map(&mr, map_type<T>(), 3, r, dims, strides, box_row);
  if (!e) e = sm90::encode_plain_map(&mk, map_type<T>(), 3, k, dims, strides, box_row);
  if (!e) e = sm90::encode_plain_map(&mw, map_type<T>(), 3, w, dims, strides, box_row);
  if (!e) e = sm90::encode_plain_map(&mv, map_type<T>(), 3, v, dims, strides, box_col);
  if (!e) e = sm90::encode_plain_map(&md, map_type<T>(), 3, d_out, dims, strides_do, box_col);
  if (!e) e = sm90::encode_plain_map(&mh, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, s_hist, hd, hs, hb);
  if (e) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, BH, 1);
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.dynamicSmemBytes = Y.total;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const T* u_ = static_cast<const T*>(u);
  const float* dso = static_cast<const float*>(d_s_out);
  T *dr_ = static_cast<T*>(dr), *dk_ = static_cast<T*>(dk), *dv_ = static_cast<T*>(dv),
    *dw_ = static_cast<T*>(dw);
  float *du_ = static_cast<float*>(du_part), *dh_ = static_cast<float*>(dh0);
  void* args[] = {&mr, &mk, &mw, &mv, &md, &mh, &u_, &dso, &dr_, &dk_, &dv_, &dw_,
                  &du_, &dh_, &H, &T_len, &L, &C};
  err = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(wkv_bwd_kernel<T, LP>), args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_padded(const void* r, const void* k, const void* v, const void* w, const void* u,
                  const void* s_hist, const void* d_out, const void* d_s_out, void* dr,
                  void* dk, void* dv, void* dw, void* du_part, void* dh0, int B, int H,
                  int T_len, int T_stride, int L, int C, cudaStream_t s) {
  switch (padded(L)) {
    case 4: return launch<T, 4>(r, k, v, w, u, s_hist, d_out, d_s_out, dr, dk, dv, dw, du_part, dh0, B, H, T_len, T_stride, L, C, s);
    case 8: return launch<T, 8>(r, k, v, w, u, s_hist, d_out, d_s_out, dr, dk, dv, dw, du_part, dh0, B, H, T_len, T_stride, L, C, s);
    case 16: return launch<T, 16>(r, k, v, w, u, s_hist, d_out, d_s_out, dr, dk, dv, dw, du_part, dh0, B, H, T_len, T_stride, L, C, s);
    default: return launch<T, 32>(r, k, v, w, u, s_hist, d_out, d_s_out, dr, dk, dv, dw, du_part, dh0, B, H, T_len, T_stride, L, C, s);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (r, k, v, w, u, d_out and dr, dk, dv,
// dw); s_hist, d_s_out, du_part and dh0 float32.  r/k/v/w may be a T-window
// of longer tensors (a shard of the sequence-parallel path, read in place):
// T_stride (>= T_len) tokens lie between consecutive (b, h) rows; d_out and
// the grads are contiguous (B, H, T_len, 64).  cluster: the blocks of one
// (batch, head), 1, 2 or 4, the wrapper's plan.  Returns 0, a cudaError_t,
// or 10000 + the CUresult of a tensor map.
extern "C" int wkv_bwd(const void* r, const void* k, const void* v, const void* w,
                       const void* u, const void* s_hist, const void* d_out,
                       const void* d_s_out, void* dr, void* dk, void* dv, void* dw,
                       void* du_part, void* dh0, int B, int H, int T_len, int T_stride, int Dh,
                       int chunk, int dtype, int cluster, void* stream) {
  if (Dh != DH || chunk < 1 || chunk > MAX_CHUNK || T_len < 1 || T_len % chunk != 0 ||
      T_stride < T_len || B < 1 || H < 1 || !(cluster == 1 || cluster == 2 || cluster == 4))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_padded<float>(r, k, v, w, u, s_hist, d_out, d_s_out, dr, dk, dv, dw, du_part,
                                dh0, B, H, T_len, T_stride, chunk, cluster, s);
  if (dtype == 1)
    return launch_padded<__nv_bfloat16>(r, k, v, w, u, s_hist, d_out, d_s_out, dr, dk, dv, dw,
                                        du_part, dh0, B, H, T_len, T_stride, chunk, cluster, s);
  return (int)cudaErrorInvalidValue;
}

// The shared memory (bytes) one block takes at this chunk, cluster size and
// dtype, or 0 past the card's limit: the wrapper's plan mirrors it.
extern "C" int wkv_bwd_smem(int chunk, int cluster, int dtype) {
  const size_t total = layout(padded(chunk), cluster, dtype == 0 ? 4 : 2).total;
  return total > SMEM_LIMIT ? 0 : (int)total;
}
