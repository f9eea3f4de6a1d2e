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
// What bounds it: device-memory bytes.  r/k/v/w/do and the four grads cross
// HBM once each, s_hist (B*H*(T/L)*16 KiB) once, d_s_out and dh0 once: about
// 75 MB at B=4, H=32, T=256, L=16 in bf16, 22.5 us at 3.35 TB/s, while the
// f32 arithmetic is about 3 GFLOP.
//
// Design: the Pallas kernel walks the chunks back to front as a sequential
// grid axis with dS in a VMEM scratch.  CUDA blocks run in no order, so the
// reverse chunk loop runs inside one block per (batch, head), and dS (64 x
// 64 f32) stays in shared memory for the whole sweep: the adjoint hand-off
// from chunk c+1 to chunk c never touches HBM.  Unlike the forward, the value
// columns cannot be split across blocks: dscores = do V^T and d_krem = V G^T
// sum over every value column, so dk and dw need whole rows.  One block
// holds all of dS and S; no atomics, so the grads repeat bit for bit.  At
// B=4, H=32 that is 128 blocks on 132 SMs.  Simple and correct first:
// CUDA-core f32 FMAs, no tensor cores, no TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int DH = 64;         // key/value width of one WKV head
constexpr int NT = 256;        // threads per block
constexpr int MAX_CHUNK = 32;  // shared memory: 143 KB at 32
constexpr int LD = DH + 1;     // padded row stride: no shared-memory bank conflicts

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

size_t smem_floats(int L) {
  // 12 (L, LD) tiles: r, k, v, do, cum_incl, cum_excl, r_dec, k_inv, k_rem
  // and the three adjoint tiles; S and dS (DH, LD); scores and dscores
  // (L, L+1); dov, rku (L); u, w_total, du (DH).
  return (size_t)12 * L * LD + (size_t)2 * DH * LD + (size_t)2 * L * (L + 1) +
         2 * L + 3 * DH;
}

template <typename T>
__global__ void __launch_bounds__(NT) wkv_bwd_kernel(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ w, const T* __restrict__ u,
    const float* __restrict__ s_hist, const T* __restrict__ d_out,
    const float* __restrict__ d_s_out, T* __restrict__ dr, T* __restrict__ dk,
    T* __restrict__ dv, T* __restrict__ dw, float* __restrict__ du_part,
    float* __restrict__ dh0, int H, int T_len, int T_stride, int L) {
  extern __shared__ float smem[];
  float* s_r = smem;
  float* s_k = s_r + L * LD;
  float* s_v = s_k + L * LD;
  float* s_do = s_v + L * LD;
  float* s_inc = s_do + L * LD;     // log w, then cum_incl
  float* s_exc = s_inc + L * LD;    // cum_excl
  float* s_rdec = s_exc + L * LD;
  float* s_kinv = s_rdec + L * LD;
  float* s_krem = s_kinv + L * LD;
  float* s_dexc = s_krem + L * LD;  // adjoint of cum_excl: d_rdec * r_dec
  float* s_dinc = s_dexc + L * LD;  // adjoint of cum_incl (rows < L-1 final)
  float* s_krdk = s_dinc + L * LD;  // d_krem * k_rem
  float* s_S = s_krdk + L * LD;     // entering state (DH, LD)
  float* s_dS = s_S + DH * LD;      // carried adjoint (DH, LD)
  float* s_sc = s_dS + DH * LD;     // scores (L, L+1)
  float* s_dsc = s_sc + L * (L + 1);
  float* s_dov = s_dsc + L * (L + 1);
  float* s_rku = s_dov + L;
  float* s_u = s_rku + L;
  float* s_wtot = s_u + DH;
  float* s_du = s_wtot + DH;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;          // b * H + h
  const int h = bh % H;
  const size_t in0 = (size_t)bh * T_stride * DH;   // row (b, h) of r/k/v/w
  const size_t seq0 = (size_t)bh * T_len * DH;      // of d_out and the grads
  const size_t st0 = (size_t)bh * DH * DH;
  const int n_chunks = T_len / L;

  // Reverse boundary: the last chunk's exit adjoint is d_s_out.
  for (int idx = tid; idx < DH * DH; idx += NT)
    s_dS[(idx / DH) * LD + idx % DH] = d_s_out[st0 + idx];
  if (tid < DH) {
    s_u[tid] = to_f(u[h * DH + tid]);
    s_du[tid] = 0.f;
  }

  for (int c = n_chunks - 1; c >= 0; --c) {
    const size_t base = seq0 + (size_t)c * L * DH;
    const size_t ibase = in0 + (size_t)c * L * DH;
    const float* S_c = s_hist + ((size_t)bh * n_chunks + c) * DH * DH;
    for (int idx = tid; idx < L * DH; idx += NT) {
      const int t = idx / DH, i = idx % DH;
      s_r[t * LD + i] = to_f(r[ibase + idx]);
      s_k[t * LD + i] = to_f(k[ibase + idx]);
      s_v[t * LD + i] = to_f(v[ibase + idx]);
      s_do[t * LD + i] = to_f(d_out[base + idx]);
      s_inc[t * LD + i] = logf(fminf(fmaxf(to_f(w[ibase + idx]), 1e-8f), 1.0f));
    }
    for (int idx = tid; idx < DH * DH; idx += NT)
      s_S[(idx / DH) * LD + idx % DH] = S_c[idx];
    __syncthreads();

    if (tid < DH) {
      // One key column per thread: the decay-ratio factors down the chunk.
      const int i = tid;
      float incl = 0.f;
      for (int t = 0; t < L; ++t) {
        const float lw = s_inc[t * LD + i];
        incl += lw;
        const float excl = incl - lw;
        s_exc[t * LD + i] = excl;
        s_inc[t * LD + i] = incl;
        s_rdec[t * LD + i] = s_r[t * LD + i] * expf(excl);
        s_kinv[t * LD + i] = s_k[t * LD + i] * expf(-incl);
      }
      for (int t = 0; t < L; ++t)
        s_krem[t * LD + i] = s_k[t * LD + i] * expf(incl - s_inc[t * LD + i]);
      s_wtot[i] = expf(incl);
    } else if (tid < DH + L) {
      // Per token: do.v and the u-bonus weight r.u.k.
      const int t = tid - DH;
      float dov = 0.f, rku = 0.f;
      for (int j = 0; j < DH; ++j) {
        dov += s_do[t * LD + j] * s_v[t * LD + j];
        rku += s_r[t * LD + j] * s_u[j] * s_k[t * LD + j];
      }
      s_dov[t] = dov;
      s_rku[t] = rku;
    }
    __syncthreads();

    // Strictly lower scores[t][s] = r_dec_t . k_inv_s and dscores = do_t . v_s.
    for (int idx = tid; idx < L * L; idx += NT) {
      const int t = idx / L, s = idx % L;
      float sc = 0.f, dsc = 0.f;
      if (s < t) {
        for (int i = 0; i < DH; ++i) {
          sc += s_rdec[t * LD + i] * s_kinv[s * LD + i];
          dsc += s_do[t * LD + i] * s_v[s * LD + i];
        }
      }
      s_sc[t * (L + 1) + s] = sc;
      s_dsc[t * (L + 1) + s] = dsc;
    }
    __syncthreads();

    // Row grads.  Each (t, i) reads only tiles written before the barrier
    // above and writes its own element of the three adjoint tiles.
    for (int idx = tid; idx < L * DH; idx += NT) {
      const int t = idx / DH, i = idx % DH;
      const size_t g = base + idx;
      const float inc = s_inc[t * LD + i];
      const float last = s_inc[(L - 1) * LD + i];
      const float bonus = s_u[i] * s_dov[t];

      float d_rdec = 0.f;
      for (int s = 0; s < t; ++s) d_rdec += s_dsc[t * (L + 1) + s] * s_kinv[s * LD + i];
      for (int j = 0; j < DH; ++j) d_rdec += s_do[t * LD + j] * s_S[i * LD + j];
      store(&dr[g], d_rdec * expf(s_exc[t * LD + i]) + bonus * s_k[t * LD + i]);
      s_dexc[t * LD + i] = d_rdec * s_rdec[t * LD + i];

      // Token t as the key side s of the scores.
      float d_kinv = 0.f;
      for (int s = t + 1; s < L; ++s) d_kinv += s_dsc[s * (L + 1) + t] * s_rdec[s * LD + i];
      float d_krem = 0.f;
      for (int j = 0; j < DH; ++j) d_krem += s_v[t * LD + j] * s_dS[i * LD + j];
      store(&dk[g], d_kinv * expf(-inc) + d_krem * expf(last - inc) +
                        bonus * s_r[t * LD + i]);
      const float krdk = d_krem * s_krem[t * LD + i];
      s_dinc[t * LD + i] = -d_kinv * s_kinv[t * LD + i] - krdk;
      s_krdk[t * LD + i] = krdk;

      // Here i is the value column j of dv[t].
      float dvv = s_rku[t] * s_do[t * LD + i];
      for (int s = t + 1; s < L; ++s) dvv += s_sc[s * (L + 1) + t] * s_do[s * LD + i];
      for (int q = 0; q < DH; ++q) dvv += s_krem[t * LD + q] * s_dS[q * LD + i];
      store(&dv[g], dvv);
    }
    __syncthreads();

    if (tid < DH) {
      // One key column per thread: the logw adjoint as suffix sums, dw, du.
      const int i = tid;
      float last = 0.f;
      for (int s = 0; s < L; ++s) last += s_krdk[s * LD + i];
      float sd = 0.f;
      for (int j = 0; j < DH; ++j) sd += s_S[i * LD + j] * s_dS[i * LD + j];
      last += s_wtot[i] * sd;
      float suf_inc = last, suf_exc = 0.f, du = 0.f;
      for (int t = L - 1; t >= 0; --t) {
        suf_inc += s_dinc[t * LD + i];
        const float dlogw = suf_inc + suf_exc;   // sum_{s>=t} dinc + sum_{s>t} dexc
        suf_exc += s_dexc[t * LD + i];
        const size_t g = base + (size_t)t * DH + i;
        const float wt = to_f(w[ibase + (size_t)t * DH + i]);
        const bool in_range = wt >= 1e-8f && wt <= 1.0f;
        store(&dw[g], in_range ? dlogw / fminf(fmaxf(wt, 1e-8f), 1.0f) : 0.f);
        du += s_r[t * LD + i] * s_k[t * LD + i] * s_dov[t];
      }
      s_du[i] += du;
    }
    __syncthreads();

    // Adjoint hand-off to chunk c-1: G_prev = diag(w_total) G + r_dec^T do.
    for (int idx = tid; idx < DH * DH; idx += NT) {
      const int i = idx / DH, j = idx % DH;
      float acc = 0.f;
      for (int t = 0; t < L; ++t) acc += s_rdec[t * LD + i] * s_do[t * LD + j];
      s_dS[i * LD + j] = s_dS[i * LD + j] * s_wtot[i] + acc;
    }
    __syncthreads();
  }

  for (int idx = tid; idx < DH * DH; idx += NT)
    dh0[st0 + idx] = s_dS[(idx / DH) * LD + idx % DH];
  if (tid < DH) du_part[(size_t)bh * DH + tid] = s_du[tid];
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* s_hist, const void* d_out,
           const void* d_s_out, void* dr, void* dk, void* dv, void* dw,
           void* du_part, void* dh0, int B, int H, int T_len, int T_stride,
           int L, cudaStream_t stream) {
  const size_t smem = smem_floats(L) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      wkv_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  wkv_bwd_kernel<T><<<B * H, NT, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w),
      static_cast<const T*>(u), static_cast<const float*>(s_hist),
      static_cast<const T*>(d_out), static_cast<const float*>(d_s_out),
      static_cast<T*>(dr), static_cast<T*>(dk), static_cast<T*>(dv),
      static_cast<T*>(dw), static_cast<float*>(du_part),
      static_cast<float*>(dh0), H, T_len, T_stride, L);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (r, k, v, w, u, d_out and dr, dk, dv,
// dw); s_hist, d_s_out, du_part and dh0 float32.  r/k/v/w may be a T-window
// of longer tensors (a shard of the sequence-parallel path, read in place):
// T_stride (>= T_len) tokens lie between consecutive (b, h) rows; d_out and
// the grads are contiguous (B, H, T_len, 64).  Returns 0 or the cudaError_t
// of the launch.
extern "C" int wkv_bwd(const void* r, const void* k, const void* v,
                       const void* w, const void* u, const void* s_hist,
                       const void* d_out, const void* d_s_out, void* dr,
                       void* dk, void* dv, void* dw, void* du_part, void* dh0,
                       int B, int H, int T_len, int T_stride, int Dh,
                       int chunk, int dtype, void* stream) {
  if (Dh != DH || chunk < 1 || chunk > MAX_CHUNK || T_len < 1 ||
      T_len % chunk != 0 || T_stride < T_len || B < 1 || H < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(r, k, v, w, u, s_hist, d_out, d_s_out, dr, dk, dv, dw,
                         du_part, dh0, B, H, T_len, T_stride, chunk, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(r, k, v, w, u, s_hist, d_out, d_s_out, dr, dk,
                                 dv, dw, du_part, dh0, B, H, T_len, T_stride,
                                 chunk, s);
  return (int)cudaErrorInvalidValue;
}
