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
// What bounds it: device-memory bytes.  r/k/v/w/out cross HBM once each and
// S once in and once out; at B=4, H=32, T=256 in bf16 that is about 24 MiB,
// 7.5 us at 3.35 TB/s, while the f32 arithmetic is about 0.6 GFLOP.
//
// Design: the Pallas kernel carried S from chunk to chunk in VMEM across
// sequential grid steps.  CUDA blocks run in no order, so the chunk axis is a
// loop inside one block, and S (a 64 x 32 f32 tile of the 64 x 64 state) stays
// in shared memory for the whole sweep: it touches HBM once on the way in and
// once on the way out.  Value columns are independent (column j of S and of
// out depends only on column j of v), so the grid is (B*H, 64/32) and fills
// the card even at B=1 with no cross-block reduction; each block recomputes
// the r.k scores it needs.  Simple and correct first: CUDA-core f32 FMAs,
// no tensor cores, no TMA.
//
// Training (s_hist not null): at the top of chunk c each block writes its
// 64 x 32 tile of the entering state to s_hist[b, h, c], B*H*(T/L)*16 KiB in
// all (33.5 MB at B=4, H=32, T=256, L=16), which makes the training forward
// about 2.3x the inference bytes.  With s_hist null the kernel does exactly
// what the inference launch does.
//
// Segment summary (a_seg not null): a_seg[b, h, i] = prod_t clip(w_t[i],
// 1e-8, 1), in the Pallas order: the carry starts at 1 and each chunk
// multiplies in its w_total = exp(sum of the chunk's log w), which the key
// row's thread already holds, so the running product is one register per
// key row and costs nothing.  Both value-column blocks of a (b, h) compute
// it; only blockIdx.y == 0 writes it.  A long segment underflows to 0
// (denormals are kept: nothing here is built to flush them).  The summary
// launches may read their inputs in place as a T-window of longer tensors:
// T_stride is the token count between consecutive (b, h) rows of r/k/v/w
// (T_len for contiguous inputs), while out is always a contiguous
// (B, H, T_len, 64) tensor.  One shard of a 4096-token prompt over 4 shards
// (B=1, H=32, T=1024, bf16) moves about 21 MB: 6.4 us at 3.35 TB/s; the
// training summary with s_hist at chunk 16 about 55 MB: 16.4 us.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int DH = 64;         // key/value width of one WKV head
constexpr int JT = 32;         // value columns per block
constexpr int NT = 256;        // threads per block
constexpr int MAX_CHUNK = 64;
constexpr int LD = DH + 1;     // padded row stride: no shared-memory bank conflicts

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

size_t smem_floats(int L) {
  // r, k, cum log w, r_dec, k_inv, k_rem: (L, LD) each; scores (L, L+1);
  // v tile (L, JT); bonus (L); u, w_total (DH each); S tile (DH, JT).
  return (size_t)6 * L * LD + (size_t)L * (L + 1) + (size_t)L * JT + L +
         2 * DH + DH * JT;
}

template <typename T>
__global__ void __launch_bounds__(NT) wkv_chunked_kernel(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ w, const T* __restrict__ u,
    const float* __restrict__ h0, T* __restrict__ out,
    float* __restrict__ s_out, float* __restrict__ s_hist,
    float* __restrict__ a_seg, int H, int T_len, int T_stride, int L) {
  extern __shared__ float smem[];
  float* s_r = smem;
  float* s_k = s_r + L * LD;
  float* s_cum = s_k + L * LD;
  float* s_rdec = s_cum + L * LD;
  float* s_kinv = s_rdec + L * LD;
  float* s_krem = s_kinv + L * LD;
  float* s_sc = s_krem + L * LD;
  float* s_v = s_sc + L * (L + 1);
  float* s_bonus = s_v + L * JT;
  float* s_u = s_bonus + L;
  float* s_wtot = s_u + DH;
  float* s_S = s_wtot + DH;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;          // b * H + h
  const int h = bh % H;
  const int j0 = blockIdx.y * JT;     // first value column of this block
  const size_t seq0 = (size_t)bh * T_stride * DH;   // row (b, h) of r/k/v/w
  const size_t out0 = (size_t)bh * T_len * DH;      // row (b, h) of out
  const size_t st0 = (size_t)bh * DH * DH;

  // Boundary: the sweep starts from h0 (the Pallas reset_carry at chunk 0).
  for (int idx = tid; idx < DH * JT; idx += NT) {
    const int i = idx / JT, jj = idx % JT;
    s_S[idx] = h0[st0 + (size_t)i * DH + j0 + jj];
  }
  if (tid < DH) s_u[tid] = to_f(u[h * DH + tid]);
  float a_run = 1.f;   // key row tid's running decay product (tid < DH)

  const int n_chunks = T_len / L;
  for (int c = 0; c < n_chunks; ++c) {
    const size_t base = seq0 + (size_t)c * L * DH;
    const size_t obase = out0 + (size_t)c * L * DH;
    if (s_hist != nullptr) {
      // s_S is the state entering chunk c (the previous hand-off ended in a
      // barrier) and is not written again before the next barrier.
      float* dst = s_hist + ((size_t)bh * n_chunks + c) * DH * DH;
      for (int idx = tid; idx < DH * JT; idx += NT) {
        const int i = idx / JT, jj = idx % JT;
        dst[(size_t)i * DH + j0 + jj] = s_S[idx];
      }
    }
    for (int idx = tid; idx < L * DH; idx += NT) {
      const int t = idx / DH, i = idx % DH;
      s_r[t * LD + i] = to_f(r[base + idx]);
      s_k[t * LD + i] = to_f(k[base + idx]);
      s_cum[t * LD + i] = logf(fminf(fmaxf(to_f(w[base + idx]), 1e-8f), 1.0f));
    }
    for (int idx = tid; idx < L * JT; idx += NT) {
      const int t = idx / JT, jj = idx % JT;
      s_v[idx] = to_f(v[base + (size_t)t * DH + j0 + jj]);
    }
    __syncthreads();

    if (tid < DH) {
      // One key row per thread: the decay-ratio factorisation down the chunk.
      const int i = tid;
      float incl = 0.f;
      for (int t = 0; t < L; ++t) {
        const float lw = s_cum[t * LD + i];
        incl += lw;
        const float excl = incl - lw;
        s_rdec[t * LD + i] = s_r[t * LD + i] * expf(excl);
        s_kinv[t * LD + i] = s_k[t * LD + i] * expf(-incl);
        s_cum[t * LD + i] = incl;
      }
      for (int t = 0; t < L; ++t)
        s_krem[t * LD + i] = s_k[t * LD + i] * expf(incl - s_cum[t * LD + i]);
      s_wtot[i] = expf(incl);
      a_run *= s_wtot[i];
    } else if (tid < DH + L) {
      // u-bonus of token t: sum_i r_t[i] u[i] k_t[i].
      const int t = tid - DH;
      float acc = 0.f;
      for (int i = 0; i < DH; ++i)
        acc += s_r[t * LD + i] * s_u[i] * s_k[t * LD + i];
      s_bonus[t] = acc;
    }
    __syncthreads();

    // Strictly lower scores A[t][s] = r_dec_t . k_inv_s, s < t.
    for (int idx = tid; idx < L * L; idx += NT) {
      const int t = idx / L, s = idx % L;
      float acc = 0.f;
      if (s < t) {
        for (int i = 0; i < DH; ++i)
          acc += s_rdec[t * LD + i] * s_kinv[s * LD + i];
      }
      s_sc[t * (L + 1) + s] = acc;
    }
    __syncthreads();

    // Outputs: intra-chunk scores @ v + bonus * v, plus r_dec @ S (entering S).
    {
      const int jj = tid % JT;
      for (int t = tid / JT; t < L; t += NT / JT) {
        float intra = 0.f;
        for (int s = 0; s < L; ++s) intra += s_sc[t * (L + 1) + s] * s_v[s * JT + jj];
        intra += s_bonus[t] * s_v[t * JT + jj];
        float inter = 0.f;
        for (int i = 0; i < DH; ++i) inter += s_rdec[t * LD + i] * s_S[i * JT + jj];
        store(&out[obase + (size_t)t * DH + j0 + jj], intra + inter);
      }
    }
    __syncthreads();

    // Hand-off to the next chunk: S = diag(w_total) S + k_rem^T v.
    {
      const int jj = tid % JT;
      for (int i = tid / JT; i < DH; i += NT / JT) {
        float acc = 0.f;
        for (int s = 0; s < L; ++s) acc += s_krem[s * LD + i] * s_v[s * JT + jj];
        s_S[i * JT + jj] = s_S[i * JT + jj] * s_wtot[i] + acc;
      }
    }
    __syncthreads();
  }

  for (int idx = tid; idx < DH * JT; idx += NT) {
    const int i = idx / JT, jj = idx % JT;
    s_out[st0 + (size_t)i * DH + j0 + jj] = s_S[idx];
  }
  if (a_seg != nullptr && blockIdx.y == 0 && tid < DH)
    a_seg[(size_t)bh * DH + tid] = a_run;
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* h0, void* out, void* s_out,
           void* s_hist, void* a_seg, int B, int H, int T_len, int T_stride,
           int L, cudaStream_t stream) {
  const size_t smem = smem_floats(L) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      wkv_chunked_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, DH / JT);
  wkv_chunked_kernel<T><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w),
      static_cast<const T*>(u), static_cast<const float*>(h0),
      static_cast<T*>(out), static_cast<float*>(s_out),
      static_cast<float*>(s_hist), static_cast<float*>(a_seg), H, T_len,
      T_stride, L);
  return (int)cudaGetLastError();
}

int dispatch(const void* r, const void* k, const void* v, const void* w,
             const void* u, const void* h0, void* out, void* s_out,
             void* s_hist, void* a_seg, int B, int H, int T_len, int T_stride,
             int Dh, int chunk, int dtype, void* stream) {
  if (Dh != DH || chunk < 1 || chunk > MAX_CHUNK || T_len < 1 ||
      T_len % chunk != 0 || T_stride < T_len || B < 1 || H < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(r, k, v, w, u, h0, out, s_out, s_hist, a_seg, B, H,
                         T_len, T_stride, chunk, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(r, k, v, w, u, h0, out, s_out, s_hist, a_seg,
                                 B, H, T_len, T_stride, chunk, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (r, k, v, w, u, out); h0 and s_out float32.
// Returns 0 or the cudaError_t of the launch.
extern "C" int wkv_chunked_fwd(const void* r, const void* k, const void* v,
                               const void* w, const void* u, const void* h0,
                               void* out, void* s_out, int B, int H, int T_len,
                               int Dh, int chunk, int dtype, void* stream) {
  return dispatch(r, k, v, w, u, h0, out, s_out, nullptr, nullptr, B, H,
                  T_len, T_len, Dh, chunk, dtype, stream);
}

// The training forward: as wkv_chunked_fwd, and s_hist (B, H, T/chunk, 64,
// 64) float32 receives the state entering each chunk.
extern "C" int wkv_chunked_train_fwd(const void* r, const void* k,
                                     const void* v, const void* w,
                                     const void* u, const void* h0, void* out,
                                     void* s_out, void* s_hist, int B, int H,
                                     int T_len, int Dh, int chunk, int dtype,
                                     void* stream) {
  return dispatch(r, k, v, w, u, h0, out, s_out, s_hist, nullptr, B, H,
                  T_len, T_len, Dh, chunk, dtype, stream);
}

// The segment-summary forward: as wkv_chunked_fwd, and a_seg (B, H, 64)
// float32 receives the product of the segment's clipped decays.  r/k/v/w
// may be a T-window of longer tensors: T_stride (>= T_len) tokens lie
// between consecutive (b, h) rows; out is contiguous (B, H, T_len, 64).
extern "C" int wkv_chunked_summary_fwd(const void* r, const void* k,
                                       const void* v, const void* w,
                                       const void* u, const void* h0,
                                       void* out, void* s_out, void* a_seg,
                                       int B, int H, int T_len, int T_stride,
                                       int Dh, int chunk, int dtype,
                                       void* stream) {
  return dispatch(r, k, v, w, u, h0, out, s_out, nullptr, a_seg, B, H, T_len,
                  T_stride, Dh, chunk, dtype, stream);
}

// The training forward with the segment summary: s_hist and a_seg written
// in one sweep (wkv_chunked_train_fwd plus a_seg, with T_stride as above).
extern "C" int wkv_chunked_train_summary_fwd(
    const void* r, const void* k, const void* v, const void* w, const void* u,
    const void* h0, void* out, void* s_out, void* s_hist, void* a_seg, int B,
    int H, int T_len, int T_stride, int Dh, int chunk, int dtype,
    void* stream) {
  return dispatch(r, k, v, w, u, h0, out, s_out, s_hist, a_seg, B, H, T_len,
                  T_stride, Dh, chunk, dtype, stream);
}
