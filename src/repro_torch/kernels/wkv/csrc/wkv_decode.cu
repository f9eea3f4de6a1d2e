// RWKV6 WKV decode window for Hopper (sm_90a), plain C interface.
//
// Replaces: src/repro/kernels/wkv/decode.py:wkv_decode_window_pallas (K <= 64
// chained decode steps, the admission of prompts of at most 64 tokens) and
// src/repro/kernels/wkv/decode.py:wkv_decode_pallas (one step, every
// generated token in every layer).  Both entry points launch this one kernel;
// the single step is its K = 1 case, which keeps a window bit-identical to K
// chained single steps.
//
//   o = r @ S + (r . u . k) v,   S' = diag(w) S + k^T v     (per token, f32)
//
// What bounds it: device-memory bytes.  The 64 x 64 f32 state of every
// (batch, head) is read once and written once per window: at B=4, H=32 that
// is 4 MiB, 1.25 us at 3.35 TB/s; the per-token r/k/v/w/out rows are small.
//
// Design: the Pallas window kernel carried S across a sequential grid axis of
// decode steps in VMEM.  Here the K steps are a loop inside one block and S
// stays in registers for the whole window: each thread holds 8 rows of one
// value column.  Value columns are independent, so the grid is (B*H, 64/32)
// with no cross-block reduction; the per-token r.u.k bonus is recomputed per
// block.  The column sum o = r @ S is reduced across the 8 row groups through
// shared memory in a fixed order, so results are deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int DH = 64;              // key/value width of one WKV head
constexpr int JT = 32;              // value columns per block (one per lane)
constexpr int NT = 256;             // threads per block
constexpr int RG = NT / JT;         // row groups (one per warp)
constexpr int RPT = DH / RG;        // state rows per thread
constexpr int MAX_WINDOW = 64;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T>
__global__ void __launch_bounds__(NT) wkv_decode_kernel(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ w, const T* __restrict__ u,
    const float* __restrict__ h0, T* __restrict__ out,
    float* __restrict__ s_out, int H, int K) {
  __shared__ float s_r[DH], s_k[DH], s_w[DH], s_u[DH];
  __shared__ float s_red[RG][JT];
  __shared__ float s_bonus;

  const int tid = threadIdx.x;
  const int jj = tid % JT;
  const int rg = tid / JT;            // warp index: rows rg*RPT .. rg*RPT+RPT-1
  const int bh = blockIdx.x;          // b * H + h
  const int h = bh % H;
  const int j = blockIdx.y * JT + jj;
  const size_t st0 = (size_t)bh * DH * DH;

  float S[RPT];
#pragma unroll
  for (int m = 0; m < RPT; ++m) S[m] = h0[st0 + (size_t)(rg * RPT + m) * DH + j];
  if (tid < DH) s_u[tid] = to_f(u[h * DH + tid]);

  for (int t = 0; t < K; ++t) {
    const size_t row = ((size_t)bh * K + t) * DH;
    if (tid < DH) {
      s_r[tid] = to_f(r[row + tid]);
      s_k[tid] = to_f(k[row + tid]);
      s_w[tid] = to_f(w[row + tid]);
    }
    __syncthreads();
    if (rg == 0) {
      // Warp 0: the bonus r . u . k, a fixed-order butterfly over 64 terms.
      float a = s_r[jj] * s_u[jj] * s_k[jj] + s_r[jj + 32] * s_u[jj + 32] * s_k[jj + 32];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) a += __shfl_xor_sync(0xffffffffu, a, off);
      if (jj == 0) s_bonus = a;
    }
    const float vj = to_f(v[row + j]);
    float p = 0.f;
#pragma unroll
    for (int m = 0; m < RPT; ++m) p += s_r[rg * RPT + m] * S[m];
    s_red[rg][jj] = p;
    __syncthreads();
    if (rg == 0) {
      float o = s_red[0][jj];
#pragma unroll
      for (int g = 1; g < RG; ++g) o += s_red[g][jj];
      store(&out[row + j], o + s_bonus * vj);
    }
#pragma unroll
    for (int m = 0; m < RPT; ++m)
      S[m] = S[m] * s_w[rg * RPT + m] + s_k[rg * RPT + m] * vj;
    __syncthreads();   // the next token overwrites s_r/s_k/s_w/s_red
  }

#pragma unroll
  for (int m = 0; m < RPT; ++m) s_out[st0 + (size_t)(rg * RPT + m) * DH + j] = S[m];
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* h0, void* out, void* s_out, int B,
           int H, int K, cudaStream_t stream) {
  dim3 grid(B * H, DH / JT);
  wkv_decode_kernel<T><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w),
      static_cast<const T*>(u), static_cast<const float*>(h0),
      static_cast<T*>(out), static_cast<float*>(s_out), H, K);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (r, k, v, w, u, out); h0 and s_out float32.
// Each block reads its state tile before it writes it, so s_out may alias h0.
// Returns 0 or the cudaError_t of the launch.
extern "C" int wkv_decode_window_fwd(const void* r, const void* k, const void* v,
                                     const void* w, const void* u, const void* h0,
                                     void* out, void* s_out, int B, int H, int K,
                                     int Dh, int dtype, void* stream) {
  if (Dh != DH || K < 1 || K > MAX_WINDOW || B < 1 || H < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(r, k, v, w, u, h0, out, s_out, B, H, K, s);
  if (dtype == 1) return launch<__nv_bfloat16>(r, k, v, w, u, h0, out, s_out, B, H, K, s);
  return (int)cudaErrorInvalidValue;
}
