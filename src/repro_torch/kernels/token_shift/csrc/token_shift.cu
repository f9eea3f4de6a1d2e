// Token shift (causal depthwise conv) for Hopper (sm_90a), plain C interface.
//
// Replaces: src/repro/kernels/token_shift/kernel.py:token_shift_pallas, the
// RG-LRU temporal conv of every `rec` layer (width 4), on every call.
//
//   out[b, t, d] = sum_{k < taps} w[k, d] * x[b, t - k, d]      (x[t < 0] = 0)
//
// What bounds it: device-memory bytes.  Each x row is read once and each out
// row written once (the taps-1 halo rows above a tile are re-read, a
// ROWS/(ROWS + taps - 1) overhead that stays in L2): at the 259-row stateful
// prefill of B=4, D=2560 in bf16 that is 10.6 MB, 3.2 us at 3.35 TB/s.  A
// single-token call (T = 4) moves 80 KB, so launch latency sets its time.
//
// Design: the Pallas kernel walked the sequence in chunks and carried the
// last taps-1 rows of each chunk in a VMEM token buffer.  On the card that
// carry is only a halo: a thread owns one channel and ROWS consecutive rows,
// loads the taps-1 rows above them first, and then slides a register window
// down its rows, so no block waits on another and any T >= 1 works (the
// Pallas wrapper demands that min(256, T) divide T).  Neighbouring threads
// own neighbouring channels, so every row load is coalesced.  The sum runs
// in f32 in the plain version's order (tap 0 first, each product rounded
// before it is added: __fmul_rn then __fadd_rn, no fused multiply-add), so
// f32 results equal the plain PyTorch version's bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_TAPS = 8;
constexpr int NT = 256;     // threads per block: one channel each
constexpr int ROWS = 16;    // consecutive rows per thread

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T>
__global__ void __launch_bounds__(NT) token_shift_kernel(
    const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
    int Tn, int D, int taps) {
  const int d = blockIdx.x * NT + threadIdx.x;
  if (d >= D) return;
  const int t0 = blockIdx.y * ROWS;
  const size_t base = (size_t)blockIdx.z * Tn * D + d;

  float wk[MAX_TAPS];
  float hist[MAX_TAPS];   // hist[k] = x[t - k] for the current row t
#pragma unroll
  for (int k = 0; k < MAX_TAPS; ++k) {
    wk[k] = k < taps ? to_f(w[(size_t)k * D + d]) : 0.f;
    const int tt = t0 - k;
    hist[k] = (k > 0 && k < taps && tt >= 0) ? to_f(x[base + (size_t)tt * D]) : 0.f;
  }
  const int t_end = min(t0 + ROWS, Tn);
  for (int t = t0; t < t_end; ++t) {
    hist[0] = to_f(x[base + (size_t)t * D]);
    float acc = __fmul_rn(wk[0], hist[0]);
#pragma unroll
    for (int k = 1; k < MAX_TAPS; ++k)
      if (k < taps) acc = __fadd_rn(acc, __fmul_rn(wk[k], hist[k]));
    store(&out[base + (size_t)t * D], acc);
#pragma unroll
    for (int k = MAX_TAPS - 1; k > 0; --k) hist[k] = hist[k - 1];
  }
}

template <typename T>
int launch(const void* x, const void* w, void* out, int B, int Tn, int D,
           int taps, cudaStream_t stream) {
  dim3 grid((D + NT - 1) / NT, (Tn + ROWS - 1) / ROWS, B);
  token_shift_kernel<T><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out),
      Tn, D, taps);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w and out alike).
// Returns 0 or the cudaError_t of the launch.
extern "C" int token_shift_fwd(const void* x, const void* w, void* out, int B,
                               int Tn, int D, int taps, int dtype, void* stream) {
  if (B < 1 || B > 65535 || Tn < 1 || (Tn + ROWS - 1) / ROWS > 65535 || D < 1 ||
      taps < 2 || taps > MAX_TAPS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, w, out, B, Tn, D, taps, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, w, out, B, Tn, D, taps, s);
  return (int)cudaErrorInvalidValue;
}
