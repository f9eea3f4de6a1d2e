// Elevator scan h[t] = a[t] * h[t-1] + x[t] for Hopper (sm_90a), plain C
// interface.  Two entry points, one recurrence:
//
// elevator_scan_fwd replaces src/repro/kernels/elevator_scan/kernel.py:
//   elevator_scan_pallas, the RG-LRU recurrence of every `rec` layer in a
//   cache-free forward and in every stateful window of more than 64 tokens
//   (the prompt prefill).
// elevator_decode_window_fwd replaces src/repro/kernels/elevator_scan/
//   decode.py:elevator_decode_window_pallas, every generated token (K = 1)
//   and every admission of at most 64 tokens.
//
// What bounds them: device-memory bytes.  The scan reads a and x once and
// writes h once: at B=4, T=256, D=2560 in f32 that is 31.5 MB, 9.4 us at
// 3.35 TB/s, and 126 MB (37.6 us) at B=1, T=4096.  A single decode step
// moves 40 KB at B=4 in f32, so launch latency sets its time.
//
// Design.  The carry axis T can never be a grid axis: CUDA blocks run in no
// order.  The Pallas kernel carried h across a sequential grid axis of
// chunks in VMEM and solved each chunk by Hillis-Steele doubling.  Here one
// block owns 32 channels (one per lane, so each row load is one coalesced
// 128-byte line in f32) of one batch row and walks T itself in chunks of
// WARPS * SEG rows.  Inside a chunk each warp scans its own SEG-row segment
// from zero, keeping the rows and the running product of a in registers;
// the warps' (prod a, h) segment summaries compose in shared memory (the
// reference's SegmentMonoid, (A1, H1) then (A2, H2) = (A2 A1, A2 H1 + H2)),
// which gives each warp the carry entering its segment; one fix-up per row
// (h = prod_a * carry + h_local) finishes the chunk, and the chunk's exit
// state seeds the next chunk in a register.  The carry never leaves the SM,
// and at B=1, D=2560 the grid still has 80 blocks of 8 warps each issuing
// 32 independent row loads.  This sums in another order than the
// sequential plain version, so the two agree to a stated tolerance.
//
// The window kernel is one thread per (batch, channel) looping over the K
// tokens with h in a register.  Every step (in both kernels) rounds a * h
// before adding x (__fmul_rn then __fadd_rn, never a fused multiply-add),
// as the plain version does, and the window returns its f32 exit state, so
// a window equals K chained single launches bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int LANES = 32;              // channels per block (one per lane)
constexpr int WARPS = 8;               // segments per chunk (one per warp)
constexpr int SEG = 16;                // rows per segment
constexpr int CHUNK = WARPS * SEG;     // rows per chunk
constexpr int WIN_THREADS = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// One step of the recurrence in its one fixed form.
__device__ __forceinline__ float step(float a, float h, float x) {
  return __fadd_rn(__fmul_rn(a, h), x);
}

template <typename T>
__global__ void __launch_bounds__(LANES * WARPS) elevator_scan_kernel(
    const T* __restrict__ a, const T* __restrict__ x,
    const float* __restrict__ h0, T* __restrict__ out, int Tn, int D) {
  __shared__ float s_a[WARPS][LANES];   // prod of a over each segment
  __shared__ float s_h[WARPS][LANES];   // each segment's scan from zero

  const int lane = threadIdx.x % LANES;
  const int warp = threadIdx.x / LANES;
  const int d = blockIdx.x * LANES + lane;
  const bool live = d < D;
  const size_t base = (size_t)blockIdx.y * Tn * D + d;
  float carry = (live && h0 != nullptr) ? h0[(size_t)blockIdx.y * D + d] : 0.f;

  for (int c0 = 0; c0 < Tn; c0 += CHUNK) {
    const int r0 = c0 + warp * SEG;
    float av[SEG], hv[SEG];
#pragma unroll
    for (int i = 0; i < SEG; ++i) {      // rows past T are identity steps
      const bool ok = live && r0 + i < Tn;
      av[i] = ok ? to_f(a[base + (size_t)(r0 + i) * D]) : 1.f;
      hv[i] = ok ? to_f(x[base + (size_t)(r0 + i) * D]) : 0.f;
    }
    float prod = 1.f, h = 0.f;           // scan from zero, running prod of a
#pragma unroll
    for (int i = 0; i < SEG; ++i) {
      h = step(av[i], h, hv[i]);
      hv[i] = h;
      prod = __fmul_rn(prod, av[i]);
      av[i] = prod;
    }
    s_a[warp][lane] = prod;
    s_h[warp][lane] = h;
    __syncthreads();
    // The carry entering this segment, then (the same chain continued, so
    // every warp reaches the same value) the carry leaving the chunk.
    float c_in = carry;
    for (int w = 0; w < warp; ++w) c_in = step(s_a[w][lane], c_in, s_h[w][lane]);
    carry = c_in;
    for (int w = warp; w < WARPS; ++w) carry = step(s_a[w][lane], carry, s_h[w][lane]);
#pragma unroll
    for (int i = 0; i < SEG; ++i)
      if (live && r0 + i < Tn) store(&out[base + (size_t)(r0 + i) * D], step(av[i], c_in, hv[i]));
    __syncthreads();                     // the next chunk rewrites s_a / s_h
  }
}

template <typename T>
__global__ void __launch_bounds__(WIN_THREADS) elevator_window_kernel(
    const T* __restrict__ a, const T* __restrict__ x, const float* h0,
    T* __restrict__ out, float* h_out, int K, int D) {
  const int d = blockIdx.x * WIN_THREADS + threadIdx.x;
  if (d >= D) return;
  const size_t row = (size_t)blockIdx.y * D + d;
  const size_t base = (size_t)blockIdx.y * K * D + d;
  float h = h0[row];
  for (int t = 0; t < K; ++t) {
    h = step(to_f(a[base + (size_t)t * D]), h, to_f(x[base + (size_t)t * D]));
    store(&out[base + (size_t)t * D], h);
  }
  h_out[row] = h;
}

template <typename T>
int launch_scan(const void* a, const void* x, const void* h0, void* out, int B,
                int Tn, int D, cudaStream_t stream) {
  dim3 grid((D + LANES - 1) / LANES, B);
  elevator_scan_kernel<T><<<grid, LANES * WARPS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(x),
      static_cast<const float*>(h0), static_cast<T*>(out), Tn, D);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_window(const void* a, const void* x, const void* h0, void* out,
                  void* h_out, int B, int K, int D, cudaStream_t stream) {
  dim3 grid((D + WIN_THREADS - 1) / WIN_THREADS, B);
  elevator_window_kernel<T><<<grid, WIN_THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(x),
      static_cast<const float*>(h0), static_cast<T*>(out),
      static_cast<float*>(h_out), K, D);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (a, x, out); h0 float32 or null (zeros).
// Returns 0 or the cudaError_t of the launch.
extern "C" int elevator_scan_fwd(const void* a, const void* x, const void* h0,
                                 void* out, int B, int Tn, int D, int dtype,
                                 void* stream) {
  if (B < 1 || B > 65535 || Tn < 1 || D < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_scan<float>(a, x, h0, out, B, Tn, D, s);
  if (dtype == 1) return launch_scan<__nv_bfloat16>(a, x, h0, out, B, Tn, D, s);
  return (int)cudaErrorInvalidValue;
}

// dtype as above; h0 and h_out float32 (B, D).  Each thread reads its h0
// entry before it writes its h_out entry, so h_out may alias h0.
extern "C" int elevator_decode_window_fwd(const void* a, const void* x,
                                          const void* h0, void* out, void* h_out,
                                          int B, int K, int D, int dtype,
                                          void* stream) {
  if (B < 1 || B > 65535 || K < 1 || D < 1 || h0 == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_window<float>(a, x, h0, out, h_out, B, K, D, s);
  if (dtype == 1) return launch_window<__nv_bfloat16>(a, x, h0, out, h_out, B, K, D, s);
  return (int)cudaErrorInvalidValue;
}
