// Token shift (causal depthwise conv) for Hopper (sm_90a), plain C interface.
//
// Replaces: src/repro/kernels/token_shift/kernel.py:token_shift_pallas, the
// RG-LRU temporal conv of every `rec` layer (width 4), on every call.
//
//   out[b, t, d] = sum_{k < taps} w[k, d] * x[b, t - k, d]      (x[t < 0] = 0)
//
// What bounds it: device-memory bytes.  Each x row is read once and each out
// row written once: at the 4096-token forward of B=1, D=2560 in bf16 that is
// 42 MB, 12.5 us at 3.35 TB/s.  A decode call (T = 4: the 3-row conv tail and
// one new token) moves 184 KB, so the launch and one round trip to device
// memory set its time.
//
// Design: the Pallas kernel walked the sequence in chunks and carried the
// last taps-1 rows of each chunk in a VMEM token buffer.  On the card that
// carry is only a halo: a thread owns one 16-byte slot of a row (8 bf16 or 4
// f32 channels) for ROWS consecutive rows, and loads the taps-1 halo rows
// above them and its own rows all at once, before any arithmetic, in 16-byte
// loads that neighbouring threads issue on neighbouring slots; so no block
// waits on another, every load of a thread is in flight together, and any
// T >= 1 works (the Pallas wrapper demands that min(256, T) divide T).  ROWS
// (8, 4 or 1) is the largest that still gives every SM 8 blocks: 8 at the
// 4096-token forward, 4 at the 259-token prefill, 1 at a decode call, whose
// rows then spread over the SMs.  The tap count is a template parameter, so
// the halo and the weights take only the registers they need.
// Where D is not a multiple of the slot or a row is not 16-byte aligned, the
// same kernel moves each slot as scalars and the last slot of a row holds
// the tail channels.  The sum runs in f32 in the plain version's order (tap
// 0 first, each product rounded before it is added: __fmul_rn then
// __fadd_rn, no fused multiply-add), so f32 results equal the plain PyTorch
// version's bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_TAPS = 8;
constexpr int NT = 64;              // threads per block, one slot each
constexpr int FILL = 8;             // blocks an SM that a plan of more rows must keep

// A 16-byte slot of one row: 4 f32 or 8 bf16 channels, kept as raw bits.
template <typename T>
struct Slot;

template <>
struct Slot<float> {
  static constexpr int V = 4;
  __device__ static float chan(const uint4& q, int c) {
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
    return __uint_as_float(w[c]);
  }
  __device__ static uint32_t bits(const float* p, int c, int left) {
    return c < left ? __float_as_uint(p[c]) : 0u;
  }
  __device__ static uint4 pack(const float (&a)[V]) {
    return make_uint4(__float_as_uint(a[0]), __float_as_uint(a[1]), __float_as_uint(a[2]),
                      __float_as_uint(a[3]));
  }
  __device__ static void put(float* p, float a) { *p = a; }
};

template <>
struct Slot<__nv_bfloat16> {
  static constexpr int V = 8;
  __device__ static float chan(const uint4& q, int c) {
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
    return __uint_as_float(c & 1 ? w[c >> 1] & 0xffff0000u : w[c >> 1] << 16);
  }
  __device__ static uint32_t bits(const __nv_bfloat16* p, int c, int left) {
    return c < left ? __bfloat16_as_ushort(p[c]) : 0u;
  }
  __device__ static uint32_t two(float lo, float hi) {
    return __bfloat16_as_ushort(__float2bfloat16(lo)) |
           (uint32_t)__bfloat16_as_ushort(__float2bfloat16(hi)) << 16;
  }
  __device__ static uint4 pack(const float (&a)[V]) {
    return make_uint4(two(a[0], a[1]), two(a[2], a[3]), two(a[4], a[5]), two(a[6], a[7]));
  }
  __device__ static void put(__nv_bfloat16* p, float a) { *p = __float2bfloat16(a); }
};

// The slot at p, `left` channels of it in the row (more than a slot: all of
// it): one 16-byte load, or scalar loads with the missing channels zero.
template <typename T, bool VEC>
__device__ __forceinline__ uint4 load_slot(const T* p, int left) {
  using S = Slot<T>;
  if (VEC) return *reinterpret_cast<const uint4*>(p);
  if (S::V == 4) return make_uint4(S::bits(p, 0, left), S::bits(p, 1, left),
                                   S::bits(p, 2, left), S::bits(p, 3, left));
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) w[i] = S::bits(p, 2 * i, left) | S::bits(p, 2 * i + 1, left) << 16;
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <typename T, bool VEC>
__device__ __forceinline__ void store_slot(T* p, const float (&acc)[Slot<T>::V], int left) {
  if (VEC) {
    *reinterpret_cast<uint4*>(p) = Slot<T>::pack(acc);
    return;
  }
#pragma unroll
  for (int c = 0; c < Slot<T>::V; ++c)
    if (c < left) Slot<T>::put(p + c, acc[c]);
}

template <typename T, int TAPS, int ROWS, bool VEC>
__global__ void __launch_bounds__(NT) token_shift_kernel(
    const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out, int Tn, int D) {
  constexpr int V = Slot<T>::V;
  constexpr int HALO = TAPS - 1;    // rows above the tile that the taps read
  const int d0 = (blockIdx.x * NT + threadIdx.x) * V;
  if (d0 >= D) return;
  const int left = D - d0;
  const int t0 = blockIdx.y * ROWS;
  const size_t base = (size_t)blockIdx.z * Tn * D + d0;

  // Every load first: the taps' weights, then rows t0 - HALO .. t0 + ROWS - 1
  // (slot i holds row t0 - HALO + i; rows before 0 are zero, as x[t < 0]
  // is, and rows past the end are not read).
  uint4 wq[TAPS];
#pragma unroll
  for (int k = 0; k < TAPS; ++k) wq[k] = load_slot<T, VEC>(w + (size_t)k * D + d0, left);
  uint4 xq[HALO + ROWS];
#pragma unroll
  for (int i = 0; i < HALO + ROWS; ++i) {
    const int t = t0 - HALO + i;
    xq[i] = t >= 0 && t < Tn ? load_slot<T, VEC>(x + base + (size_t)t * D, left)
                             : make_uint4(0, 0, 0, 0);
  }

  // Each weight and each row converted to f32 once: at row t, win[k] holds
  // row t - k (before the first row's shift, row t0 - 1 - k).
  float wf[TAPS][V], win[TAPS][V];
#pragma unroll
  for (int k = 0; k < TAPS; ++k)
#pragma unroll
    for (int c = 0; c < V; ++c) {
      wf[k][c] = Slot<T>::chan(wq[k], c);
      win[k][c] = k < HALO ? Slot<T>::chan(xq[HALO - 1 - k], c) : 0.f;
    }
#pragma unroll
  for (int j = 0; j < ROWS; ++j) {
    if (t0 + j >= Tn) break;
    float acc[V];
#pragma unroll
    for (int c = 0; c < V; ++c) {
#pragma unroll
      for (int k = TAPS - 1; k > 0; --k) win[k][c] = win[k - 1][c];
      win[0][c] = Slot<T>::chan(xq[HALO + j], c);
      acc[c] = __fmul_rn(wf[0][c], win[0][c]);
#pragma unroll
      for (int k = 1; k < TAPS; ++k) acc[c] = __fadd_rn(acc[c], __fmul_rn(wf[k][c], win[k][c]));
    }
    store_slot<T, VEC>(out + base + (size_t)(t0 + j) * D, acc, left);
  }
}

template <typename T, int TAPS, int ROWS>
int launch_rows(const T* x, const T* w, T* out, int B, int Tn, int D, bool vec,
                cudaStream_t stream) {
  constexpr int V = Slot<T>::V;
  dim3 grid((D + V * NT - 1) / (V * NT), (Tn + ROWS - 1) / ROWS, B);
  if (vec)
    token_shift_kernel<T, TAPS, ROWS, true><<<grid, NT, 0, stream>>>(x, w, out, Tn, D);
  else
    token_shift_kernel<T, TAPS, ROWS, false><<<grid, NT, 0, stream>>>(x, w, out, Tn, D);
  return (int)cudaGetLastError();
}

// ROWS: the most rows a thread (8 or 4) that still gives every SM FILL
// blocks, else 1.
template <typename T, int TAPS>
int launch_taps(const T* x, const T* w, T* out, int B, int Tn, int D, bool vec, int sms,
                cudaStream_t stream) {
  constexpr int V = Slot<T>::V;
  const long slots = (long)B * ((D + V * NT - 1) / (V * NT));
  if (slots * ((Tn + 7) / 8) >= (long)FILL * sms)
    return launch_rows<T, TAPS, 8>(x, w, out, B, Tn, D, vec, stream);
  if (slots * ((Tn + 3) / 4) >= (long)FILL * sms)
    return launch_rows<T, TAPS, 4>(x, w, out, B, Tn, D, vec, stream);
  return launch_rows<T, TAPS, 1>(x, w, out, B, Tn, D, vec, stream);
}

template <typename T>
int launch(const void* xv, const void* wv, void* outv, int B, int Tn, int D, int taps,
           cudaStream_t stream) {
  constexpr int V = Slot<T>::V;
  const T* x = static_cast<const T*>(xv);
  const T* w = static_cast<const T*>(wv);
  T* out = static_cast<T*>(outv);
  const bool vec = D % V == 0 && !((reinterpret_cast<uintptr_t>(x) |
                                    reinterpret_cast<uintptr_t>(w) |
                                    reinterpret_cast<uintptr_t>(out)) & 15);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  switch (taps) {
    case 2: return launch_taps<T, 2>(x, w, out, B, Tn, D, vec, sms, stream);
    case 3: return launch_taps<T, 3>(x, w, out, B, Tn, D, vec, sms, stream);
    case 4: return launch_taps<T, 4>(x, w, out, B, Tn, D, vec, sms, stream);
    case 5: return launch_taps<T, 5>(x, w, out, B, Tn, D, vec, sms, stream);
    case 6: return launch_taps<T, 6>(x, w, out, B, Tn, D, vec, sms, stream);
    case 7: return launch_taps<T, 7>(x, w, out, B, Tn, D, vec, sms, stream);
    case 8: return launch_taps<T, 8>(x, w, out, B, Tn, D, vec, sms, stream);
  }
  return (int)cudaErrorInvalidValue;
}


// ---------------------------------------------------------------------------
// The backward
// ---------------------------------------------------------------------------
//
// token_shift_bwd replaces no TPU kernel (the Pallas package has no
// backward for the conv): from the output cotangent dout,
//   dx[b, t, d] = sum_k w[k, d] dout[b, t + k, d]      (dout[t >= T] = 0),
//   dw[k, d] = sum_{b, t} dout[b, t, d] x[b, t - k, d],
// the same taps run anti-causally for dx and a tap-by-channel reduction for
// dw.  What bounds it: bytes (x and dout read, dx written: 126 MB at B=1,
// T=4096, D=2560 in f32, 38 us at 3.35 TB/s).  A block of BWD_NT threads
// owns BWD_NT neighbouring channels (a thread one, so a warp's row accesses
// are one coalesced segment) of a tile of BWD_TILE rows of one batch row;
// a thread loads BWD_SUB rows of dout and of x with their halos at once,
// then writes dx for them (tap 0 first, each product rounded before it is
// added, as the plain version ref.py:token_shift_bwd_ref, so f32 dx equals
// it bit for bit) and adds their products into its f32 dw partial, rows in
// order.  Each block writes its partial for its channels into a scratch of
// (B * tiles, taps, D) f32 that the wrapper allocates; a second kernel
// sums the partials in block order, so dw does not change from run to run
// (no atomics), and rounds it once to w's dtype.

constexpr int BWD_NT = 128;         // threads of a backward block, a channel each
constexpr int BWD_SUB = 16;         // rows a thread loads at once
constexpr int BWD_TILE = 128;       // rows of a block (one dw partial)

__device__ __forceinline__ float bwd_ld(const float* p) { return *p; }
__device__ __forceinline__ float bwd_ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void bwd_st(float* p, float v) { *p = v; }
__device__ __forceinline__ void bwd_st(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T, int TAPS>
__global__ void __launch_bounds__(BWD_NT) token_shift_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ dout,
    T* __restrict__ dx, float* __restrict__ part, int Tn, int D) {
  constexpr int HALO = TAPS - 1;
  const int d = blockIdx.x * BWD_NT + threadIdx.x;
  if (d >= D) return;
  const size_t base = (size_t)blockIdx.z * Tn * D + d;
  float wf[TAPS], dwp[TAPS];
#pragma unroll
  for (int k = 0; k < TAPS; ++k) {
    wf[k] = bwd_ld(w + (size_t)k * D + d);
    dwp[k] = 0.f;
  }
  const int t_begin = blockIdx.y * BWD_TILE, t_end = min(Tn, t_begin + BWD_TILE);
  for (int s0 = t_begin; s0 < t_end; s0 += BWD_SUB) {
    // go[i]: dout row s0 + i (zero past T); xs[i]: x row s0 - HALO + i (zero
    // before 0).
    float go[BWD_SUB + HALO], xs[BWD_SUB + HALO];
#pragma unroll
    for (int i = 0; i < BWD_SUB + HALO; ++i) {
      const int t = s0 + i, tx = s0 - HALO + i;
      go[i] = t < Tn ? bwd_ld(dout + base + (size_t)t * D) : 0.f;
      xs[i] = tx >= 0 && tx < Tn ? bwd_ld(x + base + (size_t)tx * D) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < BWD_SUB; ++j) {
      const int t = s0 + j;
      if (t >= t_end) break;
      float acc = __fmul_rn(wf[0], go[j]);
#pragma unroll
      for (int k = 1; k < TAPS; ++k) acc = __fadd_rn(acc, __fmul_rn(wf[k], go[j + k]));
      bwd_st(dx + base + (size_t)t * D, acc);
#pragma unroll
      for (int k = 0; k < TAPS; ++k) dwp[k] = __fadd_rn(dwp[k], __fmul_rn(go[j], xs[j + HALO - k]));
    }
  }
  const size_t p = (size_t)blockIdx.z * gridDim.y + blockIdx.y;
#pragma unroll
  for (int k = 0; k < TAPS; ++k) part[(p * TAPS + k) * D + d] = dwp[k];
}

// dw[i] = the sum of the `parts` partials of entry i (taps * D entries), in
// block order.
template <typename T>
__global__ void __launch_bounds__(BWD_NT) token_shift_dw_kernel(const float* __restrict__ part,
                                                                T* __restrict__ dw, int parts,
                                                                int n) {
  const int i = blockIdx.x * BWD_NT + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int p = 0; p < parts; ++p) s = __fadd_rn(s, part[(size_t)p * n + i]);
  bwd_st(dw + i, s);
}

template <typename T, int TAPS>
int launch_bwd_taps(const T* x, const T* w, const T* dout, T* dx, float* part, T* dw, int B,
                    int Tn, int D, cudaStream_t stream) {
  const int tiles = (Tn + BWD_TILE - 1) / BWD_TILE;
  dim3 grid((D + BWD_NT - 1) / BWD_NT, tiles, B);
  token_shift_bwd_kernel<T, TAPS><<<grid, BWD_NT, 0, stream>>>(x, w, dout, dx, part, Tn, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = TAPS * D;
  token_shift_dw_kernel<T><<<(n + BWD_NT - 1) / BWD_NT, BWD_NT, 0, stream>>>(part, dw, B * tiles,
                                                                            n);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* xv, const void* wv, const void* dov, void* dxv, float* part, void* dwv,
               int B, int Tn, int D, int taps, cudaStream_t s) {
  const T* x = static_cast<const T*>(xv);
  const T* w = static_cast<const T*>(wv);
  const T* dout = static_cast<const T*>(dov);
  T* dx = static_cast<T*>(dxv);
  T* dw = static_cast<T*>(dwv);
  switch (taps) {
    case 2: return launch_bwd_taps<T, 2>(x, w, dout, dx, part, dw, B, Tn, D, s);
    case 3: return launch_bwd_taps<T, 3>(x, w, dout, dx, part, dw, B, Tn, D, s);
    case 4: return launch_bwd_taps<T, 4>(x, w, dout, dx, part, dw, B, Tn, D, s);
    case 5: return launch_bwd_taps<T, 5>(x, w, dout, dx, part, dw, B, Tn, D, s);
    case 6: return launch_bwd_taps<T, 6>(x, w, dout, dx, part, dw, B, Tn, D, s);
    case 7: return launch_bwd_taps<T, 7>(x, w, dout, dx, part, dw, B, Tn, D, s);
    case 8: return launch_bwd_taps<T, 8>(x, w, dout, dx, part, dw, B, Tn, D, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w and out alike).
// Returns 0 or the cudaError_t of the launch.
extern "C" int token_shift_fwd(const void* x, const void* w, void* out, int B,
                               int Tn, int D, int taps, int dtype, void* stream) {
  // The grid's y (at most 65535) counts tiles of 8 rows: the fewer rows a
  // thread come only with grids of fewer than FILL blocks an SM.
  if (B < 1 || B > 65535 || Tn < 1 || (Tn + 7) / 8 > 65535 || D < 1 ||
      taps < 2 || taps > MAX_TAPS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, w, out, B, Tn, D, taps, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, w, out, B, Tn, D, taps, s);
  return (int)cudaErrorInvalidValue;
}

// The backward: x, w, dout, dx, dw of one dtype (0 = float32, 1 = bfloat16),
// x, dout, dx (B, T, D), w, dw (taps, D); part: f32 scratch of (B *
// ceil(T / 128), taps, D), every entry written before it is read.  Returns 0
// or the cudaError_t of the first launch that failed.
extern "C" int token_shift_bwd(const void* x, const void* w, const void* dout, void* dx,
                               float* part, void* dw, int B, int Tn, int D, int taps, int dtype,
                               void* stream) {
  if (B < 1 || B > 65535 || Tn < 1 || (Tn + BWD_TILE - 1) / BWD_TILE > 65535 || D < 1 ||
      taps < 2 || taps > MAX_TAPS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_bwd<float>(x, w, dout, dx, part, dw, B, Tn, D, taps, s);
  if (dtype == 1) return launch_bwd<__nv_bfloat16>(x, w, dout, dx, part, dw, B, Tn, D, taps, s);
  return (int)cudaErrorInvalidValue;
}
