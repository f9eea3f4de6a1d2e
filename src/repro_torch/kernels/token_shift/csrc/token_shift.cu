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

#include "sm90.cuh"

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

// The rows a thread of the forward takes: the most (8 or 4) that still
// gives every SM FILL blocks, else 1 (v channels a slot).
inline int fwd_rows(int B, int Tn, int D, int v, int sms) {
  const long slots = (long)B * ((D + v * NT - 1) / (v * NT));
  if (slots * ((Tn + 7) / 8) >= (long)FILL * sms) return 8;
  if (slots * ((Tn + 3) / 4) >= (long)FILL * sms) return 4;
  return 1;
}

template <typename T, int TAPS>
int launch_taps(const T* x, const T* w, T* out, int B, int Tn, int D, bool vec, int sms,
                cudaStream_t stream) {
  switch (fwd_rows(B, Tn, D, Slot<T>::V, sms)) {
    case 8: return launch_rows<T, TAPS, 8>(x, w, out, B, Tn, D, vec, stream);
    case 4: return launch_rows<T, TAPS, 4>(x, w, out, B, Tn, D, vec, stream);
    default: return launch_rows<T, TAPS, 1>(x, w, out, B, Tn, D, vec, stream);
  }
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
// dw.  What bounds it: bytes (x and dout read, dx written: 62.9 MB at B=1,
// T=4096, D=2560 in bf16, 18.8 us at 3.35 TB/s; dw is taps rows of D).
//
// One launch.  A thread owns the forward's 16-byte slot (8 bf16 or 4 f32
// channels) of a unit of `rows` consecutive rows of one batch row, and
// walks them in sub-tiles of bwd_sub rows through its own ring of
// BWD_STAGES sub-tiles in shared memory: BWD_STAGES - 1 sub-tiles of dout
// and x are in flight while it computes one, filled by 16-byte cp.async
// copies (zero-filled past T) at no register cost; a slot is refilled only
// after the thread itself has read it.  Where D is not a multiple of the
// slot or a pointer is off the 16-byte grid, the scalar variant fills the
// same ring with scalar loads.  The taps - 1 rows of dout and x that the
// next sub-tile needs stay in registers, so within a unit every row is read
// once.  A block is `cols` slot columns (128 bytes of a row at 8) by
// `groups` row lanes; the grid's y is one thread-block cluster of `cluster`
// blocks, whose cluster * groups lanes take the B * ceil(T / rows) units of
// the block's channels in turn, so one cluster covers every row of its
// channels.  dx: tap 0 first, each product rounded
// before it is added (__fmul_rn then __fadd_rn), the order of the plain
// version ref.py:token_shift_bwd_ref, so f32 and bf16 dx equal it bit for
// bit.  dw: each thread sums its rows' products in f32 in row order; the
// block sums its lanes' partials in lane order through shared memory, and
// the cluster its blocks' in rank order through distributed shared memory,
// each rank a slice of the taps x channels, rounded once to w's dtype.  The
// order is fixed by the plan alone, so dw repeats bit for bit, with no
// atomics and no second launch.  The pure-Python planner
// kernels/token_shift/kernel.py:plan_shift_bwd picks cols, groups, cluster
// and rows.  (A variant that kept the next sub-tile in flight in registers
// instead of the ring ran slower in every plan at both of RecurrentGemma's
// training shapes: PERF.md, PR 27.)

constexpr int BWD_THREADS = 128;     // threads of a block at most (cols * groups)
constexpr int BWD_MAX_COLS = 8;      // slot columns of a block at most
constexpr int BWD_MAX_CLUSTER = 8;   // blocks of a cluster at most (the portable size)
constexpr int BWD_STAGES = 3;        // sub-tiles of a thread's ring

// Rows of a sub-tile: 8, fewer past 4 taps, whose weights, partials and
// windows take the registers (1 row for the f32 sums of 8 bf16 channels a
// tap: at 2 rows 6 taps spill).
__host__ __device__ constexpr int bwd_sub(int taps, int v) {
  return taps <= 4 ? 8 : v == 4 ? 2 : 1;
}

// Shared memory of a block: the threads' rings (16 bytes of dout and of x a
// row), which the lanes' dw partials and the block's sum reuse at the end.
__host__ __device__ constexpr int bwd_smem_bytes(int groups, int taps, int cols, int v) {
  const int ring = BWD_STAGES * bwd_sub(taps, v) * 32 * cols * groups;
  const int sums = (groups + 1) * taps * cols * v * 4;
  return ring > sums ? ring : sums;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(live ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows s .. s + SUB - 1 of a unit ending at t1 into ring slot `slot` of
// this thread: x rows s + j and dout rows s + j + HALO (zero past T, and
// for rows past the unit); row j of tensor k at ((slot * SUB + j) * 2 + k)
// * threads + thread, 16 bytes each.
template <typename T, bool VEC, int HALO, int SUB>
__device__ __forceinline__ void bwd_fill(uint4* ring, int slot, const T* x, const T* dout,
                                         size_t base, int s, int t1, int Tn, int D, int left) {
  uint4* at = ring + (size_t)slot * SUB * 2 * blockDim.x;
  if constexpr (VEC) {
#pragma unroll
    for (int j = 0; j < SUB; ++j) {
      const int t = s + j;
      const bool gl = t < t1 && t + HALO < Tn, xl = t < t1;
      const uint32_t dst = sm90::smem_u32(at + 2 * j * blockDim.x);
      cp_async16(dst, gl ? dout + base + (size_t)(t + HALO) * D : dout, gl);
      cp_async16(dst + blockDim.x * 16, xl ? x + base + (size_t)t * D : x, xl);
    }
  } else {
    uint4 g[SUB], xr[SUB];
#pragma unroll
    for (int j = 0; j < SUB; ++j) {
      const int t = s + j;
      g[j] = t < t1 && t + HALO < Tn
                 ? load_slot<T, false>(dout + base + (size_t)(t + HALO) * D, left)
                 : make_uint4(0, 0, 0, 0);
      xr[j] = t < t1 ? load_slot<T, false>(x + base + (size_t)t * D, left)
                     : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int j = 0; j < SUB; ++j) {
      at[2 * j * blockDim.x] = g[j];
      at[(2 * j + 1) * blockDim.x] = xr[j];
    }
  }
}

// The sub-tile at row s, from ring slot `slot`: dx of its rows before t1,
// their products added to the dw partial, and the windows moved on.  gw[k]
// holds dout row s + k, xw[k] x row s - HALO + k.
template <typename T, bool VEC, int TAPS, int SUB>
__device__ __forceinline__ void bwd_rows(const uint4* ring, int slot, uint4 (&gw)[TAPS - 1],
                                         uint4 (&xw)[TAPS - 1],
                                         const float (&wf)[TAPS][Slot<T>::V],
                                         float (&dwp)[TAPS][Slot<T>::V], T* dx, size_t base,
                                         int s, int t1, int D, int left) {
  using S = Slot<T>;
  constexpr int V = S::V, HALO = TAPS - 1;
  const uint4* at = ring + (size_t)slot * SUB * 2 * blockDim.x;
  // G[i]: dout row s + i; X[i]: x row s - HALO + i.
  float G[HALO + SUB][V], X[HALO + SUB][V];
#pragma unroll
  for (int j = 0; j < SUB; ++j) {
    const uint4 g = at[2 * j * blockDim.x], xr = at[(2 * j + 1) * blockDim.x];
#pragma unroll
    for (int c = 0; c < V; ++c) {
      G[HALO + j][c] = S::chan(g, c);
      X[HALO + j][c] = S::chan(xr, c);
    }
  }
#pragma unroll
  for (int k = 0; k < HALO; ++k)
#pragma unroll
    for (int c = 0; c < V; ++c) {
      G[k][c] = S::chan(gw[k], c);
      X[k][c] = S::chan(xw[k], c);
    }
  // The next sub-tile's windows, before the rows' arithmetic.
#pragma unroll
  for (int k = 0; k < HALO; ++k) {
    gw[k] = SUB + k < HALO ? gw[SUB + k] : at[2 * (SUB + k - HALO) * blockDim.x];
    xw[k] = SUB + k < HALO ? xw[SUB + k] : at[(2 * (SUB + k - HALO) + 1) * blockDim.x];
  }
#pragma unroll
  for (int j = 0; j < SUB; ++j) {
    if (s + j >= t1) break;
    float acc[V];
#pragma unroll
    for (int c = 0; c < V; ++c) {
      acc[c] = __fmul_rn(wf[0][c], G[j][c]);
#pragma unroll
      for (int k = 1; k < TAPS; ++k) acc[c] = __fadd_rn(acc[c], __fmul_rn(wf[k][c], G[j + k][c]));
    }
    store_slot<T, VEC>(dx + base + (size_t)(s + j) * D, acc, left);
#pragma unroll
    for (int k = 0; k < TAPS; ++k)
#pragma unroll
      for (int c = 0; c < V; ++c) dwp[k][c] = __fmaf_rn(G[j][c], X[HALO + j - k][c], dwp[k][c]);
  }
}

template <typename T, int TAPS, bool VEC>
__global__ void __launch_bounds__(BWD_THREADS) token_shift_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ dout,
    T* __restrict__ dx, T* __restrict__ dw, int B, int Tn, int D, int cols, int rows) {
  using S = Slot<T>;
  constexpr int V = S::V, HALO = TAPS - 1, SUB = bwd_sub(TAPS, V);
  extern __shared__ __align__(16) float red[];
  const int groups = blockDim.x / cols, wide = cols * V;   // channels of the block
  const int col = threadIdx.x % cols, lane = threadIdx.x / cols;
  const int d0 = (blockIdx.x * cols + col) * V;
  const int left = D - d0;
  const int rank = (int)sm90::cluster_ctarank(), nrank = gridDim.y;

  float dwp[TAPS][V];
#pragma unroll
  for (int k = 0; k < TAPS; ++k)
#pragma unroll
    for (int c = 0; c < V; ++c) dwp[k][c] = 0.f;
  if (d0 < D) {
    float wf[TAPS][V];
#pragma unroll
    for (int k = 0; k < TAPS; ++k) {
      const uint4 q = load_slot<T, VEC>(w + (size_t)k * D + d0, left);
#pragma unroll
      for (int c = 0; c < V; ++c) wf[k][c] = S::chan(q, c);
    }
    const int per_batch = (Tn + rows - 1) / rows;
    const long units = (long)B * per_batch;
    uint4* ring = reinterpret_cast<uint4*>(red) + threadIdx.x;
    for (long u = (long)rank * groups + lane; u < units; u += (long)nrank * groups) {
      const int b = (int)(u / per_batch), t0 = (int)(u % per_batch) * rows;
      const int t1 = min(Tn, t0 + rows);
      const size_t base = (size_t)b * Tn * D + d0;
      uint4 gw[HALO], xw[HALO];
#pragma unroll
      for (int k = 0; k < HALO; ++k) {
        gw[k] = t0 + k < Tn ? load_slot<T, VEC>(dout + base + (size_t)(t0 + k) * D, left)
                            : make_uint4(0, 0, 0, 0);
        xw[k] = t0 - HALO + k >= 0
                    ? load_slot<T, VEC>(x + base + (size_t)(t0 - HALO + k) * D, left)
                    : make_uint4(0, 0, 0, 0);
      }
      const int nsub = (t1 - t0 + SUB - 1) / SUB;
#pragma unroll
      for (int i = 0; i < BWD_STAGES - 1; ++i) {
        if (i < nsub)
          bwd_fill<T, VEC, HALO, SUB>(ring, i, x, dout, base, t0 + i * SUB, t1, Tn, D, left);
        cp_async_commit();
      }
      // Sub-tile i + BWD_STAGES - 1 goes into the slot that sub-tile i - 1
      // left, which this thread has read.
      for (int i = 0; i < nsub; ++i) {
        const int ahead = i + BWD_STAGES - 1;
        if (ahead < nsub)
          bwd_fill<T, VEC, HALO, SUB>(ring, ahead % BWD_STAGES, x, dout, base, t0 + ahead * SUB,
                                      t1, Tn, D, left);
        cp_async_commit();
        cp_async_wait<BWD_STAGES - 1>();
        bwd_rows<T, VEC, TAPS, SUB>(ring, i % BWD_STAGES, gw, xw, wf, dwp, dx, base,
                                    t0 + i * SUB, t1, D, left);
      }
      cp_async_wait<0>();
    }
  }

  // dw: the lanes' partials, summed in lane order into the block's, over
  // the rings once every thread has left its own; the loads of four lanes
  // are issued before their adds.
  __syncthreads();
  float* part = red;                               // [groups][TAPS][wide]
  float* blk = red + groups * TAPS * wide;         // [TAPS][wide]
#pragma unroll
  for (int k = 0; k < TAPS; ++k)
#pragma unroll
    for (int c = 0; c < V; ++c) part[(lane * TAPS + k) * wide + col * V + c] = dwp[k][c];
  __syncthreads();
  const int n = TAPS * wide;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    float acc = part[e];
    for (int g0 = 1; g0 < groups; g0 += 4) {
      float v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = g0 + i < groups ? part[(g0 + i) * n + e] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (g0 + i < groups) acc = __fadd_rn(acc, v[i]);
    }
    blk[e] = acc;
  }
  // The cluster's blocks in rank order: rank r sums its slice of the taps x
  // channels over every rank's block sum, then rounds it once.
  sm90::cluster_arrive();
  sm90::cluster_wait();
  const int per = (n + nrank - 1) / nrank, e1 = min(n, (rank + 1) * per);
  const uint32_t at = sm90::smem_u32(blk);
  for (int e = rank * per + threadIdx.x; e < e1; e += blockDim.x) {
    float acc = sm90::ld_cluster_f32(sm90::mapa(at + 4 * e, 0));
    for (int r = 1; r < nrank; ++r)
      acc = __fadd_rn(acc, sm90::ld_cluster_f32(sm90::mapa(at + 4 * e, r)));
    const int k = e / wide, d = blockIdx.x * wide + e % wide;
    if (d < D) S::put(dw + (size_t)k * D + d, acc);
  }
  // No block leaves while another rank may still read its sum.
  sm90::cluster_arrive();
  sm90::cluster_wait();
}

template <typename T, int TAPS>
int launch_bwd_taps(const T* x, const T* w, const T* dout, T* dx, T* dw, int B, int Tn, int D,
                    int cols, int groups, int cluster, int rows, bool vec, cudaStream_t stream) {
  constexpr int V = Slot<T>::V;
  const void* kernel = vec ? reinterpret_cast<const void*>(token_shift_bwd_kernel<T, TAPS, true>)
                           : reinterpret_cast<const void*>(token_shift_bwd_kernel<T, TAPS, false>);
  const int smem = bwd_smem_bytes(groups, TAPS, cols, V);
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int slots = (D + V - 1) / V;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((slots + cols - 1) / cols, cluster, 1);
  cfg.blockDim = dim3(cols * groups, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = cluster;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  void* args[] = {&x, &w, &dout, &dx, &dw, &B, &Tn, &D, &cols, &rows};
  return (int)cudaLaunchKernelExC(&cfg, kernel, args);
}

template <typename T>
int launch_bwd(const void* xv, const void* wv, const void* dov, void* dxv, void* dwv, int B,
               int Tn, int D, int taps, int cols, int groups, int cluster, int rows, int vec,
               cudaStream_t s) {
  constexpr int V = Slot<T>::V;
  const T* x = static_cast<const T*>(xv);
  const T* w = static_cast<const T*>(wv);
  const T* dout = static_cast<const T*>(dov);
  T* dx = static_cast<T*>(dxv);
  T* dw = static_cast<T*>(dwv);
  // The 16-byte variant only where every row and pointer is on the 16-byte
  // grid: the plan must agree, or the launch is refused.
  const bool aligned = D % V == 0 && !((reinterpret_cast<uintptr_t>(x) |
                                        reinterpret_cast<uintptr_t>(w) |
                                        reinterpret_cast<uintptr_t>(dout) |
                                        reinterpret_cast<uintptr_t>(dx) |
                                        reinterpret_cast<uintptr_t>(dw)) & 15);
  if (vec && !aligned) return (int)cudaErrorMisalignedAddress;
  switch (taps) {
#define TS_BWD_TAPS(K)                                                                      \
  case K:                                                                                   \
    return launch_bwd_taps<T, K>(x, w, dout, dx, dw, B, Tn, D, cols, groups, cluster, rows, \
                                 vec, s);
    TS_BWD_TAPS(2) TS_BWD_TAPS(3) TS_BWD_TAPS(4) TS_BWD_TAPS(5) TS_BWD_TAPS(6)
    TS_BWD_TAPS(7) TS_BWD_TAPS(8)
#undef TS_BWD_TAPS
  }
  return (int)cudaErrorInvalidValue;
}

// Blocks an SM of an instantiation with a launch's block and dynamic shared
// memory, opted in as the launchers do; or minus a cudaError_t.
int blocks_per_sm(const void* kernel, int threads, int smem) {
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int n = 0;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, smem);
  return e == cudaSuccess ? n : -(int)e;
}

template <typename T, int TAPS>
int fwd_occupancy(int rows, bool vec) {
  const void* k = nullptr;
  if (rows == 8) k = vec ? (const void*)token_shift_kernel<T, TAPS, 8, true> : (const void*)token_shift_kernel<T, TAPS, 8, false>;
  if (rows == 4) k = vec ? (const void*)token_shift_kernel<T, TAPS, 4, true> : (const void*)token_shift_kernel<T, TAPS, 4, false>;
  if (rows == 1) k = vec ? (const void*)token_shift_kernel<T, TAPS, 1, true> : (const void*)token_shift_kernel<T, TAPS, 1, false>;
  return k == nullptr ? -(int)cudaErrorInvalidValue : blocks_per_sm(k, NT, 0);
}

template <typename T, int TAPS>
int bwd_occupancy(int groups, int cols, bool vec) {
  const void* k = vec ? (const void*)token_shift_bwd_kernel<T, TAPS, true>
                      : (const void*)token_shift_bwd_kernel<T, TAPS, false>;
  return blocks_per_sm(k, cols * groups, bwd_smem_bytes(groups, TAPS, cols, Slot<T>::V));
}

// kernel 0: the forward at `rows` rows a thread (a = rows); kernel 1: the
// backward (a = groups, b = cols).
template <typename T>
int occupancy(int kernel, int taps, int a, int b, bool vec) {
  switch (taps) {
#define TS_OCC(K)                                                                   \
  case K:                                                                           \
    return kernel == 0 ? fwd_occupancy<T, K>(a, vec) : bwd_occupancy<T, K>(a, b, vec);
    TS_OCC(2) TS_OCC(3) TS_OCC(4) TS_OCC(5) TS_OCC(6) TS_OCC(7) TS_OCC(8)
#undef TS_OCC
  }
  return -(int)cudaErrorInvalidValue;
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
// x, dout, dx (B, T, D), w, dw (taps, D), one launch of the plan's cols,
// groups, cluster, rows a unit and variant (vec: 1 the 16-byte copies,
// refused with cudaErrorMisalignedAddress unless D is a multiple of the
// slot and every pointer 16-byte aligned; 0 the scalar loads).  Returns 0
// or the cudaError_t of the launch.
extern "C" int token_shift_bwd(const void* x, const void* w, const void* dout, void* dx,
                               void* dw, int B, int Tn, int D, int taps, int dtype, int cols,
                               int groups, int cluster, int rows, int vec, void* stream) {
  if (B < 1 || Tn < 1 || D < 1 || taps < 2 || taps > MAX_TAPS || cols < 1 ||
      cols > BWD_MAX_COLS || groups < 1 || cols * groups > BWD_THREADS || cluster < 1 ||
      cluster > BWD_MAX_CLUSTER || rows < 1 || (vec != 0 && vec != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<float>(x, w, dout, dx, dw, B, Tn, D, taps, cols, groups, cluster, rows,
                             vec, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(x, w, dout, dx, dw, B, Tn, D, taps, cols, groups, cluster,
                                     rows, vec, s);
  return (int)cudaErrorInvalidValue;
}

// The backward's dynamic shared memory a block, in bytes, for a plan's
// groups and cols (the mirror kernel.py:bwd_smem_bytes must agree).
extern "C" int token_shift_bwd_smem(int groups, int taps, int cols, int dtype) {
  return bwd_smem_bytes(groups, taps, cols, dtype == 0 ? 4 : 8);
}

// The rows a thread the forward launches with for (B, T, D) of dtype on a
// card of `sms` SMs: fwd_rows, the launcher's own rule (the mirror,
// token_shift/kernel.py:fwd_rows).
extern "C" int token_shift_fwd_rows(int B, int Tn, int D, int dtype, int sms) {
  return fwd_rows(B, Tn, D, dtype == 0 ? 4 : 8, sms);
}

// The library's launch query: blocks an SM from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor on the instantiation a
// launch takes, with its dynamic shared memory, or minus a cudaError_t.
//   kernel 0, the forward: p0 taps, p1 dtype, p2 rows a thread, p3 vec;
//   kernel 1, the backward: p0 taps, p1 dtype, p2 groups, p3 cols, p4 vec.
extern "C" int token_shift_occupancy(int kernel, int p0, int p1, int p2, int p3, int p4) {
  if (kernel != 0 && kernel != 1) return -(int)cudaErrorInvalidValue;
  const bool vec = (kernel == 0 ? p3 : p4) != 0;
  if (p1 == 0) return occupancy<float>(kernel, p0, p2, p3, vec);
  if (p1 == 1) return occupancy<__nv_bfloat16>(kernel, p0, p2, p3, vec);
  return -(int)cudaErrorInvalidValue;
}
