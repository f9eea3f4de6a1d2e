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
// What sets a single step's time is one round trip to device memory after
// the launch; what sets a window's is the instructions of its K tokens,
// which the warps of a (batch, head) issue one token after another.
//
// Design: a block owns one (batch, head) and `col_tile` of its 64 value
// columns; the grid is (B*H, 64 / col_tile), the tile chosen by the
// pure-Python plan kernels/wkv/decode.py:plan_decode_columns.
// 1. Staging, one round trip: at entry one thread puts 1-D bulk copies (TMA)
//    of the block's whole (b, h) slabs of r, k, w and v (K x 64 contiguous
//    elements each) and of u[h] in flight to shared memory on one mbarrier,
//    while every thread loads its 16 state values (8 rows x 2 columns, in
//    8-byte loads) straight into registers.
// 2. The state-free pass: bf16 slabs widened to f32 once for the whole
//    block, and the K bonuses r_t . u . k_t, each summed by 8 lanes over 8
//    terms and a 3-level shuffle tree.
// 3. The carry loop, with no block barrier: each warp owns 8 whole value
//    columns, all 64 rows of each (lane = 8-row group x 2-column pair), so
//    the column sum o = r @ S reduces inside the warp.  Per token a lane
//    reads only the token's shared f32 r/k/w rows and v columns and its own
//    registers, and carries S on; the partial sums of 8 tokens then reduce
//    together, by a shuffle butterfly whose every level halves the values a
//    lane carries, so the shuffles of a batch overlap instead of each
//    token's waiting on the last.  out leaves by fire-and-forget stores, S
//    by 8-byte stores after the window.
// Every sum runs in an order fixed by the warp's lane layout, never by the
// block's warp count or the token's place in the window, and the arithmetic
// is written with explicit rounding intrinsics (no contraction left to the
// compiler): outputs are bit-equal across plans, and a window is
// bit-identical to K chained single steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

#include "sm90.cuh"

namespace {

constexpr int DH = 64;              // key/value width of one WKV head
constexpr int WARP_COLS = 8;        // value columns of one warp
constexpr int LANE_ROWS = 8;        // state rows of one lane (8 row groups)
constexpr int NB_WINDOW = 8;        // tokens of a window whose sums reduce together
constexpr int MAX_WINDOW = 64;
constexpr int MAX_THREADS = 32 * DH / WARP_COLS;   // a block of all 64 columns
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ constexpr int up128(int x) { return (x + 127) / 128 * 128; }

// Shared memory, 128-byte aligned regions: the staging mbarrier, the K
// bonuses, u[h] and the r | k | w | v slabs (K x 64 each) as the bulk copies
// land them (`item` bytes an element), then, for bf16 inputs, the same
// slabs widened to f32 (for f32 inputs the landed slabs serve).
struct Layout {
  int bonus, u, slabs, wide, total;
};

__host__ __device__ constexpr Layout layout(int K, int item) {
  return Layout{128, 128 + up128(4 * K), 128 + up128(4 * K) + up128(DH * item),
                item == 4 ? 128 + up128(4 * K) + up128(DH * item)
                          : 128 + up128(4 * K) + up128(DH * item) + 4 * K * DH * item,
                128 + up128(4 * K) + up128(DH * item) + 4 * K * DH * item +
                    (item == 4 ? 0 : 4 * K * DH * 4)};
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Two consecutive outputs, in one store.
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ float lo_bf16(uint32_t q) { return __uint_as_float(q << 16); }
__device__ __forceinline__ float hi_bf16(uint32_t q) { return __uint_as_float(q & 0xffff0000u); }

// Eight consecutive elements of shared memory, as f32.
__device__ __forceinline__ void ld8(const float* p, float (&x)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void ld8(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = lo_bf16(w[i]);
    x[2 * i + 1] = hi_bf16(w[i]);
  }
}

// One level of the batched butterfly: of the 2N values in x[0 .. 2N), the
// lane keeps the half its `bit` names (the upper one if set), adds the same
// half from the lane `XOR` away (which hands over the other), and leaves the
// N sums in x[0 .. N).  With N = 0 the lane's one value x[0] is summed with
// its partner's.  Both partners add the same two values, each its own
// first: equal, as addition commutes.
template <int N, int XOR>
__device__ __forceinline__ void halve(float* x, int bit) {
  if constexpr (N == 0) {
    x[0] = __fadd_rn(x[0], __shfl_xor_sync(FULL, x[0], XOR));
    return;
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float keep = bit ? x[N + i] : x[i];
    const float give = bit ? x[i] : x[N + i];
    x[i] = __fadd_rn(keep, __shfl_xor_sync(FULL, give, XOR));
  }
}

// NB tokens from `base` (WHOLE: all of them inside the window, so the
// batch runs with no branch and its shared loads can go ahead together):
// each lane's partial column sums P[2 j + c] over its 8 rows (o = r @ S),
// then S' = w S + k v.  Tokens past the window leave S alone and add 0.
// s_f: the f32 r | k | w | v slabs.
template <int NB, bool WHOLE>
__device__ __forceinline__ void tokens(float (&P)[2 * NB], float (&S)[LANE_ROWS][2],
                                       const float* s_f, int slab, int base, int K,
                                       int row0, int c0) {
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const int t = base + j;
    if (!WHOLE && t >= K) {
      P[2 * j] = P[2 * j + 1] = 0.f;
      continue;
    }
    float rr[8], kk[8], ww[8];
    ld8(s_f + t * DH + row0, rr);
    ld8(s_f + slab + t * DH + row0, kk);
    ld8(s_f + 2 * slab + t * DH + row0, ww);
    const float2 v2 = *reinterpret_cast<const float2*>(s_f + 3 * slab + t * DH + c0);
    const float vv[2] = {v2.x, v2.y};
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float p = __fmul_rn(rr[0], S[0][c]);
#pragma unroll
      for (int m = 1; m < LANE_ROWS; ++m) p = __fmaf_rn(rr[m], S[m][c], p);
      P[2 * j + c] = p;
    }
#pragma unroll
    for (int m = 0; m < LANE_ROWS; ++m)
#pragma unroll
      for (int c = 0; c < 2; ++c) S[m][c] = __fmaf_rn(kk[m], vv[c], __fmul_rn(S[m][c], ww[m]));
  }
}

// NB: the tokens whose column sums reduce together (1 for a single step, 8
// for a window).  Both give every sum the same order, so a window stays
// bit-identical to chained single steps.
template <typename T, int NB>
__global__ void __launch_bounds__(MAX_THREADS) wkv_decode_kernel(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ w, const T* __restrict__ u, const float* h0,
    T* __restrict__ out, float* s_out, int H, int K, int col_tile) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout Y = layout(K, sizeof(T));
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* s_bonus = reinterpret_cast<float*>(smem + Y.bonus);
  const T* s_u = reinterpret_cast<const T*>(smem + Y.u);
  T* s_in = reinterpret_cast<T*>(smem + Y.slabs);        // r | k | w | v as landed
  float* s_f = reinterpret_cast<float*>(smem + Y.wide);  // the same in f32
  const int slab = K * DH;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int bh = blockIdx.x;                             // b * H + h

  // ---- 1. staging: the inputs by bulk copy, the state into registers ----
  if (tid == 0) {
    sm90::mbar_init(bar, 1);
    sm90::mbar_fence_init();
  }
  const int cp = lane & 3;            // the lane's 2-column pair
  const int rg = lane >> 2;           // the lane's 8-row group
  const int c0 = blockIdx.y * col_tile + warp * WARP_COLS + 2 * cp;
  const int row0 = LANE_ROWS * rg;
  const size_t st0 = (size_t)bh * DH * DH;
  float S[LANE_ROWS][2];
#pragma unroll
  for (int m = 0; m < LANE_ROWS; ++m) {
    const float2 s = *reinterpret_cast<const float2*>(h0 + st0 + (size_t)(row0 + m) * DH + c0);
    S[m][0] = s.x;
    S[m][1] = s.y;
  }
  __syncthreads();    // the barrier's initialisation is visible to every thread
  if (tid == 0) {
    const uint32_t bytes = slab * sizeof(T);
    const size_t at = (size_t)bh * slab;
    sm90::mbar_arrive_expect_tx(bar, 4 * bytes + DH * sizeof(T));
    sm90::bulk_load(s_in, r + at, bytes, bar);
    sm90::bulk_load(s_in + slab, k + at, bytes, bar);
    sm90::bulk_load(s_in + 2 * slab, w + at, bytes, bar);
    sm90::bulk_load(s_in + 3 * slab, v + at, bytes, bar);
    sm90::bulk_load(smem + Y.u, u + (size_t)(bh % H) * DH, DH * sizeof(T), bar);
  }
  sm90::mbar_wait(bar, 0);

  // ---- 2. the state-free pass: f32 slabs, and the bonuses r_t . u . k_t ---
  if constexpr (sizeof(T) == 2) {
    for (int i = 8 * tid; i < 4 * slab; i += 8 * blockDim.x) {
      float x[8];
      ld8(s_in + i, x);
      *reinterpret_cast<float4*>(s_f + i) = make_float4(x[0], x[1], x[2], x[3]);
      *reinterpret_cast<float4*>(s_f + i + 4) = make_float4(x[4], x[5], x[6], x[7]);
    }
  }
  {
    const int q = lane & 7;           // the lane's terms 8q .. 8q + 7
    float uu[8];
    ld8(s_u + 8 * q, uu);
    for (int base = 4 * warp; base < K; base += 4 * nwarps) {
      const int t = base + (lane >> 3);
      float a = 0.f;
      if (t < K) {
        float rr[8], kk[8];
        ld8(s_in + t * DH + 8 * q, rr);
        ld8(s_in + slab + t * DH + 8 * q, kk);
        a = __fmul_rn(__fmul_rn(rr[0], uu[0]), kk[0]);
#pragma unroll
        for (int i = 1; i < 8; ++i) a = __fmaf_rn(__fmul_rn(rr[i], uu[i]), kk[i], a);
      }
      a = __fadd_rn(a, __shfl_xor_sync(FULL, a, 4));
      a = __fadd_rn(a, __shfl_xor_sync(FULL, a, 2));
      a = __fadd_rn(a, __shfl_xor_sync(FULL, a, 1));
      if (q == 0 && t < K) s_bonus[t] = a;
    }
  }
  __syncthreads();

  // ---- 3. the carry loop: each warp alone, NB tokens at a time ------------
  // A lane's partial sums of the batch, P[2 j + c] for token j and column
  // c0 + c, reduce over the 8 row groups (lane bits 4, 3, 2, in this order
  // whatever NB): each level halves the values a lane carries, by the next
  // bit of 2 j + c, and adds its partner's half, until one is left.  With
  // NB = 8 a lane ends with two whole sums, token 4 b4 + 2 b3 + b2 of the
  // batch, columns c0 and c0 + 1; with NB = 1 with one, column c0 + b4,
  // which the lanes with b3 = b2 = 0 store.
  const int b4 = (lane >> 4) & 1, b3 = (lane >> 3) & 1, b2 = (lane >> 2) & 1;
  constexpr int NV = 2 * NB;          // values a lane carries into the butterfly
  T* o_bh = out + (size_t)bh * slab;
  const float* s_v = s_f + 3 * slab;
#pragma unroll 1
  for (int base = 0; base < K; base += NB) {
    float P[NV];
    if (base + NB <= K)
      tokens<NB, true>(P, S, s_f, slab, base, K, row0, c0);
    else
      tokens<NB, false>(P, S, s_f, slab, base, K, row0, c0);
    halve<NV / 2, 16>(P, b4);
    halve<NV / 4, 8>(P, b3);
    halve<NV / 8, 4>(P, b2);
    if constexpr (NB == 1) {
      if ((lane & 12) == 0)
        store(o_bh + c0 + b4, __fmaf_rn(s_bonus[0], s_v[c0 + b4], P[0]));
    } else {
      const int t = base + 4 * b4 + 2 * b3 + b2;
      if (t < K) {
        const float bonus = s_bonus[t];
        const float2 vo = *reinterpret_cast<const float2*>(s_v + t * DH + c0);
        store2(o_bh + t * DH + c0, __fmaf_rn(bonus, vo.x, P[0]), __fmaf_rn(bonus, vo.y, P[1]));
      }
    }
  }

#pragma unroll
  for (int m = 0; m < LANE_ROWS; ++m)
    *reinterpret_cast<float2*>(s_out + st0 + (size_t)(row0 + m) * DH + c0) =
        make_float2(S[m][0], S[m][1]);
}

template <typename T, int NB>
int launch_nb(const void* r, const void* k, const void* v, const void* w, const void* u,
              const void* h0, void* out, void* s_out, int B, int H, int K, int col_tile,
              cudaStream_t stream) {
  const int smem = layout(K, sizeof(T)).total;
  if (smem > 48 * 1024) {
    // Above the default, opt in: f32 windows past 47 tokens, bf16 past 31
    // (at most 97 KB, bf16 at K = 64).
    const cudaError_t err = cudaFuncSetAttribute(
        wkv_decode_kernel<T, NB>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(B * H, DH / col_tile);
  wkv_decode_kernel<T, NB><<<grid, 32 * col_tile / WARP_COLS, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w),
      static_cast<const T*>(u), static_cast<const float*>(h0),
      static_cast<T*>(out), static_cast<float*>(s_out), H, K, col_tile);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* h0, void* out, void* s_out, int B,
           int H, int K, int col_tile, cudaStream_t stream) {
  if (K == 1) return launch_nb<T, 1>(r, k, v, w, u, h0, out, s_out, B, H, K, col_tile, stream);
  return launch_nb<T, NB_WINDOW>(r, k, v, w, u, h0, out, s_out, B, H, K, col_tile, stream);
}

bool misaligned(const void* p) { return reinterpret_cast<uintptr_t>(p) & 15; }

// Blocks an SM of the instantiation a window launches (K = 1 or longer, the
// dtype, the column tile's block), with its dynamic shared memory opted in
// as the launcher does; or minus a cudaError_t.
template <typename T, int NB>
int occupancy_nb(int K, int col_tile) {
  const int smem = layout(K, sizeof(T)).total;
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024)
    e = cudaFuncSetAttribute(wkv_decode_kernel<T, NB>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int n = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, wkv_decode_kernel<T, NB>,
                                                      32 * col_tile / WARP_COLS, smem);
  return e == cudaSuccess ? n : -(int)e;
}

template <typename T>
int occupancy(int K, int col_tile) {
  return K == 1 ? occupancy_nb<T, 1>(K, col_tile) : occupancy_nb<T, NB_WINDOW>(K, col_tile);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (r, k, v, w, u, out); h0 and s_out float32.
// col_tile: value columns a block, 64, 32, 16 or 8.  r, k, v, w, u, h0 and
// s_out must be 16-byte aligned (bulk copies; the state's 8-byte accesses).
// Each block reads its state tile before it writes it, so s_out may alias h0.
// Returns 0 or the cudaError_t of the launch.
extern "C" int wkv_decode_window_fwd(const void* r, const void* k, const void* v,
                                     const void* w, const void* u, const void* h0,
                                     void* out, void* s_out, int B, int H, int K,
                                     int Dh, int dtype, int col_tile, void* stream) {
  if (Dh != DH || K < 1 || K > MAX_WINDOW || B < 1 || H < 1 ||
      (col_tile != 64 && col_tile != 32 && col_tile != 16 && col_tile != WARP_COLS))
    return (int)cudaErrorInvalidValue;
  for (const void* p : {r, k, v, w, u, h0, static_cast<const void*>(s_out)})
    if (misaligned(p)) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(r, k, v, w, u, h0, out, s_out, B, H, K, col_tile, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(r, k, v, w, u, h0, out, s_out, B, H, K, col_tile, s);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of one block for a K-token window (dtype as above);
// kernels/wkv/decode.py:decode_smem_bytes computes the same.
extern "C" int wkv_decode_smem(int K, int dtype) {
  return layout(K, dtype == 0 ? 4 : 2).total;
}

// The library's launch query (kernel 0, the window; p0 K, p1 the dtype, p2
// the column tile): blocks an SM from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor, or minus a cudaError_t.
extern "C" int wkv_decode_occupancy(int kernel, int p0, int p1, int p2, int p3, int p4) {
  (void)p3, (void)p4;
  if (kernel != 0 || p0 < 1 || p0 > MAX_WINDOW ||
      (p2 != 64 && p2 != 32 && p2 != 16 && p2 != WARP_COLS))
    return -(int)cudaErrorInvalidValue;
  if (p1 == 0) return occupancy<float>(p0, p2);
  if (p1 == 1) return occupancy<__nv_bfloat16>(p0, p2);
  return -(int)cudaErrorInvalidValue;
}
