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
// moves 200 KB at B=4 in f32, so launch latency sets its time; a 64-token
// window moves 7.9 MB.
//
// One step, one order.  Both kernels run every channel's recurrence as one
// serial chain in a register, rounding a * h before adding x (__fmul_rn
// then __fadd_rn, never a fused multiply-add), the order of the plain
// version ref.py:elevator_scan_ref_f32.  So the scan equals the plain
// version bit for bit, a window equals K chained single launches, and a
// chain of windows equals the scan over the same tokens.  The carry axis T
// is never a grid axis (blocks run in no order): it is a loop inside one
// block.  The chain costs a multiply and an add of latency a row, about 8
// cycles, 4096 rows in ~19 us: under the bytes bound, once loads are hidden.
//
// The chunked scan: a block owns `cols` channels of one batch row and walks
// all T rows.  One warp runs the chains, a lane a 4-byte word of a row (one
// f32 channel, two bf16); producer warps keep a ring of `stages` stages of
// a and x filled ahead of it, a full and an empty mbarrier a stage, so the
// chain warp spends nothing on loads but a wait a stage.  Outputs leave by
// coalesced row stores.  The pure-Python plan
// kernels/elevator_scan/kernel.py:plan_scan picks the mode, the channel tile
// and the ring's depth.
//   mode 0: one producer lane fills the ring by TMA (2-D tiles of RING_ROWS
//     rows of a (D, T, B) tensor map); cols * sizeof(T) is 128 or 64 bytes
//     (32 or 16 f32 channels), so the grid covers the SMs (160 blocks of 16
//     channels at B=1, D=2560).
//   mode 1: the variant for a layout no tensor map takes (a row of D
//     elements not a multiple of 16 bytes, or an address not 16-byte
//     aligned): LOADERS producer warps fill a ring of LOADER_ROWS-row stages
//     element by element, chunks in turn; the chain warp runs a lane a
//     channel, LOADER_COLS channels a block.
// The chain warp reads its stage GROUP rows at a time into registers, the
// next group's shared loads issued before this group's steps, and keeps a
// group's outputs in registers of their own until they are stored: a
// step's store may alias the stage as far as the compiler knows, and a
// register a pending store still reads cannot be written.

// The decode window: one chain a channel, the exit state written once.
//   mode 1 (K <= 64, rows a multiple of 16 bytes): a block owns `threads`
//     channels of one batch row; one thread puts the block's whole K-row
//     tiles of a and x in flight by TMA on one mbarrier before any chain
//     starts, while every thread reads its h0 entry.
//   mode 0 (any K, any layout; the single step): a thread owns `vec`
//     consecutive channels (16-byte accesses at vec = 4 in f32) and issues
//     the loads of up to WIN_KMAX tokens at once, unrolled into registers,
//     before its chain runs them.
// The plan kernels/elevator_scan/decode.py:plan_window picks the mode,
// `vec` and the block's threads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>
#include <initializer_list>

#include "sm90.cuh"

namespace {

constexpr int MAX_STAGES = 8;     // ring depth at most
constexpr int RING_ROWS = 128;    // rows of a ring stage filled by TMA (mode 0)
constexpr int LOADER_ROWS = 64;   // rows of a ring stage filled by loader warps (mode 1)
constexpr int LOADER_COLS = 16;   // channels of a block of mode 1
constexpr int GROUP = 16;         // rows of a register group
constexpr int LOADERS = 3;        // producer warps of mode 1
constexpr int HEADER = 256;       // shared bytes before the ring: the stage barriers
constexpr int WIN_KMAX = 32;      // window tokens a register-window thread loads at once
constexpr int WIN_VALUES = 64;    // values of a and x a register-window thread holds
constexpr int WIN_TMA_KMAX = 64;  // tokens of a staged window

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// V consecutive elements, loaded and stored as one access.
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

// One step of the recurrence in its one fixed form.
__device__ __forceinline__ float step(float a, float h, float x) {
  return __fadd_rn(__fmul_rn(a, h), x);
}

// G rows of a and x from shared memory (`stride` elements a row) into
// registers, every load issued before any step uses one: a step's store
// (global or shared) may alias the tiles as far as the compiler knows, so
// loads written after it would wait for it, one row at a time.
template <typename T, int G>
__device__ __forceinline__ void lds(T (&va)[G], T (&vx)[G], const T* sa, const T* sx,
                                    int stride) {
#pragma unroll
  for (int i = 0; i < G; ++i) {
    va[i] = sa[i * stride];
    vx[i] = sx[i * stride];
  }
}

template <typename T>
constexpr CUtensorMapDataType map_type() {
  return sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// ---------------------------------------------------------------------------
// The chunked scan.
// ---------------------------------------------------------------------------

// Shared memory: the header (full and empty barriers of every stage) and
// the ring (`stages` stages of an a tile then an x tile, R x cols each).
__host__ __device__ constexpr int scan_smem(int R, int cols, int item, int stages) {
  return HEADER + 2 * stages * R * cols * item;
}

// Rows of a ring stage: TMA tiles are long, loader warps take more chunks.
__host__ __device__ constexpr int stage_rows(int mode) {
  return mode == 1 ? LOADER_ROWS : RING_ROWS;
}

// Mode 1's loader warps: chunk c's rows of a and x, element by element (any
// layout), into its stage, a lane a column of every 32 / COLS-th row.
template <typename T, int COLS>
__device__ __forceinline__ void load_rows(T* sa, T* sx, const T* __restrict__ a,
                                          const T* __restrict__ x, size_t row0, int rows,
                                          int R, int d0, int D, int lane) {
  constexpr int STEP = 32 / COLS;
  const int col = lane % COLS, r0 = lane / COLS;
  const bool col_ok = d0 + col < D;
  const size_t at = (row0 + r0) * D + d0 + col;
  const T* pa = a + at;
  const T* px = x + at;
#pragma unroll 16
  for (int r = r0; r < R; r += STEP) {
    const bool ok = col_ok && r < rows;
    sa[r * COLS + col] = ok ? *pa : from_f<T>(0.f);
    sx[r * COLS + col] = ok ? *px : from_f<T>(0.f);
    pa += (size_t)STEP * D;
    px += (size_t)STEP * D;
  }
}

// One warp runs the chains, LANES lanes of PER channels (a 4-byte word of a
// row in mode 0, PER chains interleaved; one element in mode 1); producer
// warps fill the ring (mode 0: one lane issuing TMA tiles; mode 1: LOADERS
// warps loading elements), a full and an empty mbarrier a stage.  The
// lanes, the stage rows and so the shared-memory row stride are
// compile-time, so a group's shared loads take immediate offsets.  A lane
// past the row's end, or past LANES, mirrors lane 0 (its reads, its chain,
// its stores of the same values to the same addresses), so no access needs
// a predicate.  The launch bound's one block an SM lets ptxas take the
// registers the groups need (without it, two loader-warp instances spilled
// at 72-80 registers).
template <typename T, int MODE, int LANES>
__global__ void __launch_bounds__(32 * (1 + LOADERS), 1) elevator_scan_kernel(
    const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_x,
    const T* __restrict__ a, const T* __restrict__ x, const float* __restrict__ h0,
    T* __restrict__ out, int Tn, int D, int ns) {
  constexpr int PER = MODE == 1 ? 1 : 4 / (int)sizeof(T);
  constexpr int cols = LANES * PER;             // channels of the block
  constexpr int R = stage_rows(MODE);
  using W = Pack<T, PER>;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + MAX_STAGES;
  T* ring = reinterpret_cast<T*>(smem + HEADER);
  const int tile = R * cols;                    // elements of one tile
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int d0 = blockIdx.x * cols, b = blockIdx.y;
  const int nchunks = (Tn + R - 1) / R;

  if (threadIdx.x == 0) {
    for (int s = 0; s < ns; ++s) {
      sm90::mbar_init(&full[s], MODE == 1 ? 32 : 1);
      sm90::mbar_init(&empty[s], 1);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  // ---- producers: chunk c into stage c % ns once chunk c - ns is read ----
  if (warp > 0) {
    if constexpr (MODE == 1) {
      for (int c = warp - 1; c < nchunks; c += LOADERS) {
        const int s = c % ns;
        if (c >= ns) sm90::mbar_wait(&empty[s], (c / ns - 1) & 1);
        T* sa = ring + (size_t)s * 2 * tile;
        load_rows<T, cols>(sa, sa + tile, a, x, (size_t)b * Tn + (size_t)c * R,
                           min(R, Tn - c * R), R, d0, D, lane);
        sm90::mbar_arrive(&full[s]);
      }
    } else if (warp == 1 && lane == 0) {
      sm90::tma_prefetch_map(&map_a);
      sm90::tma_prefetch_map(&map_x);
      const uint32_t stage_bytes = 2u * tile * sizeof(T);
      for (int c = 0; c < nchunks; ++c) {
        const int s = c % ns;
        if (c >= ns) sm90::mbar_wait(&empty[s], (c / ns - 1) & 1);
        T* sa = ring + (size_t)s * 2 * tile;
        sm90::mbar_arrive_expect_tx(&full[s], stage_bytes);
        sm90::tma_load_3d(sa, &map_a, &full[s], d0, c * R, b);
        sm90::tma_load_3d(sa + tile, &map_x, &full[s], d0, c * R, b);
      }
    }
    return;
  }

  // ---- the chain warp ----
  constexpr int lanes = LANES;
  const int ln = lane < lanes && d0 + PER * lane < D ? lane : 0;
  const int dl = d0 + PER * ln;                 // the lane's first channel
  float h[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) h[j] = h0 != nullptr ? h0[(size_t)b * D + dl + j] : 0.f;
  const size_t stride = (size_t)D / PER;        // words between rows of out

  auto steps = [&](const W& wa, const W& wx) {
    W w;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      h[j] = step(to_f(wa.v[j]), h[j], to_f(wx.v[j]));
      w.v[j] = from_f<T>(h[j]);
    }
    return w;
  };
  for (int c = 0; c < nchunks; ++c) {
    const int s = c % ns;
    const int t0 = c * R;
    const int rows = min(R, Tn - t0);
    sm90::mbar_wait(&full[s], (c / ns) & 1);
    const W* sa = reinterpret_cast<const W*>(ring + (size_t)s * 2 * tile) + ln;
    const W* sx = sa + tile / PER;
    W* o = reinterpret_cast<W*>(out + ((size_t)b * Tn + t0) * D + dl);
    auto put = [&](int r, const W& w) { o[r * stride] = w; };
    // GROUP rows of steps from (va, vx) into hv, then their stores.
    auto group = [&](int r0, const W (&va)[GROUP], const W (&vx)[GROUP], W (&hv)[GROUP]) {
#pragma unroll
      for (int i = 0; i < GROUP; ++i) hv[i] = steps(va[i], vx[i]);
#pragma unroll
      for (int i = 0; i < GROUP; ++i) put(r0 + i, hv[i]);
    };
    if (rows == R) {
      // Two register groups of each: group g + 1's shared loads go out
      // before group g's steps, and group g's outputs sit in registers of
      // their own until their stores, so no step waits for a store.
      W va0[GROUP], vx0[GROUP], va1[GROUP], vx1[GROUP], hv0[GROUP], hv1[GROUP];
      lds<W, GROUP>(va0, vx0, sa, sx, lanes);
      for (int r0 = 0; r0 < R; r0 += 2 * GROUP) {
        lds<W, GROUP>(va1, vx1, sa + (r0 + GROUP) * lanes, sx + (r0 + GROUP) * lanes, lanes);
        group(r0, va0, vx0, hv0);
        if (r0 + 2 * GROUP < R) {
          const int r2 = (r0 + 2 * GROUP) * lanes;
          lds<W, GROUP>(va0, vx0, sa + r2, sx + r2, lanes);
        }
        group(r0 + GROUP, va1, vx1, hv1);
      }
    } else {
      for (int r = 0; r < rows; ++r) put(r, steps(sa[r * lanes], sx[r * lanes]));
    }
    __syncwarp();                               // every lane has read stage s
    if (lane == 0) sm90::mbar_arrive(&empty[s]);
  }
}

// ---------------------------------------------------------------------------
// The decode window, mode 0: register loads (any layout).
// ---------------------------------------------------------------------------

// KMAX: the window tokens whose loads a thread issues at once (1, or a
// multiple of 8 up to WIN_KMAX); a longer window runs in pieces of KMAX.
template <typename T, int V, int KMAX>
__global__ void __launch_bounds__(256) elevator_window_kernel(
    const T* __restrict__ a, const T* __restrict__ x, const float* h0, T* __restrict__ out,
    float* h_out, int K, int D) {
  const int d0 = (blockIdx.x * blockDim.x + threadIdx.x) * V;
  if (d0 >= D) return;                          // D % V == 0
  const size_t row = (size_t)blockIdx.y * D + d0;
  const size_t base = (size_t)blockIdx.y * K * D + d0;
  Pack<float, V> h = *reinterpret_cast<const Pack<float, V>*>(h0 + row);
  for (int k0 = 0; k0 < K; k0 += KMAX) {
    Pack<T, V> pa[KMAX], px[KMAX];
#pragma unroll
    for (int t = 0; t < KMAX; ++t) {
      if (k0 + t < K) {
        pa[t] = *reinterpret_cast<const Pack<T, V>*>(a + base + (size_t)(k0 + t) * D);
        px[t] = *reinterpret_cast<const Pack<T, V>*>(x + base + (size_t)(k0 + t) * D);
      }
    }
#pragma unroll
    for (int t = 0; t < KMAX; ++t) {
      if (k0 + t < K) {
        Pack<T, V> o;
#pragma unroll
        for (int v = 0; v < V; ++v) {
          h.v[v] = step(to_f(pa[t].v[v]), h.v[v], to_f(px[t].v[v]));
          o.v[v] = from_f<T>(h.v[v]);
        }
        *reinterpret_cast<Pack<T, V>*>(out + base + (size_t)(k0 + t) * D) = o;
      }
    }
  }
  *reinterpret_cast<Pack<float, V>*>(h_out + row) = h;
}

// ---------------------------------------------------------------------------
// The decode window, mode 1: staged by TMA (K <= 64, rows a multiple of 16
// bytes).  A block owns COLS channels of one batch row, one thread each;
// one thread puts the block's whole (K x COLS) tiles of a and x in flight
// on one mbarrier while every thread reads its h0 entry.
// ---------------------------------------------------------------------------

// Shared memory: the barrier, the a tile, the x tile (each K x cols), each
// tile starting on a 128-byte boundary as TMA needs.
__host__ __device__ constexpr int window_tile(int K, int cols, int item) {
  return (K * cols * item + 127) / 128 * 128;
}
__host__ __device__ constexpr int window_smem(int K, int cols, int item) {
  return 128 + 2 * window_tile(K, cols, item);
}

template <typename T, int COLS>
__global__ void __launch_bounds__(COLS) elevator_window_tma_kernel(
    const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_x,
    const float* h0, T* __restrict__ out, float* h_out, int K, int D) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  const int tid = threadIdx.x;
  T* tile_a = reinterpret_cast<T*>(smem + 128);
  T* tile_x = reinterpret_cast<T*>(smem + 128 + window_tile(K, COLS, sizeof(T)));
  const T* sa = tile_a + tid;
  const T* sx = tile_x + tid;
  const int d0 = blockIdx.x * COLS, b = blockIdx.y, d = d0 + tid;
  const bool live = d < D;
  if (tid == 0) {
    sm90::tma_prefetch_map(&map_a);
    sm90::tma_prefetch_map(&map_x);
    sm90::mbar_init(bar, 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    sm90::mbar_arrive_expect_tx(bar, 2u * K * COLS * sizeof(T));
    sm90::tma_load_3d(tile_a, &map_a, bar, d0, 0, b);
    sm90::tma_load_3d(tile_x, &map_x, bar, d0, 0, b);
  }
  float h = live ? h0[(size_t)b * D + d] : 0.f;
  T* o = out + (size_t)b * K * D + d;
  sm90::mbar_wait(bar, 0);
  for (int t0 = 0; t0 < K; t0 += 8) {
    T va[8], vx[8];
    if (t0 + 8 <= K) {
      lds<T, 8>(va, vx, sa + t0 * COLS, sx + t0 * COLS, COLS);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        h = step(to_f(va[i]), h, to_f(vx[i]));
        if (live) o[(size_t)(t0 + i) * D] = from_f<T>(h);
      }
    } else {
      for (int t = t0; t < K; ++t) {
        h = step(to_f(sa[t * COLS]), h, to_f(sx[t * COLS]));
        if (live) o[(size_t)t * D] = from_f<T>(h);
      }
    }
  }
  if (live) h_out[(size_t)b * D + d] = h;
}

// ---------------------------------------------------------------------------
// Host side.
// ---------------------------------------------------------------------------

bool misaligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes != 0;
}

// Above the default 48 KB of shared memory a kernel must opt in.
template <typename Kernel>
int allow_smem(Kernel kernel, int smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <typename T, int MODE, int LANES>
int launch_mode(const void* a, const void* x, const void* h0, void* out, int B, int Tn, int D,
                int ns, cudaStream_t stream) {
  constexpr int cols = LANES * (MODE == 1 ? 1 : 4 / (int)sizeof(T));
  constexpr int R = stage_rows(MODE);
  CUtensorMap ma, mx;
  memset(&ma, 0, sizeof(ma));
  memset(&mx, 0, sizeof(mx));
  if constexpr (MODE == 0) {
    const uint64_t dims[3] = {(uint64_t)D, (uint64_t)Tn, (uint64_t)B};
    const uint64_t strides[2] = {(uint64_t)D * sizeof(T), (uint64_t)Tn * D * sizeof(T)};
    const uint32_t box[3] = {(uint32_t)cols, (uint32_t)R, 1};
    int e = sm90::encode_plain_map(&ma, map_type<T>(), 3, a, dims, strides, box);
    if (!e) e = sm90::encode_plain_map(&mx, map_type<T>(), 3, x, dims, strides, box);
    if (e) return e;
  }
  const int smem = scan_smem(R, cols, sizeof(T), ns);
  if (int err = allow_smem(elevator_scan_kernel<T, MODE, LANES>, smem)) return err;
  dim3 grid((D + cols - 1) / cols, B);
  elevator_scan_kernel<T, MODE, LANES>
      <<<grid, 32 * (1 + (MODE == 1 ? LOADERS : 1)), smem, stream>>>(
          ma, mx, static_cast<const T*>(a), static_cast<const T*>(x),
          static_cast<const float*>(h0), static_cast<T*>(out), Tn, D, ns);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_scan(const void* a, const void* x, const void* h0, void* out, int B, int Tn, int D,
                int cols, int stages, int mode, cudaStream_t stream) {
  if (stages < 1 || stages > MAX_STAGES || (mode != 0 && mode != 1))
    return (int)cudaErrorInvalidValue;
  const int R = stage_rows(mode), nchunks = (Tn + R - 1) / R;
  if (mode == 1) {
    if (cols != LOADER_COLS) return (int)cudaErrorInvalidValue;
    // The loader warps take chunks in turn: a ring of at least LOADERS
    // stages keeps any waiter within one phase of its barrier.
    const int ring = stages > LOADERS ? stages : LOADERS;
    const int ns = ring < nchunks ? ring : nchunks;
    return launch_mode<T, 1, LOADER_COLS>(a, x, h0, out, B, Tn, D, ns, stream);
  }
  // The chain warp's lanes, 16 or 32, a 4-byte word of a row each.
  const int per = 4 / (int)sizeof(T);
  if (cols != 16 * per && cols != 32 * per) return (int)cudaErrorInvalidValue;
  if ((D * sizeof(T)) % 16 != 0 || misaligned(a, 16) || misaligned(x, 16) || misaligned(out, 16))
    return (int)cudaErrorMisalignedAddress;
  const int ns = stages < nchunks ? stages : nchunks;
  if (cols == 32 * per) return launch_mode<T, 0, 32>(a, x, h0, out, B, Tn, D, ns, stream);
  return launch_mode<T, 0, 16>(a, x, h0, out, B, Tn, D, ns, stream);
}

template <typename T, int V, int KMAX>
int launch_window_k(const void* a, const void* x, const void* h0, void* out, void* h_out, int B,
                    int K, int D, int threads, cudaStream_t stream) {
  if constexpr (2 * V * KMAX > WIN_VALUES) {
    return (int)cudaErrorInvalidValue;
  } else {
    dim3 grid((D / V + threads - 1) / threads, B);
    elevator_window_kernel<T, V, KMAX><<<grid, threads, 0, stream>>>(
        static_cast<const T*>(a), static_cast<const T*>(x), static_cast<const float*>(h0),
        static_cast<T*>(out), static_cast<float*>(h_out), K, D);
    return (int)cudaGetLastError();
  }
}

template <typename T, int V>
int launch_window_v(const void* a, const void* x, const void* h0, void* out, void* h_out, int B,
                    int K, int D, int kmax, int threads, cudaStream_t s) {
  switch (kmax) {
    case 1: return launch_window_k<T, V, 1>(a, x, h0, out, h_out, B, K, D, threads, s);
    case 8: return launch_window_k<T, V, 8>(a, x, h0, out, h_out, B, K, D, threads, s);
    case 16: return launch_window_k<T, V, 16>(a, x, h0, out, h_out, B, K, D, threads, s);
    case 24: return launch_window_k<T, V, 24>(a, x, h0, out, h_out, B, K, D, threads, s);
    case 32: return launch_window_k<T, V, 32>(a, x, h0, out, h_out, B, K, D, threads, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T, int COLS>
int launch_window_tma(const void* a, const void* x, const void* h0, void* out, void* h_out,
                      int B, int K, int D, cudaStream_t stream) {
  const uint64_t dims[3] = {(uint64_t)D, (uint64_t)K, (uint64_t)B};
  const uint64_t strides[2] = {(uint64_t)D * sizeof(T), (uint64_t)K * D * sizeof(T)};
  const uint32_t box[3] = {(uint32_t)COLS, (uint32_t)K, 1};
  CUtensorMap ma, mx;
  int e = sm90::encode_plain_map(&ma, map_type<T>(), 3, a, dims, strides, box);
  if (!e) e = sm90::encode_plain_map(&mx, map_type<T>(), 3, x, dims, strides, box);
  if (e) return e;
  const int smem = window_smem(K, COLS, sizeof(T));
  if (int err = allow_smem(elevator_window_tma_kernel<T, COLS>, smem)) return err;
  dim3 grid((D + COLS - 1) / COLS, B);
  elevator_window_tma_kernel<T, COLS><<<grid, COLS, smem, stream>>>(
      ma, mx, static_cast<const float*>(h0), static_cast<T*>(out), static_cast<float*>(h_out),
      K, D);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_window(const void* a, const void* x, const void* h0, void* out, void* h_out, int B,
                  int K, int D, int vec, int threads, int mode, cudaStream_t s) {
  if (!(threads == 32 || threads == 64 || threads == 128 || threads == 256))
    return (int)cudaErrorInvalidValue;
  if (mode == 1) {
    if (vec != 1 || K > WIN_TMA_KMAX) return (int)cudaErrorInvalidValue;
    if ((D * sizeof(T)) % 16 != 0 || misaligned(a, 16) || misaligned(x, 16))
      return (int)cudaErrorMisalignedAddress;
    if (threads == 128) return launch_window_tma<T, 128>(a, x, h0, out, h_out, B, K, D, s);
    if (threads == 64) return launch_window_tma<T, 64>(a, x, h0, out, h_out, B, K, D, s);
    if (threads == 32) return launch_window_tma<T, 32>(a, x, h0, out, h_out, B, K, D, s);
    return (int)cudaErrorInvalidValue;
  }
  if (mode != 0 || D % vec != 0) return (int)cudaErrorInvalidValue;
  // The tokens whose loads go out at once: 1 for a single step, else the
  // window rounded up to 8 tokens, at most WIN_KMAX.
  const int kmax = K == 1 ? 1 : (K >= WIN_KMAX ? WIN_KMAX : (K + 7) / 8 * 8);
  const uintptr_t bytes = vec * sizeof(T);
  for (const void* p : {a, x, static_cast<const void*>(out)})
    if (misaligned(p, bytes)) return (int)cudaErrorMisalignedAddress;
  if (misaligned(h0, vec * 4) || misaligned(h_out, vec * 4))
    return (int)cudaErrorMisalignedAddress;
  if (vec == 4) return launch_window_v<T, 4>(a, x, h0, out, h_out, B, K, D, kmax, threads, s);
  if (vec == 2) return launch_window_v<T, 2>(a, x, h0, out, h_out, B, K, D, kmax, threads, s);
  if (vec == 1) return launch_window_v<T, 1>(a, x, h0, out, h_out, B, K, D, kmax, threads, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (a, x, out); h0 float32 or null (zeros).
// mode: 0 the TMA ring (rows of D elements a multiple of 16 bytes and a, x,
// out 16-byte aligned; cols * item 128 or 64 bytes), 1 the ring filled by
// loader warps (any layout; cols 16).  stages: the ring's depth (1..8; the
// launch takes no more than T needs, and mode 1 at least 3).  The wrapper's
// plan (kernels/elevator_scan/kernel.py:plan_scan) picks them.  Returns 0, a
// cudaError_t, or 10000 + the CUresult of a tensor map.
extern "C" int elevator_scan_fwd(const void* a, const void* x, const void* h0, void* out,
                                 int B, int Tn, int D, int dtype, int cols, int stages,
                                 int mode, void* stream) {
  if (B < 1 || B > 65535 || Tn < 1 || D < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_scan<float>(a, x, h0, out, B, Tn, D, cols, stages, mode, s);
  if (dtype == 1)
    return launch_scan<__nv_bfloat16>(a, x, h0, out, B, Tn, D, cols, stages, mode, s);
  return (int)cudaErrorInvalidValue;
}

// dtype as above; h0 and h_out float32 (B, D).  mode 0: register loads,
// `vec` consecutive channels a thread (4, 2 or 1; D a multiple of it, a, x,
// out aligned to vec elements and h0, h_out to vec floats), `threads` a
// block (32, 64, 128 or 256), any K; mode 1: staged by TMA, one channel a
// thread (vec 1), `threads` channels a block (32, 64 or 128), K <= 64, rows
// of D elements a multiple of 16 bytes and a, x 16-byte aligned.  The
// wrapper's plan (kernels/elevator_scan/decode.py:plan_window) picks them.
// Each thread reads its h0 entries before it writes its h_out entries, so
// h_out may alias h0.  Returns 0, a cudaError_t, or 10000 + the CUresult of
// a tensor map.
extern "C" int elevator_decode_window_fwd(const void* a, const void* x, const void* h0,
                                          void* out, void* h_out, int B, int K, int D,
                                          int dtype, int vec, int threads, int mode,
                                          void* stream) {
  if (B < 1 || B > 65535 || K < 1 || D < 1 || h0 == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_window<float>(a, x, h0, out, h_out, B, K, D, vec, threads, mode, s);
  if (dtype == 1)
    return launch_window<__nv_bfloat16>(a, x, h0, out, h_out, B, K, D, vec, threads, mode, s);
  return (int)cudaErrorInvalidValue;
}
