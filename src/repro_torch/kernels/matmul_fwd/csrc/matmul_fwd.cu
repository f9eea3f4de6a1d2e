// Operand-forwarding matmul C = A B (paper Fig. 2/3) for Hopper (sm_90a),
// plain C interface.
//
// Replaces: src/repro/kernels/matmul_fwd/kernel.py:matmul_fwd_pallas, reached
// through repro_torch.kernels.matmul_fwd.ops.matmul_fwd.
//
//   C[m, n] = sum_k f32(A[m, k]) f32(B[k, n]),   C in A's dtype
//
// What bounds it: operations at the large shapes.  At 4096^3 the product is
// 1.37e11 operations: 139 us at 989 TFLOP/s on the bf16 tensor cores and
// 2.05 ms at 67 TFLOP/s in f32 outside them, against 100 MB (bf16) or
// 201 MB (f32) of A, B and C (30 us / 60 us at 3.35 TB/s).  At the Rodinia
// suite's 256^3 the bound is under 1 us: there the time goes to filling the
// card (132 SMs) and to the latency of the first loads.
//
// Design: the paper's operand forwarding is block residency.  The Pallas
// kernel pulled an A and a B tile into VMEM once and let the MXU reuse each
// element along the other operand's dimension, with the f32 sum in a VMEM
// scratch across a sequential K grid axis.  Here the K axis is a loop inside
// one block per output tile, the sum lives in registers for the whole loop,
// and each A / B element brought into shared memory is read by every thread
// that needs it.  The planner (kernel.py:plan) picks the variant, the tile
// and a split of K from M, N, K and the SM count, so that the work items
// reach 90% of the SMs where K allows, splitting K only where no tile count
// does; this entry point launches what it is given.
// - Split-K is deterministic: split z writes its f32 partial tile to
//   workspace plane z (allocated by the wrapper), and splitk_reduce_kernel
//   sums the planes in order z = 0, 1, ... and rounds once.  No atomics.
// - bf16 with 16-byte rows (K % 8 == 0, N % 8 == 0, aligned pointers),
//   `matmul_wgmma_kernel`: a persistent, warp-specialised kernel of three
//   warpgroups.  One thread of the producer warpgroup keeps TMA loads in
//   flight: A tiles (128 x 64, K-major) and B tiles (64 x BN, N-major, in
//   64-column boxes; BN = 256, or 64 where 256-wide tiles would leave SMs
//   idle) with the 128-byte swizzle into a ring of 4 (BN = 256) or 5
//   stages, each stage guarded by a full and an empty mbarrier.  Two
//   consumer warpgroups each own 64 x BN of the tile and issue wgmma
//   m64nBNk16 (SS, B through the transpose bit), one k-tile in flight
//   behind the next, with the f32 sums in registers (BN / 2 a thread).
//   setmaxnreg moves registers from the producer (40) to the consumers
//   (232).  Shared memory: BN = 256 is 48 KB a stage, 192 KB for 4 stages.
//   The grid is min(work items, SMs) blocks that walk the (tile, split)
//   items, so one tile's epilogue overlaps the next one's first loads.  The
//   epilogue rounds to bf16 with round-to-nearest-even.
// - bf16 with unaligned rows (K or N not a multiple of 8):
//   `matmul_bf16_elem_kernel`, the element-wise tile path of before (mma.sync
//   m16n8k16 fed by ldmatrix, 128 x 128 tiles), with the planner's split.
//   TMA needs every stride but the innermost to be a multiple of 16 bytes,
//   which such rows are not.
// - f32: `matmul_f32_kernel`, CUDA cores (no TF32: the reference's product is
//   full f32).  The planner's TM x TN tile (128 x 128 down to 32 x 64), 256
//   threads each holding a (TM / 16) x (TN / 16) register micro-tile, k-steps
//   of 32 through a 3-stage cp.async ring (16-byte copies where rows are
//   16-byte aligned, else 4-byte ones).  A is kept row-major with rows padded
//   by 4 floats and read as float4 along k; a thread's rows and columns come
//   in groups of 4 spread over the tile, so a warp's float4 reads of A and B
//   fall in distinct banks.
// Later work: a TMA-store epilogue, clusters with multicast of A / B tiles,
// and an fp8 path.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !ok.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

// 4 bytes global -> shared, asynchronously; zero-filled when !ok.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

// ---------------------------------------------------------------------------
// bf16, 16-byte rows: wgmma fed by TMA, warp-specialised and persistent
// ---------------------------------------------------------------------------

constexpr int WG_BM = 128, WG_BK = 64;
constexpr int WG_THREADS = 384;           // producer warpgroup + 2 consumers

template <int BN>
struct WgPlan {
  static constexpr int STAGES = BN == 256 ? 4 : 5;
  static constexpr int A_BYTES = WG_BM * WG_BK * 2;
  static constexpr int B_BYTES = WG_BK * BN * 2;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int SMEM = STAGES * STAGE_BYTES + 1024;   // + 1024-byte alignment
};

template <int BN>
__global__ void __launch_bounds__(WG_THREADS, 1) matmul_wgmma_kernel(
    const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
    bf16* __restrict__ C, float* __restrict__ ws, int M, int N, int K, int tiles_m,
    int work, int split, int kt_per_split) {
  using P = WgPlan<BN>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[P::STAGES];
  __shared__ __align__(8) uint64_t empty_bar[P::STAGES];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int wg = threadIdx.x / 128;
  const int kt_total = (K + WG_BK - 1) / WG_BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < P::STAGES; ++s) {
      sm90::mbar_init(&full_bar[s], 1);
      sm90::mbar_init(&empty_bar[s], 8);      // lane 0 of each consumer warp
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // Producer: one thread issues every load; the warpgroup's registers go
    // to the consumers.
    sm90::reg_dealloc<40>();
    if (threadIdx.x == 0) {
      sm90::tma_prefetch_map(&map_a);
      sm90::tma_prefetch_map(&map_b);
      int stage = 0, phase = 0;
      for (int w = blockIdx.x; w < work; w += gridDim.x) {
        const int tile = w / split, z = w - tile * split;
        const int m0 = (tile % tiles_m) * WG_BM, n0 = (tile / tiles_m) * BN;
        const int kt0 = z * kt_per_split, kt1 = min(kt0 + kt_per_split, kt_total);
        for (int kt = kt0; kt < kt1; ++kt) {
          sm90::mbar_wait(&empty_bar[stage], phase ^ 1);
          uint8_t* sa = smem + stage * P::STAGE_BYTES;
          uint8_t* sb = sa + P::A_BYTES;
          sm90::mbar_arrive_expect_tx(&full_bar[stage], P::STAGE_BYTES);
          sm90::tma_load_2d(sa, &map_a, &full_bar[stage], kt * WG_BK, m0);
#pragma unroll
          for (int c = 0; c < BN / 64; ++c)
            sm90::tma_load_2d(sb + c * (WG_BK * 128), &map_b, &full_bar[stage], n0 + c * 64,
                              kt * WG_BK);
          if (++stage == P::STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    sm90::reg_alloc<232>();
    const int cw = wg - 1;                     // rows cw * 64 .. of the tile
    const int t = threadIdx.x - 128 * wg, warp = t / 32, lane = t % 32;
    float acc[BN / 2];
    int stage = 0, phase = 0;
    for (int w = blockIdx.x; w < work; w += gridDim.x) {
      const int tile = w / split, z = w - tile * split;
      const int m0 = (tile % tiles_m) * WG_BM, n0 = (tile / tiles_m) * BN;
      const int kt0 = z * kt_per_split, kt1 = min(kt0 + kt_per_split, kt_total);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      sm90::fence_regs(acc);
      int prev = -1;
      for (int kt = kt0; kt < kt1; ++kt) {
        sm90::mbar_wait(&full_bar[stage], phase);
        const uint32_t sa = smem_u32(smem + stage * P::STAGE_BYTES) + cw * 64 * 128;
        const uint32_t sb = smem_u32(smem + stage * P::STAGE_BYTES + P::A_BYTES);
        sm90::wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < WG_BK / 16; ++ks)
          sm90::wgmma_ss<BN, 1>(acc, sm90::desc_kmajor<128>(sa, ks, WG_BM * 128),
                                sm90::desc_mnmajor<128>(sb, ks, WG_BK * 128), 1);
        sm90::wgmma_commit();
        sm90::wgmma_wait<1>();                 // the previous k-tile's products are done
        if (prev >= 0 && lane == 0) sm90::mbar_arrive(&empty_bar[prev]);
        prev = stage;
        if (++stage == P::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
      if (prev >= 0 && lane == 0) sm90::mbar_arrive(&empty_bar[prev]);

      // Epilogue: bf16 pairs (split 1) or f32 partials into plane z.
      const int r0 = m0 + cw * 64 + warp * 16 + lane / 4;
      const int cb = n0 + 2 * (lane % 4);
      float* plane = ws + (size_t)z * M * N;
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        const int c = cb + 8 * i;
        if (c < N) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = r0 + 8 * h;
            if (r >= M) continue;
            const float x = acc[4 * i + 2 * h], y = acc[4 * i + 2 * h + 1];
            if (split == 1)
              *reinterpret_cast<__nv_bfloat162*>(C + (size_t)r * N + c) =
                  __floats2bfloat162_rn(x, y);
            else
              *reinterpret_cast<float2*>(plane + (size_t)r * N + c) = make_float2(x, y);
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16, unaligned rows: element-wise tile loads, mma.sync
// ---------------------------------------------------------------------------

constexpr int EM = 128, EN = 128, EK = 32;
constexpr int E_THREADS = 256;
constexpr int ASTR = EK + 8;     // A tile row stride, halfs
constexpr int BSTR = EN + 8;     // B tile row stride, halfs

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c (16x8 f32) += a (16x16 bf16, row) * b (16x8 bf16, col).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A tile (EM x EK at (m0, k0)) and the B tile (EK x EN at (k0, n0)) into
// shared memory one element at a time, zeros outside [.., k1) and the
// matrices.
__device__ __forceinline__ void load_tiles_elem(bf16* sA, bf16* sB, const bf16* A,
                                                const bf16* B, int M, int N, int K, int m0,
                                                int n0, int k0, int k1) {
  const bf16 zero = __float2bfloat16(0.f);
  for (int i = threadIdx.x; i < EM * EK; i += E_THREADS) {
    const int r = i / EK, c = i % EK;
    sA[r * ASTR + c] = (m0 + r < M && k0 + c < k1) ? A[(size_t)(m0 + r) * K + k0 + c] : zero;
  }
  for (int i = threadIdx.x; i < EK * EN; i += E_THREADS) {
    const int r = i / EN, c = i % EN;
    sB[r * BSTR + c] = (k0 + r < k1 && n0 + c < N) ? B[(size_t)(k0 + r) * N + n0 + c] : zero;
  }
}

__global__ void __launch_bounds__(E_THREADS) matmul_bf16_elem_kernel(
    const bf16* __restrict__ A, const bf16* __restrict__ B, bf16* __restrict__ C,
    float* __restrict__ ws, int M, int N, int K, int kt_per_split) {
  __shared__ __align__(16) bf16 sA[EM * ASTR];
  __shared__ __align__(16) bf16 sB[EK * BSTR];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;   // 2 x 4 warps
  const int m0 = blockIdx.y * EM, n0 = blockIdx.x * EN, z = blockIdx.z;
  const int k_begin = z * kt_per_split * EK, k_end = min(K, k_begin + kt_per_split * EK);

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += EK) {
    load_tiles_elem(sA, sB, A, B, M, N, K, m0, n0, k0, k_end);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < EK; kk += 16) {
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldsm_x4(af[mi], smem_u32(sA + (wm + mi * 16 + (lane & 15)) * ASTR + kk +
                                 (lane >> 4) * 8));
#pragma unroll
      for (int nj = 0; nj < 4; nj += 2) {
        uint32_t t[4];
        ldsm_x4_trans(t, smem_u32(sB + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * BSTR +
                                  wn + nj * 8 + (lane >> 4) * 8));
        bfr[nj][0] = t[0];
        bfr[nj][1] = t[1];
        bfr[nj + 1][0] = t[2];
        bfr[nj + 1][1] = t[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) mma_bf16(acc[mi][nj], af[mi], bfr[nj][0], bfr[nj][1]);
    }
    __syncthreads();             // the tiles are read before they are refilled
  }

  const bool direct = gridDim.z == 1;
  float* plane = ws + (size_t)z * M * N;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = m0 + wm + mi * 16 + g + (e >> 1) * 8;
        const int c = n0 + wn + nj * 8 + tig * 2 + (e & 1);
        if (r >= M || c >= N) continue;
        if (direct)
          C[(size_t)r * N + c] = __float2bfloat16_rn(acc[mi][nj][e]);
        else
          plane[(size_t)r * N + c] = acc[mi][nj][e];
      }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int F_BK = 32;
constexpr int F_THREADS = 256;     // a 16 x 16 grid of threads
constexpr int F_STAGES = 3;
constexpr int F_APAD = 4;          // keeps rows 16-byte aligned, spreads banks

template <int TM, int TN>
struct F32Plan {
  static constexpr int RM = TM / 16, RN = TN / 16;   // a thread's micro-tile
  static constexpr int AS = F_BK + F_APAD;           // A row stride, floats
  static constexpr int STAGE_FLOATS = TM * AS + F_BK * TN;
  static constexpr int SMEM = F_STAGES * STAGE_FLOATS * 4;
};

// Row i of thread row ty's micro-tile: groups of 4 rows, TM / (RM / 4) apart.
template <int TM, int RM>
__device__ __forceinline__ int f32_row(int ty, int i) {
  if constexpr (RM >= 4)
    return (i / 4) * (TM * 4 / RM) + ty * 4 + (i % 4);
  else
    return ty * RM + i;
}

template <int TM, int TN, bool VEC>
__global__ void __launch_bounds__(F_THREADS) matmul_f32_kernel(
    const float* __restrict__ A, const float* __restrict__ B, float* __restrict__ C,
    float* __restrict__ ws, int M, int N, int K, int kt_per_split) {
  using P = F32Plan<TM, TN>;
  constexpr int RM = P::RM, RN = P::RN, AS = P::AS;
  static_assert(RN % 4 == 0, "columns come in float4 groups");
  extern __shared__ __align__(16) float fsm[];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN, z = blockIdx.z;
  const int kt_total = (K + F_BK - 1) / F_BK;
  const int kt0 = z * kt_per_split, nk = min(kt0 + kt_per_split, kt_total) - kt0;

  auto load = [&](int st, int kt) {
    float* sA = fsm + st * P::STAGE_FLOATS;
    float* sB = sA + TM * AS;
    const int k0 = kt * F_BK;
    if constexpr (VEC) {
      for (int i = tid; i < TM * F_BK / 4; i += F_THREADS) {
        const int r = i / (F_BK / 4), c = (i % (F_BK / 4)) * 4;
        const bool ok = m0 + r < M && k0 + c < K;
        cp_async16(sA + r * AS + c, ok ? A + (size_t)(m0 + r) * K + k0 + c : A, ok);
      }
      for (int i = tid; i < F_BK * TN / 4; i += F_THREADS) {
        const int r = i / (TN / 4), c = (i % (TN / 4)) * 4;
        const bool ok = k0 + r < K && n0 + c < N;
        cp_async16(sB + r * TN + c, ok ? B + (size_t)(k0 + r) * N + n0 + c : B, ok);
      }
    } else {
      for (int i = tid; i < TM * F_BK; i += F_THREADS) {
        const int r = i / F_BK, c = i % F_BK;
        const bool ok = m0 + r < M && k0 + c < K;
        cp_async4(sA + r * AS + c, ok ? A + (size_t)(m0 + r) * K + k0 + c : A, ok);
      }
      for (int i = tid; i < F_BK * TN; i += F_THREADS) {
        const int r = i / TN, c = i % TN;
        const bool ok = k0 + r < K && n0 + c < N;
        cp_async4(sB + r * TN + c, ok ? B + (size_t)(k0 + r) * N + n0 + c : B, ok);
      }
    }
  };

  float acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < F_STAGES - 1; ++s) {
    if (s < nk) load(s, kt0 + s);
    cp_async_commit();
  }
  for (int it = 0; it < nk; ++it) {
    cp_async_wait<F_STAGES - 2>();          // tile `it` has landed
    __syncthreads();                        // ... for every thread; tile it-1 is read
    if (it + F_STAGES - 1 < nk) load((it + F_STAGES - 1) % F_STAGES, kt0 + it + F_STAGES - 1);
    cp_async_commit();
    const float* sA = fsm + (it % F_STAGES) * P::STAGE_FLOATS;
    const float* sB = sA + TM * AS;
#pragma unroll
    for (int kq = 0; kq < F_BK; kq += 4) {
      float4 a4[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        a4[i] = *reinterpret_cast<const float4*>(sA + f32_row<TM, RM>(ty, i) * AS + kq);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float b[RN];
#pragma unroll
        for (int cg = 0; cg < RN / 4; ++cg)
          *reinterpret_cast<float4*>(b + 4 * cg) = *reinterpret_cast<const float4*>(
              sB + (kq + kk) * TN + cg * (TN * 4 / RN) + tx * 4);
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          const float a = reinterpret_cast<const float*>(&a4[i])[kk];
#pragma unroll
          for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(a, b[j], acc[i][j]);
        }
      }
    }
  }

  float* dst = gridDim.z == 1 ? C : ws + (size_t)z * M * N;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = m0 + f32_row<TM, RM>(ty, i);
    if (r >= M) continue;
#pragma unroll
    for (int cg = 0; cg < RN / 4; ++cg) {
      const int c = n0 + cg * (TN * 4 / RN) + tx * 4;
      float* row = dst + (size_t)r * N;
      if (VEC && c < N) {
        *reinterpret_cast<float4*>(row + c) = make_float4(
            acc[i][4 * cg], acc[i][4 * cg + 1], acc[i][4 * cg + 2], acc[i][4 * cg + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c + e < N) row[c + e] = acc[i][4 * cg + e];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Split-K: the planes summed in a fixed order, rounded once
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) { return __float2bfloat16_rn(x); }

template <typename T>
__global__ void splitk_reduce_kernel(const float* __restrict__ ws, T* __restrict__ C,
                                     size_t mn, int split) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < mn;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < split; ++z) s += ws[(size_t)z * mn + i];
    C[i] = from_f32<T>(s);
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

template <typename Kern>
int set_smem(Kern kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int BN>
int launch_wgmma(const void* a, const void* b, void* c, float* ws, int M, int N, int K,
                 int split, int kt_per_split, int max_blocks, cudaStream_t s) {
  using P = WgPlan<BN>;
  CUtensorMap map_a, map_b;
  const uint64_t dims_a[2] = {(uint64_t)K, (uint64_t)M}, strides_a[1] = {(uint64_t)K * 2};
  const uint32_t box_a[2] = {WG_BK, WG_BM};
  const uint64_t dims_b[2] = {(uint64_t)N, (uint64_t)K}, strides_b[1] = {(uint64_t)N * 2};
  const uint32_t box_b[2] = {64, WG_BK};
  int err = sm90::encode_bf16_map(&map_a, 2, a, dims_a, strides_a, box_a, 128);
  if (err) return err;
  err = sm90::encode_bf16_map(&map_b, 2, b, dims_b, strides_b, box_b, 128);
  if (err) return err;
  err = set_smem(matmul_wgmma_kernel<BN>, P::SMEM);
  if (err) return err;
  const int tiles_m = (M + WG_BM - 1) / WG_BM, tiles_n = (N + BN - 1) / BN;
  const int work = tiles_m * tiles_n * split;
  const int grid = work < max_blocks ? work : max_blocks;
  matmul_wgmma_kernel<BN><<<grid, WG_THREADS, P::SMEM, s>>>(
      map_a, map_b, static_cast<bf16*>(c), ws, M, N, K, tiles_m, work, split, kt_per_split);
  return (int)cudaGetLastError();
}

template <int TM, int TN>
int launch_f32(bool vec, const void* a, const void* b, void* c, float* ws, int M, int N, int K,
               int split, int kt_per_split, cudaStream_t s) {
  using P = F32Plan<TM, TN>;
  dim3 grid((N + TN - 1) / TN, (M + TM - 1) / TM, split);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  const float* A = static_cast<const float*>(a);
  const float* B = static_cast<const float*>(b);
  float* C = static_cast<float*>(c);
  if (vec) {
    int err = set_smem(matmul_f32_kernel<TM, TN, true>, P::SMEM);
    if (err) return err;
    matmul_f32_kernel<TM, TN, true><<<grid, F_THREADS, P::SMEM, s>>>(A, B, C, ws, M, N, K,
                                                                      kt_per_split);
  } else {
    int err = set_smem(matmul_f32_kernel<TM, TN, false>, P::SMEM);
    if (err) return err;
    matmul_f32_kernel<TM, TN, false><<<grid, F_THREADS, P::SMEM, s>>>(A, B, C, ws, M, N, K,
                                                                       kt_per_split);
  }
  return (int)cudaGetLastError();
}

// The dynamic shared memory of one block of a plan's kernel, as its
// launcher passes it: the f32 kernels' F32Plan::SMEM, the wgmma kernel's
// WgPlan::SMEM, none for the element-wise bf16 kernel (static tiles); -1
// for a tile the variant is not compiled for.
int plan_smem(int variant, int tile_m, int tile_n) {
  if (variant == 0 || variant == 1) {
    if (tile_m == 128 && tile_n == 128) return F32Plan<128, 128>::SMEM;
    if (tile_m == 64 && tile_n == 128) return F32Plan<64, 128>::SMEM;
    if (tile_m == 64 && tile_n == 64) return F32Plan<64, 64>::SMEM;
    if (tile_m == 32 && tile_n == 64) return F32Plan<32, 64>::SMEM;
  } else if (variant == 2 && tile_m == WG_BM) {
    if (tile_n == 256) return WgPlan<256>::SMEM;
    if (tile_n == 64) return WgPlan<64>::SMEM;
  } else if (variant == 3 && tile_m == EM && tile_n == EN) {
    return 0;
  }
  return -1;
}

template <typename Kern>
int blocks_per_sm(Kern kernel, int threads, int smem) {
  int err = set_smem(kernel, smem);
  int n = 0;
  if (!err) err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, smem);
  return err ? -err : n;
}

template <int TM, int TN>
int f32_occupancy(bool vec) {
  return vec ? blocks_per_sm(matmul_f32_kernel<TM, TN, true>, F_THREADS, F32Plan<TM, TN>::SMEM)
             : blocks_per_sm(matmul_f32_kernel<TM, TN, false>, F_THREADS, F32Plan<TM, TN>::SMEM);
}

int plan_occupancy(int variant, int tile_m, int tile_n) {
  const bool vec = variant == 0;
  if (variant == 0 || variant == 1) {
    if (tile_m == 128 && tile_n == 128) return f32_occupancy<128, 128>(vec);
    if (tile_m == 64 && tile_n == 128) return f32_occupancy<64, 128>(vec);
    if (tile_m == 64 && tile_n == 64) return f32_occupancy<64, 64>(vec);
    if (tile_m == 32 && tile_n == 64) return f32_occupancy<32, 64>(vec);
  } else if (variant == 2 && tile_m == WG_BM) {
    if (tile_n == 256) return blocks_per_sm(matmul_wgmma_kernel<256>, WG_THREADS, WgPlan<256>::SMEM);
    if (tile_n == 64) return blocks_per_sm(matmul_wgmma_kernel<64>, WG_THREADS, WgPlan<64>::SMEM);
  } else if (variant == 3 && tile_m == EM && tile_n == EN) {
    return blocks_per_sm(matmul_bf16_elem_kernel, E_THREADS, 0);
  }
  return -(int)cudaErrorInvalidValue;
}

}  // namespace

// A: (M, K), B: (K, N), C: (M, N), all contiguous and of one dtype, as the
// planner (kernel.py:plan) chose: variant 0 = f32 with 16-byte rows, 1 = f32
// element-wise, 2 = bf16 wgmma (16-byte rows and pointers), 3 = bf16
// element-wise; tile_m x tile_n output tiles; K cut into `split` ranges of
// whole k-tiles, none empty.  With split > 1, `ws` holds split x M x N
// floats.  `max_blocks` caps the persistent grid (the SM count).  Returns 0,
// a cudaError_t, or sm90::kTensorMapError + a CUresult.
extern "C" int matmul_fwd(const void* a, const void* b, void* c, void* ws, int M, int N, int K,
                          int variant, int tile_m, int tile_n, int split, int max_blocks,
                          void* stream) {
  if (M < 1 || N < 1 || K < 1 || split < 1 || max_blocks < 1 || (split > 1 && !ws))
    return (int)cudaErrorInvalidValue;
  const int k_step = variant == 2 ? WG_BK : variant == 3 ? EK : F_BK;
  const int kt_total = (K + k_step - 1) / k_step;
  const int kt_per_split = (kt_total + split - 1) / split;
  if ((split - 1) * kt_per_split >= kt_total || split > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* W = static_cast<float*>(ws);
  int err = (int)cudaErrorInvalidValue;
  const bool vec = variant == 0;
  if (variant == 0 || variant == 1) {
    if (tile_m == 128 && tile_n == 128)
      err = launch_f32<128, 128>(vec, a, b, c, W, M, N, K, split, kt_per_split, s);
    else if (tile_m == 64 && tile_n == 128)
      err = launch_f32<64, 128>(vec, a, b, c, W, M, N, K, split, kt_per_split, s);
    else if (tile_m == 64 && tile_n == 64)
      err = launch_f32<64, 64>(vec, a, b, c, W, M, N, K, split, kt_per_split, s);
    else if (tile_m == 32 && tile_n == 64)
      err = launch_f32<32, 64>(vec, a, b, c, W, M, N, K, split, kt_per_split, s);
  } else if (variant == 2 && tile_m == WG_BM && K % 8 == 0 && N % 8 == 0) {
    if (tile_n == 256)
      err = launch_wgmma<256>(a, b, c, W, M, N, K, split, kt_per_split, max_blocks, s);
    else if (tile_n == 64)
      err = launch_wgmma<64>(a, b, c, W, M, N, K, split, kt_per_split, max_blocks, s);
  } else if (variant == 3 && tile_m == EM && tile_n == EN) {
    dim3 grid((N + EN - 1) / EN, (M + EM - 1) / EM, split);
    if (grid.y <= 65535) {
      matmul_bf16_elem_kernel<<<grid, E_THREADS, 0, s>>>(
          static_cast<const bf16*>(a), static_cast<const bf16*>(b), static_cast<bf16*>(c), W,
          M, N, K, kt_per_split);
      err = (int)cudaGetLastError();
    }
  }
  if (err || split == 1) return err;
  const size_t mn = (size_t)M * N;
  const int threads = 256;
  const size_t want = (mn + threads - 1) / threads;
  const int blocks = (int)(want < (size_t)max_blocks * 8 ? want : (size_t)max_blocks * 8);
  if (variant == 0 || variant == 1)
    splitk_reduce_kernel<float><<<blocks, threads, 0, s>>>(W, static_cast<float*>(c), mn, split);
  else
    splitk_reduce_kernel<bf16><<<blocks, threads, 0, s>>>(W, static_cast<bf16*>(c), mn, split);
  return (int)cudaGetLastError();
}

// The dynamic shared memory (bytes) of one block of a plan's kernel
// (variant and tile as matmul_fwd takes them; the planner's mirror,
// matmul_fwd/kernel.py:smem_bytes); -1 for a tile that is not compiled.
extern "C" int matmul_smem(int variant, int tile_m, int tile_n) {
  return plan_smem(variant, tile_m, tile_n);
}

// The library's launch query: kernel 0, a plan's product kernel (p0 the
// variant, p1 tile_m, p2 tile_n); kernel 1, the split-K reduction (p0 the
// dtype, 0 = float32, 1 = bfloat16).  Blocks an SM from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor with the launch's dynamic
// shared memory, or minus a cudaError_t.
extern "C" int matmul_fwd_occupancy(int kernel, int p0, int p1, int p2, int p3, int p4) {
  (void)p3, (void)p4;
  if (kernel == 0) return plan_occupancy(p0, p1, p2);
  if (kernel == 1 && p0 == 0) return blocks_per_sm(splitk_reduce_kernel<float>, 256, 0);
  if (kernel == 1 && p0 == 1) return blocks_per_sm(splitk_reduce_kernel<bf16>, 256, 0);
  return -(int)cudaErrorInvalidValue;
}
