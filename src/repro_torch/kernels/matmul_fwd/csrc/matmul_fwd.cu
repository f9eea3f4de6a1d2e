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
// suite's 256^3 the bound is under 1 us and the launch sets the time.
//
// Design: the paper's operand forwarding is block residency.  The Pallas
// kernel pulled an A and a B tile into VMEM once and let the MXU reuse each
// element along the other operand's dimension, with the f32 sum in a VMEM
// scratch across a sequential K grid axis.  Here the K axis is a loop
// inside one block per 128 x 128 output tile, the sum lives in registers for
// the whole loop, and each A / B element loaded into shared memory is reused
// by every warp that needs it (the thread (0,2) -> (1,2) -> (2,2) chain of
// Fig. 3 becomes a shared-memory broadcast).  The block contract of the
// reference (min(block, dim) divides the dim) is checked by the wrapper; the
// kernel picks its own tiles and guards every edge, so any M, N, K works.
// - bf16: eight warps, each a 64 x 32 piece of the tile, run mma.sync
//   m16n8k16 (bf16 in, f32 sums) on fragments that ldmatrix reads from
//   shared memory; rows are padded by 8 halfs so the eight rows of each 8x8
//   fragment fall in distinct banks.  A and B tiles (128 x 32, 32 x 128) come
//   in by cp.async, two stages deep, the next tile in flight while the
//   tensor cores work on this one; out-of-range chunks are zero-filled.  A
//   bf16 x bf16 product is exact in f32, so this is the reference's "cast to
//   f32, then an f32 dot" up to the order of the sums.  Where a row is not
//   16-byte aligned (K or N not a multiple of 8) the tiles are loaded
//   element by element instead.
// - f32: a register-tiled CUDA-core kernel, 256 threads each holding an
//   8 x 8 piece of the 128 x 128 tile, k-steps of 8 through shared memory
//   (A stored transposed), the next step's tile prefetched into registers.
//   f32 fused multiply-adds throughout: no TF32, as the reference's f32 dot.
// The output is rounded once to A's dtype (round-to-nearest-even for
// bf16).  wgmma and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BM = 128, BN = 128;
constexpr int NTHREADS = 256;

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int BK = 32;
constexpr int ASTR = BK + 8;     // A tile row stride, halfs
constexpr int BSTR = BN + 8;     // B tile row stride, halfs

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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

// 16 bytes global -> shared, asynchronously; zero-filled when !ok.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// The A tile (BM x BK at (m0, k0)) and the B tile (BK x BN at (k0, n0)) into
// shared memory, zeros outside the matrices.  VEC: 16-byte chunks by
// cp.async (rows 16-byte aligned: K % 8 == 0 and N % 8 == 0); otherwise one
// element at a time.
template <bool VEC>
__device__ __forceinline__ void load_tiles_bf16(bf16* sA, bf16* sB, const bf16* A,
                                                const bf16* B, int M, int N, int K,
                                                int m0, int n0, int k0) {
  const bf16 zero = __float2bfloat16(0.f);
  if (VEC) {
    for (int i = threadIdx.x; i < BM * BK / 8; i += NTHREADS) {
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      const bool ok = m0 + r < M && k0 + c < K;
      cp_async16(sA + r * ASTR + c, ok ? A + (size_t)(m0 + r) * K + k0 + c : A, ok);
    }
    for (int i = threadIdx.x; i < BK * BN / 8; i += NTHREADS) {
      const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
      const bool ok = k0 + r < K && n0 + c < N;
      cp_async16(sB + r * BSTR + c, ok ? B + (size_t)(k0 + r) * N + n0 + c : B, ok);
    }
  } else {
    for (int i = threadIdx.x; i < BM * BK; i += NTHREADS) {
      const int r = i / BK, c = i % BK;
      sA[r * ASTR + c] = (m0 + r < M && k0 + c < K) ? A[(size_t)(m0 + r) * K + k0 + c] : zero;
    }
    for (int i = threadIdx.x; i < BK * BN; i += NTHREADS) {
      const int r = i / BN, c = i % BN;
      sB[r * BSTR + c] = (k0 + r < K && n0 + c < N) ? B[(size_t)(k0 + r) * N + n0 + c] : zero;
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(NTHREADS) matmul_bf16_kernel(
    const bf16* __restrict__ A, const bf16* __restrict__ B, bf16* __restrict__ C,
    int M, int N, int K) {
  __shared__ __align__(16) bf16 sA[2][BM * ASTR];
  __shared__ __align__(16) bf16 sB[2][BK * BSTR];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;   // 2 x 4 warps
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  const int kt_n = (K + BK - 1) / BK;
  load_tiles_bf16<VEC>(sA[0], sB[0], A, B, M, N, K, m0, n0, 0);
  cp_async_commit();
  for (int kt = 0; kt < kt_n; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < kt_n)
      load_tiles_bf16<VEC>(sA[st ^ 1], sB[st ^ 1], A, B, M, N, K, m0, n0, (kt + 1) * BK);
    cp_async_commit();
    cp_async_wait_1();           // every group but the newest: tile kt is in
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldsm_x4(af[mi], smem_u32(sA[st] + (wm + mi * 16 + (lane & 15)) * ASTR + kk +
                                 (lane >> 4) * 8));
#pragma unroll
      for (int nj = 0; nj < 4; nj += 2) {
        uint32_t t[4];
        ldsm_x4_trans(t, smem_u32(sB[st] + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * BSTR +
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
    __syncthreads();             // this stage is read before it is refilled
  }

#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int nj = 0; nj < 4; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = m0 + wm + mi * 16 + g + (e >> 1) * 8;
        const int c = n0 + wn + nj * 8 + tig * 2 + (e & 1);
        if (r < M && c < N) C[(size_t)r * N + c] = __float2bfloat16_rn(acc[mi][nj][e]);
      }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int FBK = 8;
constexpr int FPAD = 4;          // keeps float4 rows aligned, spreads banks

__global__ void __launch_bounds__(NTHREADS) matmul_f32_kernel(
    const float* __restrict__ A, const float* __restrict__ B, float* __restrict__ C,
    int M, int N, int K) {
  __shared__ __align__(16) float sA[2][FBK][BM + FPAD];   // transposed: [k][m]
  __shared__ __align__(16) float sB[2][FBK][BN + FPAD];
  const int tid = threadIdx.x;
  const int tm = (tid / 16) * 8, tn = (tid % 16) * 8;     // this thread's 8 x 8
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  float ra[4], rb[4];            // the next k-step's tiles, in flight
  auto fetch = [&](int k0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = tid + j * NTHREADS;
      const int ar = i / FBK, ac = i % FBK;               // A: 128 rows x 8
      ra[j] = (m0 + ar < M && k0 + ac < K) ? A[(size_t)(m0 + ar) * K + k0 + ac] : 0.f;
      const int br = i / BN, bc = i % BN;                 // B: 8 rows x 128
      rb[j] = (k0 + br < K && n0 + bc < N) ? B[(size_t)(k0 + br) * N + n0 + bc] : 0.f;
    }
  };
  auto put = [&](int st) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = tid + j * NTHREADS;
      sA[st][i % FBK][i / FBK] = ra[j];
      sB[st][i / BN][i % BN] = rb[j];
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int kt_n = (K + FBK - 1) / FBK;
  fetch(0);
  put(0);
  __syncthreads();
  for (int kt = 0; kt < kt_n; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < kt_n) fetch((kt + 1) * FBK);
#pragma unroll
    for (int k = 0; k < FBK; ++k) {
      float a[8], b[8];
      *reinterpret_cast<float4*>(a) = *reinterpret_cast<const float4*>(&sA[st][k][tm]);
      *reinterpret_cast<float4*>(a + 4) = *reinterpret_cast<const float4*>(&sA[st][k][tm + 4]);
      *reinterpret_cast<float4*>(b) = *reinterpret_cast<const float4*>(&sB[st][k][tn]);
      *reinterpret_cast<float4*>(b + 4) = *reinterpret_cast<const float4*>(&sB[st][k][tn + 4]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (kt + 1 < kt_n) put(st ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = m0 + tm + i, c = n0 + tn + j;
      if (r < M && c < N) C[(size_t)r * N + c] = acc[i][j];
    }
}

}  // namespace

// A: (M, K), B: (K, N), C: (M, N), all contiguous and of one dtype:
// 0 = float32, 1 = bfloat16.  Returns 0 or the cudaError_t of the launch.
extern "C" int matmul_fwd(const void* a, const void* b, void* c, int M, int N, int K,
                          int dtype, void* stream) {
  if (M < 1 || N < 1 || K < 1 || (M + BM - 1) / BM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (dtype == 1) {
    const bool vec = K % 8 == 0 && N % 8 == 0 &&
                     reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(b) % 16 == 0;
    const bf16* A = static_cast<const bf16*>(a);
    const bf16* B = static_cast<const bf16*>(b);
    bf16* C = static_cast<bf16*>(c);
    if (vec)
      matmul_bf16_kernel<true><<<grid, NTHREADS, 0, s>>>(A, B, C, M, N, K);
    else
      matmul_bf16_kernel<false><<<grid, NTHREADS, 0, s>>>(A, B, C, M, N, K);
    return (int)cudaGetLastError();
  }
  if (dtype == 0) {
    matmul_f32_kernel<<<grid, NTHREADS, 0, s>>>(static_cast<const float*>(a),
                                                static_cast<const float*>(b),
                                                static_cast<float*>(c), M, N, K);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}
