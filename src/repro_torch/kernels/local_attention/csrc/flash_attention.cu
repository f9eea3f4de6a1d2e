// Flash attention (causal, full, sliding-window; GQA) for Hopper (sm_90a),
// plain C interface.
//
// Replaces: src/repro/kernels/local_attention/kernel.py:flash_attention_pallas,
// the attention of every `local` layer in a cache-free forward (RecurrentGemma:
// causal, window 2048, Hq 10 over Hkv 1, head width 256, bf16).
//
//   out[b, h, i] = softmax_j(scale * q[b, h, i] . k[b, h / group, j]) v[..., j]
//
// over the visible pairs only: key j < S, query i < T and, with the decode
// offset o = S - T, causal j <= i + o and (window W) j > i + o - W, or
// non-causal with a window |j - i| < W.  A row that sees no key gives 0.
//
// What bounds it: operations.  At B=1, T=4096, W=2048, Hq=10, D=256 the
// visible pairs are about 10 * 4096 * 2048 and each costs 4 D flops (q.k and
// p.v): about 6.4e10 flops, 65 us at 989 TFLOP/s bf16, against 46 MB of
// q/k/v/out (14 us at 3.35 TB/s).
//
// Design.  The Pallas kernel swept a (B*H, q-block, kv-step) grid with the
// online-softmax state (m, l, acc) in VMEM scratch across the kv steps.
// Here the kv steps are a loop inside one block per (q tile, batch * head):
// the block loads its Q tile into shared memory once, then walks only the
// K/V tiles the mask can reach (the window's band, as `_kv_block_index`
// does), with (m, l, acc) in registers for the whole walk.  GQA: a block
// reads the K/V of head h / group; the ten q heads of RecurrentGemma each
// load the shared K/V tile separately (sharing it is later work).
//
// bf16 inputs take the tensor cores: four warps each own 16 query rows;
// S = Q K^T and O += P V are mma.sync m16n8k16 products (bf16 in, f32 sums)
// fed by ldmatrix from padded shared-memory rows (D + 8 halfs a row, so the
// eight rows of each 8x8 fragment fall in distinct banks); P is rounded to
// bf16 for the second product, as FlashAttention does.  At head width 256 a
// 64-row Q tile and 32-row K and V tiles take 67.6 KB of dynamic shared
// memory (above the 48 KB default, so the launch raises the limit first),
// and the 16 x 256 f32 accumulator of a warp is 128 registers a thread.
// Tiles are loaded synchronously: cp.async/TMA double buffering and wgmma
// are later work.  float32 inputs take a CUDA-core kernel with f32 products
// throughout (no TF32), one warp per four query rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

struct Mask {
  int T, S, offset, window;   // window < 1: none
  int causal;

  __device__ __forceinline__ bool visible(int q, int k) const {
    if (q >= T || k >= S) return false;
    if (causal) {
      if (k > q + offset) return false;
      return window < 1 || k > q + offset - window;
    }
    return window < 1 || abs(k - q) < window;
  }

  // Keys [lo, hi) that some query of [q0, q1) can see (empty if hi <= lo).
  __device__ __forceinline__ void key_range(int q0, int q1, int& lo, int& hi) const {
    q1 = min(q1, T);
    lo = 0;
    hi = S;
    if (causal) {
      hi = min(S, q1 + offset);
      if (window >= 1) lo = max(0, q0 + offset - window + 1);
    } else if (window >= 1) {
      lo = max(0, q0 - window + 1);
      hi = min(S, q1 - 1 + window);
    }
  }
};

// ---------------------------------------------------------------------------
// bf16: tensor-core kernel
// ---------------------------------------------------------------------------

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Rows [row0, row0 + nrows) of a (rows, D) bf16 matrix into shared memory
// rows of stride D + 8; rows at or past `limit` are zeros.
template <int D>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int row0,
                                          int nrows, int limit) {
  constexpr int VEC = D / 8;          // 16-byte pieces per row
  for (int i = threadIdx.x; i < nrows * VEC; i += blockDim.x) {
    const int r = i / VEC, c = (i % VEC) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < limit)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + c);
    *reinterpret_cast<uint4*>(dst + r * (D + 8) + c) = val;
  }
}

constexpr int BQ = 64;                // query rows per block (16 per warp)
constexpr int NW = 4;                 // warps per block

template <int D, int BK>
__global__ void __launch_bounds__(NW * 32) flash_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ out, int Hq, int group,
    Mask mask, float scale_log2) {
  constexpr int STR = D + 8;          // shared row stride, in halfs
  constexpr int NT = D / 8;           // 8-wide column tiles of the output
  constexpr int NS = BK / 8;          // 8-wide key tiles of the scores
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + BQ * STR;
  bf16* sV = sK + BK * STR;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / Hq, hq = bh - b * Hq;
  const size_t kv_off = (size_t)(b * (Hq / group) + hq / group) * mask.S * D;
  const bf16* kg = k + kv_off;
  const bf16* vg = v + kv_off;
  const int q0 = blockIdx.x * BQ;

  load_rows<D>(sQ, q + (size_t)bh * mask.T * D, q0, BQ, mask.T);
  int lo, hi;
  mask.key_range(q0, q0 + BQ, lo, hi);

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_run[2] = {neg_inf(), neg_inf()};
  float l_run[2] = {0.f, 0.f};            // this thread's share of each row sum
  const int row0 = q0 + warp * 16 + g;    // this thread's rows: row0, row0 + 8
  const uint32_t q_addr = smem_u32(sQ + (warp * 16 + (lane & 15)) * STR + (lane >> 4) * 8);

  for (int kb = (lo / BK) * BK; kb < hi; kb += BK) {
    __syncthreads();                      // the previous K/V tiles are consumed
    load_rows<D>(sK, kg, kb, BK, mask.S);
    load_rows<D>(sV, vg, kb, BK, mask.S);
    __syncthreads();

    // S = Q K^T: 16 rows x BK keys per warp.
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t a[4];
      ldsm_x4(a, q_addr + kk * 2);
#pragma unroll
      for (int j = 0; j < NS; j += 2) {
        uint32_t bk[4];
        ldsm_x4(bk, smem_u32(sK + (j * 8 + (lane & 7) + ((lane >> 4) << 3)) * STR +
                             kk + ((lane >> 3) & 1) * 8));
        mma_bf16(s[j], a, bk[0], bk[1]);
        mma_bf16(s[j + 1], a, bk[2], bk[3]);
      }
    }

    // Mask, scale (log2 domain) and the online-softmax update.
    float mx[2] = {neg_inf(), neg_inf()};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row0 + (e >> 1) * 8, c = kb + j * 8 + tig * 2 + (e & 1);
        const float val = mask.visible(r, c) ? s[j][e] * scale_log2 : neg_inf();
        s[j][e] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
      }
    float base[2], alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_run[i], mx[i]);
      base[i] = m_new == neg_inf() ? 0.f : m_new;   // no key seen yet: all p = 0
      alpha[i] = exp2f(m_run[i] - base[i]);
      m_run[i] = m_new;
      l_run[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[j][e] - base[e >> 1]);
        s[j][e] = p;
        l_run[e >> 1] += p;
      }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += P V: P's C fragments are the A fragments of the second product.
#pragma unroll
    for (int kj = 0; kj < BK / 16; ++kj) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kj][0], s[2 * kj][1]), pack_bf16(s[2 * kj][2], s[2 * kj][3]),
          pack_bf16(s[2 * kj + 1][0], s[2 * kj + 1][1]),
          pack_bf16(s[2 * kj + 1][2], s[2 * kj + 1][3])};
      const bf16* v_row = sV + (kj * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * STR + (lane >> 4) * 8;
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, smem_u32(v_row + n * 8));
        mma_bf16(acc[n], pa, bv[0], bv[1]);
        mma_bf16(acc[n + 1], pa, bv[2], bv[3]);
      }
    }
  }

  bf16* og = out + (size_t)bh * mask.T * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int r = row0 + i * 8;
    if (r >= mask.T) continue;
    const float inv = l > 0.f ? 1.f / l : 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<__nv_bfloat162*>(og + (size_t)r * D + n * 8 + tig * 2) =
          __floats2bfloat162_rn(acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
  }
}

// ---------------------------------------------------------------------------
// float32: CUDA-core kernel
// ---------------------------------------------------------------------------

constexpr int F_BQ = 16;     // query rows per block
constexpr int F_RPW = 4;     // query rows per warp
constexpr int F_BK = 32;     // keys per tile (one per lane)

template <int D>
__global__ void __launch_bounds__(NW * 32) flash_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out, int Hq, int group,
    Mask mask, float scale) {
  constexpr int CPL = D / 32;         // output columns per lane
  constexpr int KSTR = D + 1;         // padded K rows: lane j reads row j
  extern __shared__ __align__(16) float smf[];
  float* sQ = smf;                    // F_BQ x D
  float* sK = sQ + F_BQ * D;          // F_BK x KSTR
  float* sV = sK + F_BK * KSTR;       // F_BK x D

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bh = blockIdx.y;
  const int b = bh / Hq, hq = bh - b * Hq;
  const size_t kv_off = (size_t)(b * (Hq / group) + hq / group) * mask.S * D;
  const float* qg = q + (size_t)bh * mask.T * D;
  const int q0 = blockIdx.x * F_BQ;
  for (int i = threadIdx.x; i < F_BQ * D; i += blockDim.x) {
    const int r = i / D;
    sQ[i] = q0 + r < mask.T ? qg[(size_t)q0 * D + i] : 0.f;
  }
  int lo, hi;
  mask.key_range(q0, q0 + F_BQ, lo, hi);

  float acc[F_RPW][CPL];
  float m_run[F_RPW], l_run[F_RPW];
#pragma unroll
  for (int r = 0; r < F_RPW; ++r) {
    m_run[r] = neg_inf();
    l_run[r] = 0.f;
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[r][c] = 0.f;
  }

  for (int kb = (lo / F_BK) * F_BK; kb < hi; kb += F_BK) {
    __syncthreads();
    for (int i = threadIdx.x; i < F_BK * D; i += blockDim.x) {
      const int r = i / D, c = i - r * D;
      const bool in = kb + r < mask.S;
      sK[r * KSTR + c] = in ? k[kv_off + (size_t)(kb + r) * D + c] : 0.f;
      sV[i] = in ? v[kv_off + (size_t)(kb + r) * D + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < F_RPW; ++rr) {
      const int rl = warp * F_RPW + rr;
      float sc = 0.f;
      for (int c = 0; c < D; ++c) sc = fmaf(sQ[rl * D + c], sK[lane * KSTR + c], sc);
      sc = mask.visible(q0 + rl, kb + lane) ? sc * scale : neg_inf();
      float mx = sc;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_run[rr], mx);
      const float base = m_new == neg_inf() ? 0.f : m_new;
      const float alpha = expf(m_run[rr] - base);
      const float p = expf(sc - base);
      float ps = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l_run[rr] = l_run[rr] * alpha + ps;
      m_run[rr] = m_new;
#pragma unroll
      for (int c = 0; c < CPL; ++c) acc[rr][c] *= alpha;
      for (int j = 0; j < F_BK; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
        for (int c = 0; c < CPL; ++c) acc[rr][c] = fmaf(pj, sV[j * D + lane + 32 * c], acc[rr][c]);
      }
    }
  }

  float* og = out + (size_t)bh * mask.T * D;
#pragma unroll
  for (int rr = 0; rr < F_RPW; ++rr) {
    const int r = q0 + warp * F_RPW + rr;
    if (r >= mask.T) continue;
    const float inv = l_run[rr] > 0.f ? 1.f / l_run[rr] : 0.f;
#pragma unroll
    for (int c = 0; c < CPL; ++c) og[(size_t)r * D + lane + 32 * c] = acc[rr][c] * inv;
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

template <int D, int BK>
int launch_bf16(const void* q, const void* k, const void* v, void* out, int B,
                int Hq, int group, const Mask& mask, float scale, cudaStream_t s) {
  const int smem = (BQ + 2 * BK) * (D + 8) * (int)sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bf16_kernel<D, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((mask.T + BQ - 1) / BQ, B * Hq);
  flash_bf16_kernel<D, BK><<<grid, NW * 32, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), Hq, group, mask,
      scale * kLog2e);
  return (int)cudaGetLastError();
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* out, int B,
               int Hq, int group, const Mask& mask, float scale, cudaStream_t s) {
  const int smem = (F_BQ * D + F_BK * (D + 1) + F_BK * D) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((mask.T + F_BQ - 1) / F_BQ, B * Hq);
  flash_f32_kernel<D><<<grid, NW * 32, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), Hq, group, mask, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (B, Hq, T, D); k, v: (B, Hkv, S, D); out: (B, Hq, T, D); all contiguous,
// one dtype: 0 = float32, 1 = bfloat16.  D in {32, 64, 128, 256}; Hkv | Hq.
// causal: 0 or 1; window < 1 means none.  Returns 0 or a cudaError_t.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* out, int B, int Hq, int Hkv, int T,
                                   int S, int D, int causal, int window,
                                   float scale, int dtype, void* stream) {
  if (B < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv || T < 1 || S < 1 ||
      B * Hq > 65535)
    return (int)cudaErrorInvalidValue;
  const Mask mask{T, S, S - T, window, causal ? 1 : 0};
  const int group = Hq / Hkv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    switch (D) {
      case 32: return launch_bf16<32, 64>(q, k, v, out, B, Hq, group, mask, scale, s);
      case 64: return launch_bf16<64, 64>(q, k, v, out, B, Hq, group, mask, scale, s);
      case 128: return launch_bf16<128, 64>(q, k, v, out, B, Hq, group, mask, scale, s);
      case 256: return launch_bf16<256, 32>(q, k, v, out, B, Hq, group, mask, scale, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (dtype == 0) {
    switch (D) {
      case 32: return launch_f32<32>(q, k, v, out, B, Hq, group, mask, scale, s);
      case 64: return launch_f32<64>(q, k, v, out, B, Hq, group, mask, scale, s);
      case 128: return launch_f32<128>(q, k, v, out, B, Hq, group, mask, scale, s);
      case 256: return launch_f32<256>(q, k, v, out, B, Hq, group, mask, scale, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaErrorInvalidValue;
}
