// 5-point stencil (hotspot / SRAD) for Hopper (sm_90a), plain C interface.
//
// Replaces: src/repro/kernels/stencil2d/kernel.py:stencil2d_pallas, reached
// through repro_torch.kernels.stencil2d.ops.stencil2d.
//
//   out[i, j] = c0 x[i, j] + c1 x[i-1, j] + c2 x[i+1, j] + c3 x[i, j-1]
//             + c4 x[i, j+1]
//
// with every out-of-grid neighbour read as the constant `boundary` (the
// elevator constant C).
//
// What bounds it: device-memory bytes.  Each element is read once and each
// output written once: at 8192 x 8192 in f32 that is 537 MB, 160 us at
// 3.35 TB/s, against 9 flops an element (0.6 GFLOP, 9 us at 67 TFLOP/s).
//
// Design: the paper's elevator in Hopper terms.  The Pallas kernel loaded a
// block of rows plus the neighbouring blocks' halo rows into VMEM and took
// column neighbours by lane rotates.  Here one warp owns a strip 32 columns
// wide and ROWS rows deep, one thread a column:
// - rows: each thread loads its column's ROWS rows plus one halo row above
//   and one below into registers, all loads issued before any arithmetic,
//   then walks down carrying up / cur / down.  Each element is read from
//   device memory once, plus two halo rows a strip (2 / ROWS more);
// - columns: the left and right neighbours arrive by __shfl_up_sync /
//   __shfl_down_sync, register to register (the elevator with delta = +-1);
//   lanes 0 and 31 have no producer in the warp and load their one missing
//   neighbour themselves (the eLDST case), or take `boundary` at the grid's
//   edge.
// Any H and any W: the ragged strip masks its loads and stores, and the
// threads past W still take part in the shuffles.
//
// Rounding: the sum runs in f32 in the plain version's order (c0 x first,
// each product rounded before it is added: __fmul_rn then __fadd_rn, so no
// fused multiply-add), and the output is rounded once to its dtype
// (round-to-nearest-even for bf16), so f32 and bf16 outputs equal the plain
// PyTorch version's bit for bit.  The coefficients come in as a device
// pointer (f32), so a call needs no host synchronisation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;    // strips per block: 256 columns
constexpr int ROWS = 16;    // rows a thread walks

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <typename T>
__global__ void __launch_bounds__(WARPS * 32) stencil2d_kernel(
    const T* __restrict__ x, const float* __restrict__ coeffs, T* __restrict__ out,
    int H, int W, float bnd) {
  const int lane = threadIdx.x;
  const int col = (blockIdx.x * WARPS + threadIdx.y) * 32 + lane;
  const int r0 = blockIdx.y * ROWS;
  const bool in_col = col < W;
  const float c0 = coeffs[0], c1 = coeffs[1], c2 = coeffs[2], c3 = coeffs[3],
              c4 = coeffs[4];

  // v[k] = x[r0 - 1 + k, col]: the column's rows and one halo row each side.
  // e[k] = the one neighbour outside the warp that lane 0 (left) or lane 31
  // (right) needs, for row r0 + k.
  const int ecol = lane == 0 ? col - 1 : col + 1;
  const bool edge_lane = (lane == 0 || lane == 31) && ecol >= 0 && ecol < W;
  float v[ROWS + 2];
  float e[ROWS];
#pragma unroll
  for (int k = 0; k < ROWS + 2; ++k) {
    const int r = r0 - 1 + k;
    v[k] = (in_col && r >= 0 && r < H) ? to_f(x[(size_t)r * W + col]) : bnd;
  }
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const int r = r0 + k;
    e[k] = (edge_lane && r < H) ? to_f(x[(size_t)r * W + ecol]) : bnd;
  }

#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const int r = r0 + k;
    const float cur = v[k + 1];
    float left = __shfl_up_sync(0xffffffffu, cur, 1);
    float right = __shfl_down_sync(0xffffffffu, cur, 1);
    if (lane == 0) left = e[k];                  // bnd at column 0
    if (lane == 31 || col + 1 >= W) right = lane == 31 ? e[k] : bnd;
    float acc = __fmul_rn(c0, cur);
    acc = __fadd_rn(acc, __fmul_rn(c1, v[k]));
    acc = __fadd_rn(acc, __fmul_rn(c2, v[k + 2]));
    acc = __fadd_rn(acc, __fmul_rn(c3, left));
    acc = __fadd_rn(acc, __fmul_rn(c4, right));
    if (in_col && r < H) store(&out[(size_t)r * W + col], acc);
  }
}

template <typename T>
int launch(const void* x, const void* coeffs, void* out, int H, int W, float bnd,
           cudaStream_t stream) {
  dim3 block(32, WARPS);
  dim3 grid((W + 32 * WARPS - 1) / (32 * WARPS), (H + ROWS - 1) / ROWS);
  stencil2d_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(coeffs), static_cast<T*>(out),
      H, W, bnd);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: (H, W) contiguous, dtype 0 = float32, 1 = bfloat16; coeffs: 5
// float32 on the device.  Returns 0 or the cudaError_t of the launch.
extern "C" int stencil2d_fwd(const void* x, const void* coeffs, void* out, int H,
                             int W, float boundary, int dtype, void* stream) {
  if (H < 1 || W < 1 || (H + ROWS - 1) / ROWS > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, coeffs, out, H, W, boundary, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, coeffs, out, H, W, boundary, s);
  return (int)cudaErrorInvalidValue;
}
