// The visibility mask of flash attention, shared by the forward
// (flash_attention.cu) and the backward (flash_attention_bwd.cu), so both
// take the same variants: causal, causal window, non-causal window, full,
// the decode offset o = S - T, and T != S for cross-attention.
//
// Key j is visible to query i when j < S, i < T and, causal, j <= i + o and
// (window W) j > i + o - W; non-causal with a window, |j - i| < W.
#pragma once

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

  // Queries [lo, hi) that some key of [k0, k1) is visible to (empty if hi
  // <= lo): the backward's dK/dV blocks walk only these.
  __device__ __forceinline__ void query_range(int k0, int k1, int& lo, int& hi) const {
    k1 = min(k1, S);
    lo = 0;
    hi = T;
    if (causal) {
      lo = max(0, k0 - offset);
      if (window >= 1) hi = min(T, k1 - 1 - offset + window);
    } else if (window >= 1) {
      lo = max(0, k0 - window + 1);
      hi = min(T, k1 - 1 + window);
    }
  }

  // Every query of [q0, q1) below T sees every key of [k0, k1): no
  // per-element mask is needed.
  __device__ __forceinline__ bool all_visible(int q0, int q1, int k0, int k1) const {
    q1 = min(q1, T);
    if (k1 > S) return false;
    if (causal)
      return k1 - 1 <= q0 + offset && (window < 1 || k0 > q1 - 1 + offset - window);
    return window < 1 || (k1 - 1 - q0 < window && q1 - 1 - k0 < window);
  }
};
