"""WKV decode kernels: the single step and the K-token window, both on the
CUDA kernel ``csrc/wkv_decode.cu``, and their plain PyTorch versions.

Counterparts of ``repro.kernels.wkv.decode.wkv_decode_pallas`` and
``wkv_decode_window_pallas``.  One token: ``o = r @ S + (r·u·k) v``,
``S' = diag(w) S + kᵀv``, f32 accumulation.  The window runs K such steps in
one launch with S held in registers, so S crosses device memory once per
window.  The single step is the window kernel at K = 1, which keeps a
window bit-identical to K chained single steps; each entry point keeps its
own wrapper and launch count (``wkv_decode_cuda.launches``,
``wkv_decode_window_cuda.launches``).  CPU tensors take the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.common import launch_stream, load_library
from repro_torch.kernels.wkv.kernel import DTYPE_CODE, check_wkv_args
from repro_torch.kernels.wkv.ref import wkv_sequential_ref

# Stateful (decode) dispatches at or below this many tokens take the window
# kernel; longer ones take the chunked kernel.
DECODE_WINDOW_MAX = 64

__all__ = [
    "DECODE_WINDOW_MAX",
    "wkv_decode_cuda",
    "wkv_decode_window_cuda",
    "wkv_decode_plain",
]


def wkv_decode_plain(r, k, v, w, u, h0):
    """Plain version of both decode kernels: the sequential loop, ``out``
    in r.dtype."""
    out, s = wkv_sequential_ref(r, k, v, w, u, h0)
    return out.to(r.dtype), s


def _launch(name, r, k, v, w, u, h0):
    b, h, t, dh = r.shape
    if not 1 <= t <= DECODE_WINDOW_MAX:
        raise ValueError(f"{name}: window of {t} tokens outside 1..{DECODE_WINDOW_MAX}")
    check_wkv_args(name, r, k, v, w, u, h0)
    out = torch.empty_like(r)
    s_out = torch.empty((b, h, dh, dh), dtype=torch.float32, device=r.device)
    fn = load_library("wkv_decode").wkv_decode_window_fwd
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
             u.data_ptr(), h0.data_ptr(), out.data_ptr(), s_out.data_ptr(),
             b, h, t, dh, DTYPE_CODE[r.dtype], launch_stream(r.device))
    if err:
        raise RuntimeError(f"wkv_decode_window_fwd launch failed: cudaError {err}")
    return out, s_out


def wkv_decode_cuda(r, k, v, w, u, h0):
    """Single decode step.  r/k/v/w: (B, H, 1, 64); u: (H, 64);
    h0: (B, H, 64, 64) f32.  Returns (out (B,H,1,64) r.dtype, S f32)."""
    if r.shape[2] != 1:
        raise ValueError(f"wkv_decode_cuda is single-step; got T={r.shape[2]}")
    if r.device.type == "cpu":
        return wkv_decode_plain(r, k, v, w, u, h0)
    res = _launch("wkv_decode_cuda", r, k, v, w, u, h0)
    wkv_decode_cuda.launches += 1
    return res


def wkv_decode_window_cuda(r, k, v, w, u, h0):
    """K-token decode window, 1 <= K <= 64.  r/k/v/w: (B, H, K, 64);
    u: (H, 64); h0: (B, H, 64, 64) f32.  Returns (out (B,H,K,64) r.dtype,
    S f32), bit-identical to K chained :func:`wkv_decode_cuda` steps."""
    if r.device.type == "cpu":
        return wkv_decode_plain(r, k, v, w, u, h0)
    res = _launch("wkv_decode_window_cuda", r, k, v, w, u, h0)
    wkv_decode_window_cuda.launches += 1
    return res


wkv_decode_cuda.launches = 0
wkv_decode_window_cuda.launches = 0
