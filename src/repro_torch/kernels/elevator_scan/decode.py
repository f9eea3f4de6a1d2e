"""Elevator decode window: the CUDA kernel ``csrc/elevator_scan.cu``
(``elevator_decode_window_fwd``) and its plain version.

Counterpart of
``repro.kernels.elevator_scan.decode.elevator_decode_window_pallas``: the
recurrence over a window of K >= 1 decode tokens with h0 (B, D) read once
and the state carried in a register across the window.  Each step computes
``a * h`` rounded, then ``+ x`` rounded (no fused multiply-add), and the
f32 exit state comes back beside the outputs, so a window equals K chained
single launches bit for bit in f32 and bf16 alike.  One wrapper serves both
uses (the reference has one Pallas entry for them): every generated token
(K = 1) and every admission of at most
:data:`ELEVATOR_DECODE_WINDOW_MAX` tokens, counted in
``elevator_decode_window_cuda.launches``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.common import DTYPE_CODE, launch_stream, load_library
from repro_torch.kernels.elevator_scan.kernel import check_scan_args
from repro_torch.kernels.elevator_scan.ref import elevator_scan_ref_f32

# Stateful (decode) dispatches at or below this many tokens take the window
# kernel; longer ones take the chunked kernel (the reference's threshold).
ELEVATOR_DECODE_WINDOW_MAX = 64

__all__ = ["ELEVATOR_DECODE_WINDOW_MAX", "elevator_decode_window_cuda",
           "elevator_decode_window_plain"]


def elevator_decode_window_plain(a, x, h0):
    """Plain version: (h (B, K, D) in x.dtype, exit state (B, D) f32)."""
    h32 = elevator_scan_ref_f32(a, x, h0)
    return h32.to(x.dtype), h32[:, -1]


def elevator_decode_window_cuda(a: torch.Tensor, x: torch.Tensor,
                                h0: torch.Tensor):
    """K-token window, any K >= 1.  a, x: (B, K, D) f32 or bf16; h0: (B, D)
    f32.  Returns (h (B, K, D) in x.dtype, exit state (B, D) f32).  CPU
    tensors take the plain version."""
    if x.device.type == "cpu":
        return elevator_decode_window_plain(a, x, h0)
    if h0 is None:
        raise ValueError("elevator_decode_window_cuda: h0 is required")
    check_scan_args("elevator_decode_window_cuda", a, x, h0)
    b, k, d = x.shape
    out = torch.empty_like(x)
    h_out = torch.empty_like(h0)
    fn = load_library("elevator_scan").elevator_decode_window_fwd
    err = fn(a.data_ptr(), x.data_ptr(), h0.data_ptr(), out.data_ptr(),
             h_out.data_ptr(), b, k, d, DTYPE_CODE[x.dtype], launch_stream(x.device))
    if err:
        raise RuntimeError(f"elevator_decode_window_fwd launch failed: cudaError {err}")
    elevator_decode_window_cuda.launches += 1
    return out, h_out


elevator_decode_window_cuda.launches = 0
