"""Token shift (causal depthwise conv): the CUDA kernel
``csrc/token_shift.cu`` and its plain version
:func:`~repro_torch.kernels.token_shift.ref.token_shift_ref`.

Counterpart of ``repro.kernels.token_shift.kernel.token_shift_pallas``.
The Pallas kernel walks the sequence in chunks and carries the last
``taps - 1`` rows of each chunk in a VMEM token buffer; on the card that
carry is only a halo: each thread reads its 16-byte slot of its own rows
and of the ``taps - 1`` rows above them, all at once, so no block waits on
another (the source's note says how many rows a thread takes, and how a D
that is not a multiple of the slot is read).  Unlike the Pallas wrapper
(chunk = min(256, T) must divide T) the kernel takes any T >= 1: the
stateful calls of the model pass T = taps - 1 + window.

:func:`token_shift_cuda` launches the kernel on CUDA tensors (counted in
``token_shift_cuda.launches``) or raises; CPU tensors take the plain
version.  :func:`token_shift_bwd_cuda` is the backward (``token_shift_bwd``
in the same source, no Pallas counterpart): dx by the taps run
anti-causally, dw by per-block f32 partials summed in block order.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.common import (
    DTYPE_CODE,
    check_kernel_tensors,
    launch_stream,
    load_library,
)
from repro_torch.kernels.token_shift.ref import token_shift_bwd_ref, token_shift_ref

__all__ = ["MAX_TAPS", "BWD_TILE", "token_shift_cuda", "token_shift_ref",
           "token_shift_bwd_cuda", "token_shift_bwd_ref"]

#: Largest tap count the kernel takes (the reference's token-buffer budget).
MAX_TAPS = 8
#: Rows of one block of the backward (one dw partial; the source's BWD_TILE).
BWD_TILE = 128


def _check(name, x, w):
    b, t, d = x.shape
    taps = w.shape[0]
    if x.dtype not in DTYPE_CODE or w.dtype != x.dtype:
        raise ValueError(f"{name}: x {x.dtype} and w {w.dtype} must be one "
                         "of float32, bfloat16")
    if w.shape != (taps, d) or not 2 <= taps <= MAX_TAPS:
        raise ValueError(f"{name}: w shape {tuple(w.shape)} must be "
                         f"(taps, {d}) with 2 <= taps <= {MAX_TAPS}")


def token_shift_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """out[b, t, d] = sum_k w[k, d] x[b, t-k, d].  x: (B, T, D) f32 or bf16;
    w: (taps, D) of x's dtype, 2 <= taps <= 8.  Returns (B, T, D) in
    x.dtype, summed in f32.  CPU tensors take the plain version."""
    if x.device.type == "cpu":
        return token_shift_ref(x, w)
    b, t, d = x.shape
    taps = w.shape[0]
    check_kernel_tensors("token_shift_cuda", x=x, w=w)
    _check("token_shift_cuda", x, w)
    out = torch.empty_like(x)
    fn = load_library("token_shift").token_shift_fwd
    err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), b, t, d, taps,
             DTYPE_CODE[x.dtype], launch_stream(x.device))
    if err:
        raise RuntimeError(f"token_shift_fwd launch failed: cudaError {err}")
    token_shift_cuda.launches += 1
    return out


token_shift_cuda.launches = 0


def token_shift_bwd_cuda(x: torch.Tensor, w: torch.Tensor, dout: torch.Tensor):
    """The backward of :func:`token_shift_cuda`: x, dout (B, T, D) and w
    (taps, D) of one dtype.  Returns (dx in x.dtype, dw in w.dtype), summed
    in f32; two kernels (dx with per-block dw partials, then their sum in
    block order), one launch counted in ``token_shift_bwd_cuda.launches``.
    CPU tensors take the plain version."""
    if x.device.type == "cpu":
        return token_shift_bwd_ref(x, w, dout)
    check_kernel_tensors("token_shift_bwd_cuda", x=x, w=w, dout=dout)
    _check("token_shift_bwd_cuda", x, w)
    if dout.shape != x.shape or dout.dtype != x.dtype:
        raise ValueError(f"token_shift_bwd_cuda: dout {dout.dtype} {tuple(dout.shape)} must "
                         f"match x {x.dtype} {tuple(x.shape)}")
    b, t, d = x.shape
    taps = w.shape[0]
    dx, dw = torch.empty_like(x), torch.empty_like(w)
    part = torch.empty((b * -(-t // BWD_TILE), taps, d), dtype=torch.float32, device=x.device)
    err = load_library("token_shift").token_shift_bwd(
        x.data_ptr(), w.data_ptr(), dout.data_ptr(), dx.data_ptr(), part.data_ptr(),
        dw.data_ptr(), b, t, d, taps, DTYPE_CODE[x.dtype], launch_stream(x.device))
    if err:
        raise RuntimeError(f"token_shift_bwd launch failed: cudaError {err}")
    token_shift_bwd_cuda.launches += 1
    return dx, dw


token_shift_bwd_cuda.launches = 0
