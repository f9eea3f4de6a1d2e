"""Chunked elevator scan: the CUDA kernel ``csrc/elevator_scan.cu``
(``elevator_scan_fwd``) and its plain version
:func:`~repro_torch.kernels.elevator_scan.ref.elevator_scan_ref`.

Counterpart of ``repro.kernels.elevator_scan.kernel.elevator_scan_pallas``:
``h[t] = a[t] h[t-1] + x[t]`` over (B, T, D) with an f32 carry seeded by
an optional h0 (B, D).  The Pallas kernel carries h across a sequential
grid axis of chunks in VMEM and solves each chunk by Hillis-Steele
doubling.  The CUDA kernel keeps the carry inside one block per (batch,
32 channels): the block's warps scan consecutive segments of a chunk at
once, compose the segments' (prod a, h) summaries in shared memory and fix
their rows up, and the chunk's exit state seeds the next chunk (see the
note at the top of the source).  It sums in another order than the
sequential plain version, so the two agree to a stated tolerance, not bit
for bit.

:func:`elevator_scan_cuda` launches on CUDA tensors (counted in
``elevator_scan_cuda.launches``) or raises; CPU tensors take the plain
version.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.common import (
    DTYPE_CODE,
    check_kernel_tensors,
    launch_stream,
    load_library,
)
from repro_torch.kernels.elevator_scan.ref import elevator_scan_ref

__all__ = ["elevator_scan_cuda", "elevator_scan_ref", "check_scan_args"]


def check_scan_args(name, a, x, h0):
    """a and x: (B, T, D) of one dtype (f32 or bf16); h0: None or (B, D)
    f32; all on one CUDA device, contiguous, without autograd."""
    check_kernel_tensors(name, a=a, x=x, h0=h0)
    if x.dtype not in DTYPE_CODE or a.dtype != x.dtype:
        raise ValueError(f"{name}: a {a.dtype} and x {x.dtype} must be one of "
                         "float32, bfloat16")
    if a.shape != x.shape or x.ndim != 3:
        raise ValueError(f"{name}: a {tuple(a.shape)} and x {tuple(x.shape)} "
                         "must be one (B, T, D) shape")
    b, _, d = x.shape
    if h0 is not None and (h0.dtype != torch.float32 or h0.shape != (b, d)):
        raise ValueError(f"{name}: h0 must be float32 of shape {(b, d)}, got "
                         f"{h0.dtype} {tuple(h0.shape)}")


def elevator_scan_cuda(a: torch.Tensor, x: torch.Tensor,
                       h0: torch.Tensor | None = None) -> torch.Tensor:
    """The chunked scan, any T >= 1.  a, x: (B, T, D) f32 or bf16; h0:
    (B, D) f32 or None (zeros).  Returns h (B, T, D) in x.dtype.  CPU
    tensors take the plain version."""
    if x.device.type == "cpu":
        return elevator_scan_ref(a, x, h0)
    check_scan_args("elevator_scan_cuda", a, x, h0)
    b, t, d = x.shape
    out = torch.empty_like(x)
    fn = load_library("elevator_scan").elevator_scan_fwd
    err = fn(a.data_ptr(), x.data_ptr(), None if h0 is None else h0.data_ptr(),
             out.data_ptr(), b, t, d, DTYPE_CODE[x.dtype], launch_stream(x.device))
    if err:
        raise RuntimeError(f"elevator_scan_fwd launch failed: cudaError {err}")
    elevator_scan_cuda.launches += 1
    return out


elevator_scan_cuda.launches = 0
