"""5-point stencil: the CUDA kernel ``csrc/stencil2d.cu`` and its plain
version :func:`~repro_torch.kernels.stencil2d.ref.stencil2d_ref`.

Counterpart of ``repro.kernels.stencil2d.kernel.stencil2d_pallas``.  The
Pallas kernel walks blocks of ``block_h`` rows with the neighbouring
blocks' halo rows in VMEM; the CUDA kernel gives each warp a 32-column
strip, takes column neighbours by warp shuffles and walks rows in
registers, with its own row tile (see the note at the top of the source).
It takes any H and W and needs no ``block_h``; a ``block_h`` that is given
is checked as the reference checks it (``H % block_h == 0``), so a call
that the reference refuses is refused here too.

:func:`stencil2d_cuda` launches the kernel on CUDA tensors (counted in
``stencil2d_cuda.launches``) or raises; CPU tensors take the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.common import (
    DTYPE_CODE,
    check_kernel_tensors,
    launch_stream,
    load_library,
)
from repro_torch.kernels.stencil2d.ref import stencil2d_ref

__all__ = ["stencil2d_cuda", "stencil2d_ref"]


def stencil2d_cuda(x: torch.Tensor, coeffs: torch.Tensor, *, block_h: int | None = None,
                   boundary: float = 0.0) -> torch.Tensor:
    """x: (H, W) f32 or bf16 (H % block_h == 0 where ``block_h`` is
    given); coeffs: (5,) on x's device (cast to f32, as the reference casts
    them).  Returns (H, W) in x.dtype, computed in f32.  CPU tensors take
    the plain version."""
    h, w = x.shape
    if block_h is not None and (block_h < 1 or h % block_h):
        raise ValueError(f"H={h} not divisible by block_h={block_h}")
    if tuple(coeffs.shape) != (5,):
        raise ValueError(f"stencil2d_cuda: coeffs shape {tuple(coeffs.shape)} must be (5,)")
    if x.device.type == "cpu":
        return stencil2d_ref(x, coeffs, boundary)
    c32 = coeffs.to(torch.float32).contiguous()
    check_kernel_tensors("stencil2d_cuda", x=x, coeffs=c32)
    if x.dtype not in DTYPE_CODE:
        raise ValueError(f"stencil2d_cuda: x {x.dtype} must be one of float32, bfloat16")
    out = torch.empty_like(x)
    fn = load_library("stencil2d").stencil2d_fwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(x.data_ptr(), c32.data_ptr(), out.data_ptr(), h, w, float(boundary),
             DTYPE_CODE[x.dtype], launch_stream(x.device))
    if err:
        raise RuntimeError(f"stencil2d_fwd launch failed: cudaError {err}")
    stencil2d_cuda.launches += 1
    return out


stencil2d_cuda.launches = 0
