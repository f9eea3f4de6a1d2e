"""Operand-forwarding matmul: the CUDA kernel ``csrc/matmul_fwd.cu`` and
its plain version :func:`~repro_torch.kernels.matmul_fwd.ref.matmul_ref`.

Counterpart of ``repro.kernels.matmul_fwd.kernel.matmul_fwd_pallas``.  The
wrapper applies the reference's block contract: each block is first cut to
``min(block, dim)`` and must then divide its dimension, else ``ValueError``
with the reference's message.  The CUDA kernel picks its own tiles inside
that contract (see the note at the top of the source): bf16 on the tensor
cores, f32 on the CUDA cores with no TF32.  A and B must share one dtype on
the card; the plain version also takes mixed dtypes (a deliberate
difference from the reference, whose body casts both to f32).

:func:`matmul_fwd_cuda` launches the kernel on CUDA tensors (counted in
``matmul_fwd_cuda.launches``) or raises; CPU tensors take the plain version.
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
from repro_torch.kernels.matmul_fwd.ref import matmul_ref

__all__ = ["matmul_fwd_cuda", "matmul_ref"]


def matmul_fwd_cuda(a: torch.Tensor, b: torch.Tensor, *, block_m: int = 256,
                    block_n: int = 256, block_k: int = 256) -> torch.Tensor:
    """C = A @ B.  A: (M, K), B: (K, N), one dtype (f32 or bf16) on the
    card.  Returns (M, N) in a.dtype, summed in f32.  CPU tensors take the
    plain version."""
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"inner dims mismatch: {k} vs {k2}")
    # The reference's block contract: each block, cut to min(block, dim),
    # divides its dim.
    block_m, block_n, block_k = min(block_m, m), min(block_n, n), min(block_k, k)
    if m % block_m or n % block_n or k % block_k:
        raise ValueError(
            f"shape ({m},{k})x({k},{n}) not divisible by blocks "
            f"({block_m},{block_n},{block_k})")
    if a.device.type == "cpu":
        return matmul_ref(a, b)
    check_kernel_tensors("matmul_fwd_cuda", a=a, b=b)
    if a.dtype not in DTYPE_CODE or b.dtype != a.dtype:
        raise ValueError(f"matmul_fwd_cuda: a {a.dtype} and b {b.dtype} must be one "
                         "dtype, float32 or bfloat16 (the plain version takes mixed "
                         "dtypes)")
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    fn = load_library("matmul_fwd").matmul_fwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
             DTYPE_CODE[a.dtype], launch_stream(a.device))
    if err:
        raise RuntimeError(f"matmul_fwd launch failed: cudaError {err}")
    matmul_fwd_cuda.launches += 1
    return out


matmul_fwd_cuda.launches = 0
