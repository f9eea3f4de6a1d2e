"""Flash attention: the CUDA kernel ``csrc/flash_attention.cu`` and its
plain version :func:`~repro_torch.kernels.local_attention.ref.attention_ref`.

Counterpart of ``repro.kernels.local_attention.kernel.flash_attention_pallas``,
in every variant it has: causal, full, causal sliding-window, non-causal
window, GQA (kv head = q head // group), the decode offset S - T, T and S of
any length, and 0 for a query that sees no key.  bf16 inputs run on the
tensor cores; f32 inputs on a CUDA-core path with f32 products (see the
note at the top of the source).

:func:`flash_attention_cuda` launches on CUDA tensors (counted in
``flash_attention_cuda.launches``) or raises; CPU tensors take the plain
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
from repro_torch.kernels.local_attention.ref import attention_ref

__all__ = ["HEAD_DIMS", "flash_attention_cuda", "attention_ref"]

#: Head widths the kernel is compiled for.
HEAD_DIMS = (32, 64, 128, 256)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: int | None = None,
                         scale: float | None = None) -> torch.Tensor:
    """q: (B, Hq, T, D); k, v: (B, Hkv, S, D), Hkv | Hq, one dtype (f32 or
    bf16), D in :data:`HEAD_DIMS`.  ``window`` None or >= 1; ``scale``
    defaults to D ** -0.5.  Returns (B, Hq, T, D) in q.dtype.  CPU tensors
    take the plain version."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window, scale=scale)
    check_kernel_tensors("flash_attention_cuda", q=q, k=k, v=v)
    b, hq, t, d = q.shape
    _, hkv, s, _ = k.shape
    if q.dtype not in DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention_cuda: q/k/v dtypes {q.dtype}/{k.dtype}/"
                         f"{v.dtype} must be one of float32, bfloat16")
    if k.shape != v.shape or k.shape != (b, hkv, s, d) or hq % hkv:
        raise ValueError(f"flash_attention_cuda: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}: need (B,Hq,T,D) and "
                         "(B,Hkv,S,D) with Hkv | Hq")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention_cuda: head dim {d} not in {HEAD_DIMS}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention_cuda: window must be >= 1, got {window}")
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("flash_attention_cuda: q/k/v must be 16-byte aligned")
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty_like(q)
    fn = load_library("flash_attention").flash_attention_fwd
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             b, hq, hkv, t, s, d, int(causal), 0 if window is None else int(window),
             float(scale), DTYPE_CODE[q.dtype], launch_stream(q.device))
    if err:
        raise RuntimeError(f"flash_attention_fwd launch failed: cudaError {err}")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
