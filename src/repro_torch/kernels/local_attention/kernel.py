"""Flash attention: the CUDA kernel ``csrc/flash_attention.cu`` and its
plain version :func:`~repro_torch.kernels.local_attention.ref.attention_ref`.

Counterpart of ``repro.kernels.local_attention.kernel.flash_attention_pallas``,
in every variant it has: causal, full, causal sliding-window, non-causal
window, GQA (kv head = q head // group), the decode offset S - T, T and S of
any length, and 0 for a query that sees no key.  bf16 inputs run on the
tensor cores; f32 inputs on a CUDA-core path with f32 products (see the
note at the top of the source).  With ``lse=True`` (training) the forward
also returns each row's log-sum-exp, which
:func:`flash_attention_bwd_cuda` (``csrc/flash_attention_bwd.cu``, a
backward with no Pallas counterpart) reads to recompute the softmax.

:func:`flash_attention_cuda` and :func:`flash_attention_bwd_cuda` launch on
CUDA tensors (counted in their ``launches``) or raise; CPU tensors take the
plain versions (:func:`attention_ref`, :func:`attention_ref_lse`,
:func:`attention_bwd_ref`).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.common import (
    DTYPE_CODE,
    check_kernel_tensors,
    launch_stream,
    load_library,
)
from repro_torch.kernels.local_attention.ref import (
    attention_bwd_ref,
    attention_ref,
    attention_ref_lse,
)

__all__ = ["HEAD_DIMS", "F32_HEAD_DIMS", "flash_attention_cuda", "flash_attention_bwd_cuda",
           "attention_ref", "attention_ref_lse", "attention_bwd_ref"]

#: Head widths the kernels are compiled for, in bf16 and in f32 (96: the
#: qwen2-100m training example's width).
HEAD_DIMS = (32, 64, 128, 256)
F32_HEAD_DIMS = HEAD_DIMS + (96,)


def _check_qkv(name, q, k, v, window):
    """One dtype (f32 or bf16), (B,Hq,T,D) and (B,Hkv,S,D) with Hkv | Hq,
    a compiled head width, a window None or >= 1, 16-byte aligned."""
    b, hq, t, d = q.shape
    _, hkv, s, _ = k.shape
    if q.dtype not in DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: q/k/v dtypes {q.dtype}/{k.dtype}/"
                         f"{v.dtype} must be one of float32, bfloat16")
    if k.shape != v.shape or k.shape != (b, hkv, s, d) or hq % hkv:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}: need (B,Hq,T,D) and "
                         "(B,Hkv,S,D) with Hkv | Hq")
    dims = F32_HEAD_DIMS if q.dtype == torch.float32 else HEAD_DIMS
    if d not in dims:
        raise ValueError(f"{name}: head dim {d} not in {dims} for {q.dtype}")
    if window is not None and window < 1:
        raise ValueError(f"{name}: window must be >= 1, got {window}")
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError(f"{name}: q/k/v must be 16-byte aligned")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: int | None = None,
                         scale: float | None = None, lse: bool = False):
    """q: (B, Hq, T, D); k, v: (B, Hkv, S, D), Hkv | Hq, one dtype (f32 or
    bf16), D in :data:`HEAD_DIMS` (:data:`F32_HEAD_DIMS` in f32).  ``window``
    None or >= 1; ``scale`` defaults to D ** -0.5.  Returns (B, Hq, T, D) in
    q.dtype, and with ``lse`` also each row's log-sum-exp (B, Hq, T) f32.
    CPU tensors take the plain version."""
    if q.device.type == "cpu":
        if lse:
            return attention_ref_lse(q, k, v, causal=causal, window=window, scale=scale)
        return attention_ref(q, k, v, causal=causal, window=window, scale=scale)
    check_kernel_tensors("flash_attention_cuda", q=q, k=k, v=v)
    _check_qkv("flash_attention_cuda", q, k, v, window)
    b, hq, t, d = q.shape
    _, hkv, s, _ = k.shape
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty_like(q)
    rows = torch.empty((b, hq, t), dtype=torch.float32, device=q.device) if lse else None
    fn = load_library("flash_attention").flash_attention_fwd
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             None if rows is None else rows.data_ptr(),
             b, hq, hkv, t, s, d, int(causal), 0 if window is None else int(window),
             float(scale), DTYPE_CODE[q.dtype], launch_stream(q.device))
    if err:
        raise RuntimeError(f"flash_attention_fwd launch failed: cudaError {err}")
    flash_attention_cuda.launches += 1
    return (out, rows) if lse else out


flash_attention_cuda.launches = 0


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                             causal: bool = True, window: int | None = None,
                             scale: float | None = None):
    """The backward of :func:`flash_attention_cuda` from its output ``o``,
    its ``lse`` and the output cotangent ``do`` (both (B, Hq, T, D) in
    q.dtype): returns (dq, dk, dv) in q.dtype, dk and dv per KV head.  Three
    kernels on the current stream (delta, dK/dV, dQ), one launch counted in
    ``flash_attention_bwd_cuda.launches``.  CPU tensors take
    :func:`attention_bwd_ref`."""
    if q.device.type == "cpu":
        return attention_bwd_ref(q, k, v, o, lse, do, causal=causal, window=window,
                                 scale=scale)
    check_kernel_tensors("flash_attention_bwd_cuda", q=q, k=k, v=v, o=o, lse=lse, do=do)
    _check_qkv("flash_attention_bwd_cuda", q, k, v, window)
    b, hq, t, d = q.shape
    _, hkv, s, _ = k.shape
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype or do.dtype != q.dtype:
        raise ValueError(f"flash_attention_bwd_cuda: o {tuple(o.shape)} {o.dtype} and do "
                         f"{tuple(do.shape)} {do.dtype} must match q {tuple(q.shape)} {q.dtype}")
    if lse.shape != (b, hq, t) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd_cuda: lse must be float32 {(b, hq, t)}, got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    if any(x.data_ptr() % 16 for x in (o, do)):
        raise ValueError("flash_attention_bwd_cuda: o/do must be 16-byte aligned")
    scale = scale if scale is not None else d ** -0.5
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((b, hq, t), dtype=torch.float32, device=q.device)
    err = load_library("flash_attention_bwd").flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, hq, hkv, t, s, d,
        int(causal), 0 if window is None else int(window), float(scale), DTYPE_CODE[q.dtype],
        launch_stream(q.device))
    if err:
        raise RuntimeError(f"flash_attention_bwd launch failed: cudaError {err}")
    flash_attention_bwd_cuda.launches += 1
    return dq, dk, dv


flash_attention_bwd_cuda.launches = 0
