"""Chunked RWKV6 WKV forward: the CUDA kernel ``csrc/wkv_chunked.cu`` and
its plain PyTorch version.

Counterpart of ``repro.kernels.wkv.kernel.wkv_pallas``.  The Pallas kernel
walks a ``(batch, head, chunk)`` grid in order and carries the (Dh × Dh)
state S in a VMEM scratch; the CUDA kernel loops over the chunks inside one
block per (batch·head, value-column tile) and keeps its S tile in shared
memory for the whole sweep (see the note at the top of the source).

:func:`wkv_cuda` is the wrapper: on CUDA tensors it launches the kernel
(counting the launch in ``wkv_cuda.launches``) or raises; on CPU tensors it
runs :func:`wkv_plain`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.common import launch_stream, load_library, validate_divisible
from repro_torch.kernels.wkv.ref import wkv_chunked_ref

__all__ = ["WKV_DH", "MAX_CHUNK", "wkv_cuda", "wkv_plain", "check_wkv_args"]

#: Head width the CUDA kernels are written for (the model's RWKV head dim).
WKV_DH = 64
#: Largest chunk the chunked kernel takes (its shared-memory tiles).
MAX_CHUNK = 64

#: dtype -> the C interface's dtype code.
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def check_wkv_args(name, r, k, v, w, u, h0):
    """Validate kernel inputs: one CUDA device, f32/bf16 r/k/v/w/u of one
    dtype, f32 h0, the (B,H,T,64) layout, contiguity, and no autograd."""
    b, h, t, dh = r.shape
    tensors = {"r": r, "k": k, "v": v, "w": w, "u": u, "h0": h0}
    for key, x in tensors.items():
        if x.device != r.device or x.device.type != "cuda":
            raise ValueError(f"{name}: {key} must be on r's CUDA device, got {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        if x.requires_grad:
            raise ValueError(
                f"{name}: {key} requires grad; the CUDA kernels are "
                "inference-only (gradients come with the training port)")
    if r.dtype not in DTYPE_CODE:
        raise ValueError(f"{name}: dtype {r.dtype} not supported (float32, bfloat16)")
    for key in ("k", "v", "w", "u"):
        if tensors[key].dtype != r.dtype:
            raise ValueError(f"{name}: {key} dtype {tensors[key].dtype} != r dtype {r.dtype}")
    if h0.dtype != torch.float32:
        raise ValueError(f"{name}: h0 must be float32, got {h0.dtype}")
    for key in ("k", "v", "w"):
        if tensors[key].shape != r.shape:
            raise ValueError(f"{name}: {key} shape {tuple(tensors[key].shape)} != {tuple(r.shape)}")
    if dh != WKV_DH:
        raise ValueError(f"{name}: head dim {dh} != {WKV_DH}")
    if u.shape != (h, dh):
        raise ValueError(f"{name}: u shape {tuple(u.shape)} != {(h, dh)}")
    if h0.shape != (b, h, dh, dh):
        raise ValueError(f"{name}: h0 shape {tuple(h0.shape)} != {(b, h, dh, dh)}")


def wkv_plain(r, k, v, w, u, h0, *, chunk: int):
    """Plain version: :func:`wkv_chunked_ref` with ``out`` in r.dtype."""
    out, s = wkv_chunked_ref(r, k, v, w, u, h0, chunk)
    return out.to(r.dtype), s


def wkv_cuda(r, k, v, w, u, h0, *, chunk: int):
    """Fused chunked WKV sweep.  r/k/v/w: (B, H, T, 64); u: (H, 64);
    h0: (B, H, 64, 64) f32; ``chunk`` divides T, 1..64.  Returns
    (out (B,H,T,64) r.dtype, S (B,H,64,64) f32).  CPU tensors take the
    plain version."""
    b, h, t, dh = r.shape
    validate_divisible("T", t, chunk)
    if r.device.type == "cpu":
        return wkv_plain(r, k, v, w, u, h0, chunk=chunk)
    if chunk > MAX_CHUNK:
        raise ValueError(f"wkv_cuda: chunk={chunk} > {MAX_CHUNK}")
    check_wkv_args("wkv_cuda", r, k, v, w, u, h0)
    out = torch.empty_like(r)
    s_out = torch.empty((b, h, dh, dh), dtype=torch.float32, device=r.device)
    fn = load_library("wkv_chunked").wkv_chunked_fwd
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
             u.data_ptr(), h0.data_ptr(), out.data_ptr(), s_out.data_ptr(),
             b, h, t, dh, chunk, DTYPE_CODE[r.dtype], launch_stream(r.device))
    if err:
        raise RuntimeError(f"wkv_chunked_fwd launch failed: cudaError {err}")
    wkv_cuda.launches += 1
    return out, s_out


wkv_cuda.launches = 0
