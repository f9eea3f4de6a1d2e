"""Chunked RWKV6 WKV forward: the CUDA kernel ``csrc/wkv_chunked.cu`` and
its plain PyTorch version, for inference and for training.

Counterparts of ``repro.kernels.wkv.kernel.wkv_pallas`` and
``wkv_pallas_train``.  The Pallas kernel
walks a ``(batch, head, chunk)`` grid in order and carries the (Dh × Dh)
state S in a VMEM scratch; the CUDA kernel loops over the chunks inside one
block per (batch·head, value-column tile) and keeps its S tile in shared
memory for the whole sweep (see the note at the top of the source).

:func:`wkv_cuda` is the wrapper: on CUDA tensors it launches the kernel
(counting the launch in ``wkv_cuda.launches``) or raises; on CPU tensors it
runs :func:`wkv_plain`.  :func:`wkv_train_cuda` is the training forward:
the same kernel with its ``s_hist`` output on (the state entering each
chunk, the one residual the backward keeps), counted in
``wkv_train_cuda.launches``; its plain version is :func:`wkv_train_plain`.
Neither wrapper takes tensors that require grad: gradients go through
:class:`repro_torch.kernels.wkv.vjp.WKVFunction`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.common import launch_stream, load_library, validate_divisible
from repro_torch.kernels.wkv.ref import wkv_chunked_hist_ref, wkv_chunked_ref

__all__ = ["WKV_DH", "MAX_CHUNK", "wkv_cuda", "wkv_plain", "wkv_train_cuda",
           "wkv_train_plain", "check_wkv_args"]

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
                f"{name}: {key} requires grad; the raw kernel wrappers take "
                "no autograd (gradients go through wkv.vjp.WKVFunction)")
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


def _launch_chunked(name, r, k, v, w, u, h0, chunk, with_hist):
    """Check the inputs, allocate the outputs and launch the chunked kernel
    (its ``s_hist`` output on or off).  Returns (out, S[, s_hist])."""
    b, h, t, dh = r.shape
    if chunk > MAX_CHUNK:
        raise ValueError(f"{name}: chunk={chunk} > {MAX_CHUNK}")
    check_wkv_args(name, r, k, v, w, u, h0)
    outs = [torch.empty_like(r),
            torch.empty((b, h, dh, dh), dtype=torch.float32, device=r.device)]
    if with_hist:
        outs.append(torch.empty((b, h, t // chunk, dh, dh), dtype=torch.float32,
                                device=r.device))
    entry = "wkv_chunked_train_fwd" if with_hist else "wkv_chunked_fwd"
    fn = getattr(load_library("wkv_chunked"), entry)
    fn.argtypes = ([ctypes.c_void_p] * (6 + len(outs)) + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    err = fn(*(x.data_ptr() for x in (r, k, v, w, u, h0, *outs)),
             b, h, t, dh, chunk, DTYPE_CODE[r.dtype], launch_stream(r.device))
    if err:
        raise RuntimeError(f"{entry} launch failed: cudaError {err}")
    return tuple(outs)


def wkv_cuda(r, k, v, w, u, h0, *, chunk: int):
    """Fused chunked WKV sweep.  r/k/v/w: (B, H, T, 64); u: (H, 64);
    h0: (B, H, 64, 64) f32; ``chunk`` divides T, 1..64.  Returns
    (out (B,H,T,64) r.dtype, S (B,H,64,64) f32).  CPU tensors take the
    plain version."""
    validate_divisible("T", r.shape[2], chunk)
    if r.device.type == "cpu":
        return wkv_plain(r, k, v, w, u, h0, chunk=chunk)
    outs = _launch_chunked("wkv_cuda", r, k, v, w, u, h0, chunk, with_hist=False)
    wkv_cuda.launches += 1
    return outs


wkv_cuda.launches = 0


def wkv_train_plain(r, k, v, w, u, h0, *, chunk: int):
    """Plain version of the training forward: (out in r.dtype, S f32,
    s_hist (B, H, T/chunk, Dh, Dh) f32)."""
    out, s, hist = wkv_chunked_hist_ref(r, k, v, w, u, h0, chunk)
    return out.to(r.dtype), s, hist


def wkv_train_cuda(r, k, v, w, u, h0, *, chunk: int):
    """The training forward sweep: :func:`wkv_cuda` that also returns
    ``s_hist`` (B, H, T/chunk, 64, 64) f32, the state entering each chunk.
    CPU tensors take the plain version."""
    validate_divisible("T", r.shape[2], chunk)
    if r.device.type == "cpu":
        return wkv_train_plain(r, k, v, w, u, h0, chunk=chunk)
    outs = _launch_chunked("wkv_train_cuda", r, k, v, w, u, h0, chunk, with_hist=True)
    wkv_train_cuda.launches += 1
    return outs


wkv_train_cuda.launches = 0
