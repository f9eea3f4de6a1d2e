"""Chunked RWKV6 WKV forward: the CUDA kernel ``csrc/wkv_chunked.cu`` and
its plain PyTorch version, for inference and for training, with and
without the segment summary.

Counterparts of ``repro.kernels.wkv.kernel.wkv_pallas``,
``wkv_pallas_train``, ``wkv_pallas_summary`` and
``wkv_pallas_train_summary``.  The Pallas kernel
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
:func:`wkv_summary_cuda` and :func:`wkv_train_summary_cuda` are the same
two sweeps that also return ``a_seg`` (B, H, 64) f32, the product of the
segment's decays: the decay half of the (A, S) segment summary the
sequence-parallel path (:mod:`repro_torch.kernels.wkv.seqpar`) composes
across shards.  Their r/k/v/w may be T-windows of longer tensors (views
``x[:, :, s0:s1]`` of contiguous (B, H, T, 64) tensors), which the kernel
reads in place; their plain versions are :func:`wkv_summary_plain` and
:func:`wkv_train_summary_plain`.
No wrapper takes tensors that require grad: gradients go through
:class:`repro_torch.kernels.wkv.vjp.WKVFunction` and
:class:`~repro_torch.kernels.wkv.vjp.WKVSummaryFunction`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.common import (
    DTYPE_CODE,
    check_kernel_tensors,
    launch_stream,
    load_library,
    validate_divisible,
)
from repro_torch.kernels.wkv.ref import (
    wkv_chunked_hist_ref,
    wkv_chunked_ref,
    wkv_segment_decay,
)

__all__ = ["WKV_DH", "MAX_CHUNK", "wkv_cuda", "wkv_plain", "wkv_train_cuda",
           "wkv_train_plain", "wkv_summary_cuda", "wkv_summary_plain",
           "wkv_train_summary_cuda", "wkv_train_summary_plain", "check_wkv_args",
           "row_stride"]

#: Head width the CUDA kernels are written for (the model's RWKV head dim).
WKV_DH = 64
#: Largest chunk the chunked kernel takes (its shared-memory tiles).
MAX_CHUNK = 64


def check_wkv_args(name, r, k, v, w, u, h0, *, t_window=False):
    """Validate kernel inputs: one CUDA device, f32/bf16 r/k/v/w/u of one
    dtype, f32 h0, the (B,H,T,64) layout, contiguity, and no autograd.
    With ``t_window`` r/k/v/w may instead be T-windows of longer
    contiguous tensors, all four alike.  Returns the token count between
    consecutive (b, h) rows of r/k/v/w (T when they are contiguous)."""
    b, h, t, dh = r.shape
    tensors = {"r": r, "k": k, "v": v, "w": w, "u": u, "h0": h0}
    check_kernel_tensors(name, strided=("r", "k", "v", "w") if t_window else (),
                         **tensors)
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
    return row_stride(name, r, k, v, w)


def row_stride(name, r, k, v, w):
    """Tokens between consecutive (b, h) rows of r/k/v/w, which are
    contiguous or T-windows ``x[:, :, s0:s1]`` of contiguous tensors with
    one layout."""
    b, h, t, dh = r.shape
    if all(x.is_contiguous() for x in (r, k, v, w)):
        return t
    strides = {x.stride() for x in (r, k, v, w)}
    row = r.stride(1) if h > 1 else (r.stride(0) if b > 1 else t * dh)
    if (len(strides) > 1 or r.stride(3) != 1 or r.stride(2) != dh or row % dh
            or row < t * dh or (b > 1 and h > 1 and r.stride(0) != h * row)):
        raise ValueError(
            f"{name}: r/k/v/w must be contiguous or T-windows of contiguous "
            f"(B, H, T, {dh}) tensors with one layout, got strides {sorted(strides)}")
    return row // dh


def wkv_plain(r, k, v, w, u, h0, *, chunk: int):
    """Plain version: :func:`wkv_chunked_ref` with ``out`` in r.dtype."""
    out, s = wkv_chunked_ref(r, k, v, w, u, h0, chunk)
    return out.to(r.dtype), s


#: (s_hist, a_seg) outputs on -> the C entry point of wkv_chunked.cu.
_ENTRIES = {
    (False, False): "wkv_chunked_fwd",
    (True, False): "wkv_chunked_train_fwd",
    (False, True): "wkv_chunked_summary_fwd",
    (True, True): "wkv_chunked_train_summary_fwd",
}


def _launch_chunked(name, r, k, v, w, u, h0, chunk, with_hist, with_summary=False):
    """Check the inputs, allocate the outputs and launch the chunked kernel
    (its ``s_hist`` and ``a_seg`` outputs on or off; the summary entries
    read T-windows in place).  Returns (out, S[, s_hist][, a_seg])."""
    b, h, t, dh = r.shape
    if chunk > MAX_CHUNK:
        raise ValueError(f"{name}: chunk={chunk} > {MAX_CHUNK}")
    t_stride = check_wkv_args(name, r, k, v, w, u, h0, t_window=with_summary)
    dev, f32 = r.device, torch.float32
    outs = [torch.empty(r.shape, dtype=r.dtype, device=dev),
            torch.empty((b, h, dh, dh), dtype=f32, device=dev)]
    if with_hist:
        outs.append(torch.empty((b, h, t // chunk, dh, dh), dtype=f32, device=dev))
    ints = [b, h, t, dh, chunk, DTYPE_CODE[r.dtype]]
    if with_summary:
        outs.append(torch.empty((b, h, dh), dtype=f32, device=dev))
        ints.insert(3, t_stride)
    entry = _ENTRIES[(with_hist, with_summary)]
    fn = getattr(load_library("wkv_chunked"), entry)
    fn.argtypes = ([ctypes.c_void_p] * (6 + len(outs)) + [ctypes.c_int] * len(ints)
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    err = fn(*(x.data_ptr() for x in (r, k, v, w, u, h0, *outs)),
             *ints, launch_stream(dev))
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


def wkv_summary_plain(r, k, v, w, u, h0, *, chunk: int):
    """Plain version of the summary forward: (out in r.dtype, S f32,
    a_seg (B, H, Dh) f32)."""
    out, s = wkv_plain(r, k, v, w, u, h0, chunk=chunk)
    return out, s, wkv_segment_decay(w)


def wkv_summary_cuda(r, k, v, w, u, h0, *, chunk: int):
    """:func:`wkv_cuda` that also returns ``a_seg`` (B, H, 64) f32, the
    product of the segment's clipped decays.  r/k/v/w may be T-windows of
    longer contiguous tensors.  CPU tensors take the plain version."""
    validate_divisible("T", r.shape[2], chunk)
    if r.device.type == "cpu":
        return wkv_summary_plain(r, k, v, w, u, h0, chunk=chunk)
    outs = _launch_chunked("wkv_summary_cuda", r, k, v, w, u, h0, chunk,
                           with_hist=False, with_summary=True)
    wkv_summary_cuda.launches += 1
    return outs


wkv_summary_cuda.launches = 0


def wkv_train_summary_plain(r, k, v, w, u, h0, *, chunk: int):
    """Plain version of the training summary forward: (out in r.dtype,
    S f32, s_hist f32, a_seg f32)."""
    return (*wkv_train_plain(r, k, v, w, u, h0, chunk=chunk), wkv_segment_decay(w))


def wkv_train_summary_cuda(r, k, v, w, u, h0, *, chunk: int):
    """The training forward with the segment summary: (out, S, s_hist,
    a_seg) from one sweep.  r/k/v/w may be T-windows of longer contiguous
    tensors.  CPU tensors take the plain version."""
    validate_divisible("T", r.shape[2], chunk)
    if r.device.type == "cpu":
        return wkv_train_summary_plain(r, k, v, w, u, h0, chunk=chunk)
    outs = _launch_chunked("wkv_train_summary_cuda", r, k, v, w, u, h0, chunk,
                           with_hist=True, with_summary=True)
    wkv_train_summary_cuda.launches += 1
    return outs


wkv_train_summary_cuda.launches = 0
