"""Chunked RWKV6 WKV backward: the CUDA kernel ``csrc/wkv_bwd.cu`` and its
plain PyTorch version.

Counterpart of ``repro.kernels.wkv.bwd.wkv_pallas_bwd``: the reverse chunk
sweep that carries the (Dh × Dh) adjoint state dS from chunk s+1 to chunk
s, seeded with ``d_s_out`` at the last chunk, and recomputes the decays and
scores of each chunk from the primals and ``s_hist`` (the entering states
the training forward wrote).  The CUDA kernel runs the sweep inside one
block per (batch, head) with dS in shared memory (see the note at the top
of the source).

:func:`wkv_bwd_cuda` is the wrapper: on CUDA tensors it launches the kernel
(counting the launch in ``wkv_bwd_cuda.launches``) or raises; on CPU
tensors it runs :func:`wkv_bwd_plain`.  Both return ``(dr, dk, dv, dw,
du_part, dh0)``: dr/dk/dv/dw in the primal dtype, ``du_part`` (B, H, Dh)
f32 per-batch partials of the u cotangent (the caller sums over batch) and
``dh0`` (B, H, Dh, Dh) f32.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.common import (
    check_kernel_tensors,
    launch_stream,
    load_library,
    validate_divisible,
)
from repro_torch.kernels.wkv.kernel import DTYPE_CODE, WKV_DH, row_stride

__all__ = ["BWD_MAX_CHUNK", "wkv_bwd_cuda", "wkv_bwd_plain"]

#: Largest chunk the backward kernel takes (its shared-memory tiles).
BWD_MAX_CHUNK = 32


def wkv_bwd_plain(r, k, v, w, u, s_hist, d_out, d_s_out, *, chunk: int):
    """Plain version, with the kernel's signature and order of work: the
    chunks back to front, each recomputing its decays from the primals and
    taking its entering state from ``s_hist``."""
    b, h, t, dh = r.shape
    validate_divisible("T", t, chunk)
    n = t // chunk
    f32 = torch.float32
    uu = u.float()[None, :, None, :]                       # (1, H, 1, Dh)
    mask = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                 device=r.device), diagonal=-1)
    zero = torch.zeros((), device=r.device)
    dS = d_s_out.float()
    du = torch.zeros((b, h, dh), dtype=f32, device=r.device)
    grads = [torch.empty((b, h, t, dh), dtype=r.dtype, device=r.device)
             for _ in range(4)]
    for c in reversed(range(n)):
        sl = slice(c * chunk, (c + 1) * chunk)
        rc, kc, vc, wc, do = (a[:, :, sl].float() for a in (r, k, v, w, d_out))
        S = s_hist[:, :, c].float()
        logw = torch.log(wc.clamp(1e-8, 1.0))
        cum_incl = torch.cumsum(logw, dim=2)
        cum_excl = cum_incl - logw
        last_c = cum_incl[:, :, -1:]
        w_total = torch.exp(last_c[:, :, 0])               # (B, H, Dh)
        r_dec = rc * torch.exp(cum_excl)
        k_inv = kc * torch.exp(-cum_incl)
        k_rem = kc * torch.exp(last_c - cum_incl)
        scores = torch.where(mask, r_dec @ k_inv.transpose(-1, -2), zero)
        dscores = torch.where(mask, do @ vc.transpose(-1, -2), zero)
        dov = (do * vc).sum(-1, keepdim=True)              # (B, H, L, 1)

        d_rdec = dscores @ k_inv + do @ S.transpose(-1, -2)
        d_kinv = dscores.transpose(-1, -2) @ r_dec
        d_krem = vc @ dS.transpose(-1, -2)
        dr = d_rdec * torch.exp(cum_excl) + uu * kc * dov
        dk = (d_kinv * torch.exp(-cum_incl) + d_krem * torch.exp(last_c - cum_incl)
              + rc * uu * dov)
        dv = (scores.transpose(-1, -2) @ do + k_rem @ dS
              + (rc * uu * kc).sum(-1, keepdim=True) * do)

        dcum_excl = d_rdec * r_dec
        dcum_incl = -d_kinv * k_inv - d_krem * k_rem
        last = (d_krem * k_rem).sum(2) + w_total * (S * dS).sum(-1)
        dcum_incl[:, :, -1] += last
        suf_incl = torch.flip(torch.cumsum(torch.flip(dcum_incl, (2,)), 2), (2,))
        suf_excl = torch.flip(torch.cumsum(torch.flip(dcum_excl, (2,)), 2), (2,))
        dlogw = suf_incl + suf_excl - dcum_excl
        in_range = (wc >= 1e-8) & (wc <= 1.0)
        dw = torch.where(in_range, dlogw / wc.clamp(1e-8, 1.0), zero)
        for out, g in zip(grads, (dr, dk, dv, dw)):
            out[:, :, sl] = g.to(out.dtype)
        du += (rc * kc * dov).sum(2)
        # Adjoint hand-off to chunk c-1.
        dS = dS * w_total[..., None] + r_dec.transpose(-1, -2) @ do
    return (*grads, du, dS)


def _check_bwd_args(r, k, v, w, u, s_hist, d_out, d_s_out, chunk):
    """Validate the inputs; returns the token count between consecutive
    (b, h) rows of r/k/v/w (T when they are contiguous)."""
    b, h, t, dh = r.shape
    tensors = {"r": r, "k": k, "v": v, "w": w, "u": u, "s_hist": s_hist,
               "d_out": d_out, "d_s_out": d_s_out}
    check_kernel_tensors("wkv_bwd_cuda", strided=("r", "k", "v", "w"), **tensors)
    if r.dtype not in DTYPE_CODE:
        raise ValueError(f"wkv_bwd_cuda: dtype {r.dtype} not supported (float32, bfloat16)")
    for key in ("k", "v", "w", "u", "d_out"):
        if tensors[key].dtype != r.dtype:
            raise ValueError(f"wkv_bwd_cuda: {key} dtype {tensors[key].dtype} != r dtype {r.dtype}")
    for key in ("s_hist", "d_s_out"):
        if tensors[key].dtype != torch.float32:
            raise ValueError(f"wkv_bwd_cuda: {key} must be float32, got {tensors[key].dtype}")
    for key in ("k", "v", "w", "d_out"):
        if tensors[key].shape != r.shape:
            raise ValueError(f"wkv_bwd_cuda: {key} shape {tuple(tensors[key].shape)} != {tuple(r.shape)}")
    if dh != WKV_DH:
        raise ValueError(f"wkv_bwd_cuda: head dim {dh} != {WKV_DH}")
    want = {"u": (h, dh), "s_hist": (b, h, t // chunk, dh, dh), "d_s_out": (b, h, dh, dh)}
    for key, shape in want.items():
        if tuple(tensors[key].shape) != shape:
            raise ValueError(f"wkv_bwd_cuda: {key} shape {tuple(tensors[key].shape)} != {shape}")
    return row_stride("wkv_bwd_cuda", r, k, v, w)


def wkv_bwd_cuda(r, k, v, w, u, s_hist, d_out, d_s_out, *, chunk: int):
    """Reverse chunk sweep.  r/k/v/w/d_out: (B, H, T, 64) of one dtype,
    r/k/v/w contiguous or T-windows of longer contiguous tensors (a shard
    of the sequence-parallel path, read in place), d_out contiguous;
    u: (H, 64); s_hist: (B, H, T/chunk, 64, 64) f32 from the training
    forward; d_s_out: (B, H, 64, 64) f32; ``chunk`` divides T, 1..32.
    Returns ``(dr, dk, dv, dw, du_part, dh0)``.  CPU tensors take the plain
    version."""
    b, h, t, dh = r.shape
    validate_divisible("T", t, chunk)
    if r.device.type == "cpu":
        return wkv_bwd_plain(r, k, v, w, u, s_hist, d_out, d_s_out, chunk=chunk)
    if chunk > BWD_MAX_CHUNK:
        raise ValueError(f"wkv_bwd_cuda: chunk={chunk} > {BWD_MAX_CHUNK}")
    t_stride = _check_bwd_args(r, k, v, w, u, s_hist, d_out, d_s_out, chunk)
    dr, dk, dv, dw = (torch.empty(r.shape, dtype=r.dtype, device=r.device)
                      for _ in range(4))
    du_part = torch.empty((b, h, dh), dtype=torch.float32, device=r.device)
    dh0 = torch.empty((b, h, dh, dh), dtype=torch.float32, device=r.device)
    fn = load_library("wkv_bwd").wkv_bwd
    fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
             u.data_ptr(), s_hist.data_ptr(), d_out.data_ptr(),
             d_s_out.data_ptr(), dr.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             dw.data_ptr(), du_part.data_ptr(), dh0.data_ptr(),
             b, h, t, t_stride, dh, chunk, DTYPE_CODE[r.dtype], launch_stream(r.device))
    if err:
        raise RuntimeError(f"wkv_bwd launch failed: cudaError {err}")
    wkv_bwd_cuda.launches += 1
    return dr, dk, dv, dw, du_part, dh0


wkv_bwd_cuda.launches = 0
