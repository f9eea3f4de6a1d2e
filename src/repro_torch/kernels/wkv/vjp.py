"""Differentiable WKV: the training forward and the reverse sweep paired in
one ``torch.autograd.Function`` (counterpart of
``repro.kernels.wkv.vjp.wkv_diff``).

* **forward**: :func:`~repro_torch.kernels.wkv.kernel.wkv_train_cuda` on
  detached, contiguous primals, which also writes ``s_hist``, the state
  entering each chunk.  The primals and ``s_hist`` are the only saved
  values: the decays and score matrices are recomputed in the backward.
* **backward**: :func:`~repro_torch.kernels.wkv.bwd.wkv_bwd_cuda`, whose
  per-batch ``du`` partials are summed over batch here; the grads are cast
  to the primal dtypes, as the reference's ``_cast_grads`` does.

CPU tensors run the same structure through the plain versions
(``wkv_train_plain``, ``wkv_bwd_plain``), so the CPU tests exercise the
``s_hist`` wiring.  On CUDA tensors the kernels launch or raise.  On the
card a chunk above the backward kernel's limit
(:data:`~repro_torch.kernels.wkv.bwd.BWD_MAX_CHUNK`) runs at the largest
divisor of T below it, the same function in another grouping.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.common import largest_divisor_chunk
from repro_torch.kernels.wkv.bwd import BWD_MAX_CHUNK, wkv_bwd_cuda, wkv_bwd_plain
from repro_torch.kernels.wkv.kernel import wkv_train_cuda, wkv_train_plain

__all__ = ["WKVFunction"]


class WKVFunction(torch.autograd.Function):
    """``WKVFunction.apply(r, k, v, w, u, h0, chunk) -> (out, S_out)``:
    out (B,H,T,Dh) in r.dtype, S_out (B,H,Dh,Dh) f32; ``chunk`` divides T."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, h0, chunk):
        prims = [x.detach().contiguous() for x in (r, k, v, w, u, h0)]
        if r.is_cuda:
            chunk = largest_divisor_chunk(r.shape[2], min(chunk, BWD_MAX_CHUNK))
            out, s_out, s_hist = wkv_train_cuda(*prims, chunk=chunk)
        else:
            out, s_out, s_hist = wkv_train_plain(*prims, chunk=chunk)
        ctx.save_for_backward(*prims, s_hist)
        ctx.chunk = chunk
        return out, s_out

    @staticmethod
    def backward(ctx, d_out, d_s_out):
        r, k, v, w, u, h0, s_hist = ctx.saved_tensors
        # Unused outputs arrive as zeros (grads are materialized): forward()
        # discards S, so a zero d_s_out is the common case.
        d_out = d_out.to(r.dtype).contiguous()
        d_s_out = d_s_out.float().contiguous()
        bwd = wkv_bwd_cuda if r.is_cuda else wkv_bwd_plain
        dr, dk, dv, dw, du_part, dh0 = bwd(
            r, k, v, w, u, s_hist, d_out, d_s_out, chunk=ctx.chunk)
        return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dw.to(w.dtype),
                du_part.sum(0).to(u.dtype), dh0.to(h0.dtype), None)
