"""Differentiable WKV: the training forward and the reverse sweep paired in
one ``torch.autograd.Function`` (counterpart of
``repro.kernels.wkv.vjp.wkv_diff``), and its segment-summary twin
:class:`WKVSummaryFunction` (counterpart of ``wkv_diff_summary``).

* **forward**: :func:`~repro_torch.kernels.wkv.kernel.wkv_train_cuda` on
  detached, contiguous primals (the summary twin's r/k/v/w may be T-windows,
  read in place), which also writes ``s_hist``, the state
  entering each chunk.  The primals and ``s_hist`` are the only saved
  values: the decays and score matrices are recomputed in the backward.
* **backward**: :func:`~repro_torch.kernels.wkv.bwd.wkv_bwd_cuda`, whose
  per-batch ``du`` partials are summed over batch here; the grads are cast
  to the primal dtypes, as the reference's ``_cast_grads`` does.

CPU tensors run the same structure through the plain versions
(``wkv_train_plain``, ``wkv_bwd_plain``), so the CPU tests exercise the
``s_hist`` wiring.  On CUDA tensors the kernels launch or raise; meta
tensors take their meta twins, as the card would.  On the
card a chunk above the backward kernel's limit
(:data:`~repro_torch.kernels.wkv.bwd.BWD_MAX_CHUNK`) runs at the largest
divisor of T below it, the same function in another grouping.

:class:`WKVSummaryFunction` also returns ``a_seg``, the product of the
segment's decays, from the same sweep (``wkv_train_summary_cuda``).  Its
backward is the same reverse sweep plus the ``a_seg`` cotangent folded into
``dw`` in closed form: ``a_seg = exp(Σ_t log w_t)``, so ``∂a_seg/∂w_t =
a_seg / w_t`` on the in-range (unclipped) steps.  That cotangent is what
flows back through the device-space carry of the sequence-parallel path
(:mod:`repro_torch.kernels.wkv.seqpar`) during sequence-sharded training.

:class:`WKVDecodeFunction` (counterpart of the reference's
``wkv_decode_diff``) makes a stateful decode window differentiable: its
forward is the decode kernels (the single step at K = 1, the window
otherwise), and only the primals are saved.  Its backward recomputes over
the stage, as the reference does: the training forward for ``s_hist``, then
the reverse sweep, at :data:`DECODE_GRAD_CHUNK` (the reference's chunk 1).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.common import by_device, largest_divisor_chunk, on_kernel_device
from repro_torch.kernels.wkv.bwd import BWD_MAX_CHUNK, wkv_bwd_cuda, wkv_bwd_meta, wkv_bwd_plain
from repro_torch.kernels.wkv.decode import (
    wkv_decode_cuda,
    wkv_decode_meta,
    wkv_decode_plain,
    wkv_decode_window_cuda,
    wkv_decode_window_meta,
)
from repro_torch.kernels.wkv.kernel import (
    wkv_train_cuda,
    wkv_train_meta,
    wkv_train_plain,
    wkv_train_summary_cuda,
    wkv_train_summary_meta,
    wkv_train_summary_plain,
)

__all__ = ["WKVFunction", "WKVSummaryFunction", "WKVDecodeFunction", "DECODE_GRAD_CHUNK"]

#: The chunk of the decode window's recompute-over-stage backward (the
#: reference's ``wkv_chunked_bwd_ref(..., chunk=1)``).
DECODE_GRAD_CHUNK = 1


def _train_forward(ctx, r, k, v, w, u, h0, chunk, summary):
    """The training forward on detached, contiguous primals; saves the
    primals and ``s_hist`` (and ``a_seg``) for :func:`_reverse_sweep`.  The
    summary sweep and the reverse sweep read T-windows of longer tensors in
    place, so there r/k/v/w are kept as given: a shard of the
    sequence-parallel path is saved as a view, never copied."""
    prims = [x.detach() if summary and i < 4 else x.detach().contiguous()
             for i, x in enumerate((r, k, v, w, u, h0))]
    if on_kernel_device(r):
        chunk = largest_divisor_chunk(r.shape[2], min(chunk, BWD_MAX_CHUNK))
    if summary:
        fwd = by_device(r, wkv_train_summary_cuda, wkv_train_summary_meta,
                        wkv_train_summary_plain)
    else:
        fwd = by_device(r, wkv_train_cuda, wkv_train_meta, wkv_train_plain)
    outs = fwd(*prims, chunk=chunk)
    ctx.save_for_backward(*prims, *outs[2:])
    ctx.chunk = chunk
    return outs


def _reverse_sweep(ctx, saved, d_out, d_s_out):
    """The primals and the cotangents of (r, k, v, w, u, h0) from the
    reverse sweep; ``du`` summed over batch.  ``saved`` is
    ``ctx.saved_tensors``, which may be read only once (under
    ``torch.utils.checkpoint`` a second read raises)."""
    r, k, v, w, u, h0, s_hist = saved[:7]
    # Unused outputs arrive as zeros (grads are materialized): forward()
    # discards S, so a zero d_s_out is the common case.  d_out is copied
    # only when it arrives as a view (an f32 shard's slice of the whole
    # cotangent; a bf16 shard's arrives contiguous from its cast).
    d_out = d_out.to(r.dtype).contiguous()
    d_s_out = d_s_out.float().contiguous()
    bwd = by_device(r, wkv_bwd_cuda, wkv_bwd_meta, wkv_bwd_plain)
    dr, dk, dv, dw, du_part, dh0 = bwd(
        r, k, v, w, u, s_hist, d_out, d_s_out, chunk=ctx.chunk)
    return (r, k, v, w, u, h0), [dr, dk, dv, dw, du_part.sum(0), dh0]


def _cast(prims, grads):
    return tuple(g.to(p.dtype) for p, g in zip(prims, grads)) + (None,)


class WKVFunction(torch.autograd.Function):
    """``WKVFunction.apply(r, k, v, w, u, h0, chunk) -> (out, S_out)``:
    out (B,H,T,Dh) in r.dtype, S_out (B,H,Dh,Dh) f32; ``chunk`` divides T."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, h0, chunk):
        out, s_out, _ = _train_forward(ctx, r, k, v, w, u, h0, chunk, summary=False)
        return out, s_out

    @staticmethod
    def backward(ctx, d_out, d_s_out):
        return _cast(*_reverse_sweep(ctx, ctx.saved_tensors, d_out, d_s_out))


class WKVSummaryFunction(torch.autograd.Function):
    """``WKVSummaryFunction.apply(r, k, v, w, u, h0, chunk) -> (out, S_out,
    a_seg)``: :class:`WKVFunction` plus ``a_seg`` (B,H,Dh) f32, the product
    of the segment's clipped decays."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, h0, chunk):
        out, s_out, _, a_seg = _train_forward(ctx, r, k, v, w, u, h0, chunk,
                                              summary=True)
        return out, s_out, a_seg

    @staticmethod
    def backward(ctx, d_out, d_s_out, d_a):
        saved = ctx.saved_tensors
        prims, grads = _reverse_sweep(ctx, saved, d_out, d_s_out)
        w, a_seg = prims[3], saved[7]
        # a_seg = exp(Σ_t log w_t): d log w_t += d_a · a_seg for every t, and
        # dw_t += d log w_t / w_t on the in-range (unclipped) steps.
        w32 = w.float()
        in_range = (w32 >= 1e-8) & (w32 <= 1.0)
        fold = (d_a.float() * a_seg)[:, :, None, :] / w32.clamp(1e-8, 1.0)
        grads[3] = grads[3].float() + torch.where(in_range, fold, 0.0)
        return _cast(prims, grads)


class WKVDecodeFunction(torch.autograd.Function):
    """``WKVDecodeFunction.apply(r, k, v, w, u, h0) -> (out, S_out)``: a
    K-token decode window, 1 <= K <= 64; out (B,H,K,Dh) in r.dtype, S_out
    f32."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, h0):
        prims = [x.detach().contiguous() for x in (r, k, v, w, u, h0)]
        ctx.save_for_backward(*prims)
        if r.shape[2] == 1:
            return by_device(r, wkv_decode_cuda, wkv_decode_meta, wkv_decode_plain)(*prims)
        return by_device(r, wkv_decode_window_cuda, wkv_decode_window_meta,
                         wkv_decode_plain)(*prims)

    @staticmethod
    def backward(ctx, d_out, d_s_out):
        prims = ctx.saved_tensors
        fwd = by_device(prims[0], wkv_train_cuda, wkv_train_meta, wkv_train_plain)
        s_hist = fwd(*prims, chunk=DECODE_GRAD_CHUNK)[2]
        ctx.chunk = DECODE_GRAD_CHUNK
        return _cast(*_reverse_sweep(ctx, (*prims, s_hist), d_out, d_s_out))[:6]
