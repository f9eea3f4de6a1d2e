"""Differentiable flash attention: the forward kernel with its log-sum-exp
output and the backward kernels paired in one ``torch.autograd.Function``.

The reference has no Pallas backward for ``flash_attention_pallas``: off
the TPU JAX differentiates its plain jnp path.  Here the gradient runs on
the card through ``csrc/flash_attention_bwd.cu``:

* **forward**: :func:`~repro_torch.kernels.local_attention.kernel.flash_attention_cuda`
  with ``lse=True`` on detached, contiguous q/k/v; saves q, k, v, the output
  and each row's log-sum-exp (B, Hq, T) f32, nothing of size T x S.
* **backward**: :func:`~repro_torch.kernels.local_attention.kernel.flash_attention_bwd_cuda`,
  which recomputes P from the saved log-sum-exp and returns dq, and dk, dv
  summed over each KV head's group of query heads.

CPU tensors run the same structure through the plain versions
(:func:`~repro_torch.kernels.local_attention.ref.attention_ref_lse`,
:func:`~repro_torch.kernels.local_attention.ref.attention_bwd_ref`); on
CUDA tensors the kernels launch or raise; meta tensors take their meta
twins.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.common import by_device
from repro_torch.kernels.local_attention.kernel import (
    flash_attention_bwd_cuda,
    flash_attention_bwd_meta,
    flash_attention_cuda,
    flash_attention_meta,
)

__all__ = ["FlashAttentionFunction"]


class FlashAttentionFunction(torch.autograd.Function):
    """``FlashAttentionFunction.apply(q, k, v, causal, window, scale) ->
    out``: q (B, Hq, T, D), k and v (B, Hkv, S, D), out in q.dtype."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        q, k, v = (x.detach().contiguous() for x in (q, k, v))
        # The wrappers take CPU tensors through their plain versions.
        fwd = by_device(q, flash_attention_cuda, flash_attention_meta)
        out, lse = fwd(q, k, v, causal=causal, window=window, scale=scale, lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = dict(causal=causal, window=window, scale=scale)
        return out

    @staticmethod
    def backward(ctx, d_out):
        # The saved output comes back attached to this node: detach it, as
        # the kernel wrappers take no autograd.
        q, k, v, out, lse = (x.detach() for x in ctx.saved_tensors)
        bwd = by_device(q, flash_attention_bwd_cuda, flash_attention_bwd_meta)
        dq, dk, dv = bwd(q, k, v, out, lse, d_out.to(q.dtype).contiguous(), **ctx.mask)
        return dq, dk, dv, None, None, None
