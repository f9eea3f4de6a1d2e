"""Public op: flash attention (full / causal / sliding-window, GQA) with
device dispatch (counterpart of ``repro.kernels.local_attention.ops``).

CUDA tensors take the CUDA kernel; CPU tensors take the exact masked
softmax up to 1024 queries and keys and the blockwise form (512-token
blocks) above, as the reference's CPU dispatch does.  Under autograd (grad
enabled and q, k or v requiring grad) the call runs through
:class:`~repro_torch.kernels.local_attention.vjp.FlashAttentionFunction`:
the forward and backward kernels on the card, their plain versions (the
exact masked softmax) on the CPU.  Meta tensors take the kernels' meta
twins (:mod:`repro_torch.core.lowering`).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.common import by_device, on_kernel_device
from repro_torch.kernels.local_attention.kernel import flash_attention_cuda, flash_attention_meta
from repro_torch.kernels.local_attention.ref import (
    attention_blockwise,
    attention_ref,
    attention_ref_lse,
)
from repro_torch.kernels.local_attention.vjp import FlashAttentionFunction

#: Above this many queries or keys the plain path goes blockwise.
BLOCKWISE_ABOVE = 1024


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """Attention over (B, Hq, T, D) queries and (B, Hkv, S, D) keys/values."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return FlashAttentionFunction.apply(q, k, v, causal, window, scale)
    if on_kernel_device(q):
        fn = by_device(q, flash_attention_cuda, flash_attention_meta)
        return fn(q, k, v, causal=causal, window=window, scale=scale)
    if q.shape[2] > BLOCKWISE_ABOVE or k.shape[2] > BLOCKWISE_ABOVE:
        return attention_blockwise(q, k, v, causal=causal, window=window,
                                   scale=scale, block=512)
    return attention_ref(q, k, v, causal=causal, window=window, scale=scale)


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int | None = None,
                        scale: float | None = None):
    """:func:`flash_attention` and each row's natural log-sum-exp of the
    visible ``scale * q.k``, (B, Hq, T) f32 (+inf for a row that sees no
    key): the training forward's instantiation, which a softmax split over
    key shards combines from (sharded decode's cross-attention).  No
    autograd."""
    if on_kernel_device(q):
        fn = by_device(q, flash_attention_cuda, flash_attention_meta)
        return fn(q, k, v, causal=causal, window=window, scale=scale, lse=True)
    return attention_ref_lse(q, k, v, causal=causal, window=window, scale=scale)
