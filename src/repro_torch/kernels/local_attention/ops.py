"""Public op: flash attention (full / causal / sliding-window, GQA) with
device dispatch (counterpart of ``repro.kernels.local_attention.ops``).

CUDA tensors take the CUDA kernel; CPU tensors take the exact masked
softmax up to 1024 queries and keys and the blockwise form (512-token
blocks) above, as the reference's CPU dispatch does.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.local_attention.kernel import flash_attention_cuda
from repro_torch.kernels.local_attention.ref import attention_blockwise, attention_ref

#: Above this many queries or keys the plain path goes blockwise.
BLOCKWISE_ABOVE = 1024


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """Attention over (B, Hq, T, D) queries and (B, Hkv, S, D) keys/values."""
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, causal=causal, window=window, scale=scale)
    if q.shape[2] > BLOCKWISE_ABOVE or k.shape[2] > BLOCKWISE_ABOVE:
        return attention_blockwise(q, k, v, causal=causal, window=window,
                                   scale=scale, block=512)
    return attention_ref(q, k, v, causal=causal, window=window, scale=scale)
