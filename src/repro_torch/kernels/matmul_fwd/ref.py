"""Plain PyTorch version of the operand-forwarding matmul (counterpart of
``repro.kernels.matmul_fwd.ref``)."""

from __future__ import annotations

import torch


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The f32 product of both operands cast to f32, returned in a.dtype.
    TF32 is off for the product, whatever the global setting: the
    reference's product is full f32."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = a.float() @ b.float()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return out.to(a.dtype)
