"""Differentiable token shift: the forward kernel and the backward kernel
paired in one ``torch.autograd.Function`` (the reference has no Pallas
backward for ``token_shift_pallas``; JAX differentiates its jnp path).

* **forward**: :func:`~repro_torch.kernels.token_shift.kernel.token_shift_cuda`
  on detached contiguous x and w; saves both.
* **backward**: :func:`~repro_torch.kernels.token_shift.kernel.token_shift_bwd_cuda`:
  dx by the taps run anti-causally, dw by deterministic per-block partials.

CPU tensors run the same structure through the plain versions; on CUDA
tensors the kernels launch or raise; meta tensors take their meta twins.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.common import by_device
from repro_torch.kernels.token_shift.kernel import (
    token_shift_bwd_cuda,
    token_shift_bwd_meta,
    token_shift_cuda,
    token_shift_meta,
)

__all__ = ["TokenShiftFunction"]


class TokenShiftFunction(torch.autograd.Function):
    """``TokenShiftFunction.apply(x, w) -> out``: x (B, T, D), w (taps, D)
    of one dtype."""

    @staticmethod
    def forward(ctx, x, w):
        x, w = x.detach().contiguous(), w.detach().contiguous()
        ctx.save_for_backward(x, w)
        # The wrappers take CPU tensors through their plain versions.
        return by_device(x, token_shift_cuda, token_shift_meta)(x, w)

    @staticmethod
    def backward(ctx, d_out):
        x, w = ctx.saved_tensors
        bwd = by_device(x, token_shift_bwd_cuda, token_shift_bwd_meta)
        return bwd(x, w, d_out.to(x.dtype).contiguous())
