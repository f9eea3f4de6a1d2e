"""Differentiable token shift: the forward kernel and the backward kernel
paired in one ``torch.autograd.Function`` (the reference has no Pallas
backward for ``token_shift_pallas``; JAX differentiates its jnp path).

* **forward**: :func:`~repro_torch.kernels.token_shift.kernel.token_shift_cuda`
  on detached contiguous x and w; saves both.
* **backward**: :func:`~repro_torch.kernels.token_shift.kernel.token_shift_bwd_cuda`:
  dx by the taps run anti-causally, dw by deterministic per-block partials.

CPU tensors run the same structure through the plain versions; on CUDA
tensors the kernels launch or raise.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.token_shift.kernel import token_shift_bwd_cuda, token_shift_cuda

__all__ = ["TokenShiftFunction"]


class TokenShiftFunction(torch.autograd.Function):
    """``TokenShiftFunction.apply(x, w) -> out``: x (B, T, D), w (taps, D)
    of one dtype."""

    @staticmethod
    def forward(ctx, x, w):
        x, w = x.detach().contiguous(), w.detach().contiguous()
        ctx.save_for_backward(x, w)
        return token_shift_cuda(x, w)

    @staticmethod
    def backward(ctx, d_out):
        x, w = ctx.saved_tensors
        return token_shift_bwd_cuda(x, w, d_out.to(x.dtype).contiguous())
