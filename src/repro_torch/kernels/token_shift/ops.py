"""Public op: the token shift with device dispatch (counterpart of
``repro.kernels.token_shift.ops.token_shift``).

CUDA tensors take the CUDA kernel; CPU tensors take the plain version;
meta tensors take the kernel's meta twin (:mod:`repro_torch.core.lowering`).
Under autograd (grad enabled and x or w requiring grad) the call runs
through :class:`~repro_torch.kernels.token_shift.vjp.TokenShiftFunction`:
the forward and backward kernels on the card, the plain versions on the
CPU.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.common import by_device
from repro_torch.kernels.token_shift.kernel import token_shift_cuda, token_shift_meta
from repro_torch.kernels.token_shift.ref import token_shift_ref
from repro_torch.kernels.token_shift.vjp import TokenShiftFunction


def token_shift(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """out[b,t,d] = sum_k w[k,d] x[b,t-k,d] (causal, zero history)."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return TokenShiftFunction.apply(x, w)
    return by_device(x, token_shift_cuda, token_shift_meta, token_shift_ref)(x, w)
