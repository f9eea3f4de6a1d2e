"""Public op: the token shift with device dispatch (counterpart of
``repro.kernels.token_shift.ops.token_shift``).

CUDA tensors take the CUDA kernel; CPU tensors take the plain version.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.token_shift.kernel import token_shift_cuda
from repro_torch.kernels.token_shift.ref import token_shift_ref


def token_shift(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """out[b,t,d] = sum_k w[k,d] x[b,t-k,d] (causal, zero history)."""
    if x.is_cuda:
        return token_shift_cuda(x, w)
    return token_shift_ref(x, w)
