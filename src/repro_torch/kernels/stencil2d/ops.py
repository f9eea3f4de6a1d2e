"""Public op: the 5-point stencil sweep (hotspot/SRAD building block)
(counterpart of ``repro.kernels.stencil2d.ops.stencil2d``).

CUDA tensors take the CUDA kernel; CPU tensors take the plain version;
meta tensors take the kernel's meta twin (:mod:`repro_torch.core.lowering`).
The reference's ``use_kernel`` knob is not kept: the tensor's device alone
decides, as in the port's other ops.  The kernel takes any H, so the op
picks no ``block_h``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.common import by_device
from repro_torch.kernels.stencil2d.kernel import stencil2d_cuda, stencil2d_meta


def stencil2d(x: torch.Tensor, coeffs, *, boundary: float = 0.0) -> torch.Tensor:
    """out = c0·x + c1·up + c2·down + c3·left + c4·right, out-of-grid
    neighbours read ``boundary``; x: (H, W), coeffs: (5,)."""
    fn = by_device(x, stencil2d_cuda, stencil2d_meta)
    return fn(x, torch.as_tensor(coeffs, device=x.device), boundary=boundary)
