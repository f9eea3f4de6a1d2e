"""Plain PyTorch version of the 5-point stencil kernel (counterpart of
``repro.kernels.stencil2d.ref``; the hotspot/SRAD/pathfinder class).

out[i,j] = c0*x[i,j] + c1*x[i-1,j] + c2*x[i+1,j] + c3*x[i,j-1] + c4*x[i,j+1]
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def stencil2d_ref(x: torch.Tensor, coeffs: torch.Tensor, boundary: float = 0.0) -> torch.Tensor:
    """x: (H, W); coeffs: (5,).  Out-of-grid neighbors read ``boundary``.
    Works in f32, sums in the order above (each product rounded before it
    is added) and casts back to x.dtype once."""
    x32 = x.float()
    padded = F.pad(x32, (1, 1, 1, 1), value=boundary)
    up = padded[:-2, 1:-1]
    down = padded[2:, 1:-1]
    left = padded[1:-1, :-2]
    right = padded[1:-1, 2:]
    c = coeffs.float()
    out = c[0] * x32 + c[1] * up + c[2] * down + c[3] * left + c[4] * right
    return out.to(x.dtype)
