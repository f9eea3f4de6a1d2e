"""Plain PyTorch version of the elevator scan kernels (counterpart of
``repro.kernels.elevator_scan.ref``).

h[b, t, d] = a[b, t, d] * h[b, t-1, d] + x[b, t, d],   h[b, -1, d] = h0[b, d]

The paper's prefix-sum dataflow (Fig. 6) with a data-dependent decay: the
RG-LRU recurrence.
"""

from __future__ import annotations

import torch


def elevator_scan_ref_f32(a: torch.Tensor, x: torch.Tensor,
                          h0: torch.Tensor | None = None) -> torch.Tensor:
    """O(T) sequential scan, f32 in and out: each step rounds ``a * h``
    before adding ``x``."""
    b, t, d = x.shape
    a32, x32 = a.float(), x.float()
    h = (torch.zeros((b, d), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    hs = []
    for i in range(t):
        h = a32[:, i] * h + x32[:, i]
        hs.append(h)
    return torch.stack(hs, dim=1)


def elevator_scan_ref(a: torch.Tensor, x: torch.Tensor,
                      h0: torch.Tensor | None = None) -> torch.Tensor:
    """O(T) sequential reference (f32 accumulation, x.dtype out)."""
    return elevator_scan_ref_f32(a, x, h0).to(x.dtype)
