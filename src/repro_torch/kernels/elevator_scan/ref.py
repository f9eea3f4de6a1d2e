"""Plain PyTorch version of the elevator scan kernels (counterpart of
``repro.kernels.elevator_scan.ref``).

h[b, t, d] = a[b, t, d] * h[b, t-1, d] + x[b, t, d],   h[b, -1, d] = h0[b, d]

The paper's prefix-sum dataflow (Fig. 6) with a data-dependent decay: the
RG-LRU recurrence.  :func:`elevator_scan_bwd_ref` is its backward.
"""

from __future__ import annotations

import torch

from repro_torch.core.lowering import plain_version


def elevator_scan_ref_f32(a: torch.Tensor, x: torch.Tensor,
                          h0: torch.Tensor | None = None) -> torch.Tensor:
    """O(T) sequential scan, f32 in and out (f64 for f64 inputs): each step
    rounds ``a * h`` before adding ``x``."""
    b, t, d = x.shape
    wide = torch.promote_types(x.dtype, torch.float32)
    a32, x32 = a.to(wide), x.to(wide)
    h = (torch.zeros((b, d), dtype=wide, device=x.device)
         if h0 is None else h0.to(wide))
    hs = []
    for i in range(t):
        h = a32[:, i] * h + x32[:, i]
        hs.append(h)
    return torch.stack(hs, dim=1)


@plain_version
def elevator_scan_ref(a: torch.Tensor, x: torch.Tensor,
                      h0: torch.Tensor | None = None) -> torch.Tensor:
    """O(T) sequential reference (f32 accumulation, x.dtype out)."""
    return elevator_scan_ref_f32(a, x, h0).to(x.dtype)


def elevator_scan_bwd_ref(a: torch.Tensor, h: torch.Tensor, dh: torch.Tensor,
                          h0: torch.Tensor | None = None):
    """Plain version of the backward kernel (counterpart of the reference's
    closed-form ``_elevator_decode_bwd``): from the forward's f32 states h
    (B, T, D) and the cotangent dh, the reverse chain ``g[t] = dh[t] +
    a[t+1] g[t+1]`` (each step rounds a * g before adding dh), ``da[t] =
    g[t] h[t-1]``, ``dx = g`` and ``dh0 = a[0] g[0]`` (h[-1] = h0, zeros
    where None).  Returns (da in a.dtype, dx in dh.dtype, dh0 (B, D) f32);
    f64 inputs run in f64."""
    b, t, d = a.shape
    wide = torch.promote_types(h.dtype, torch.float32)
    a32, dh32, h32 = a.to(wide), dh.to(wide), h.to(wide)
    h_init = (torch.zeros((b, d), dtype=wide, device=a.device)
              if h0 is None else h0.to(wide))
    g = torch.zeros((b, d), dtype=wide, device=a.device)
    a_next = torch.ones((b, d), dtype=wide, device=a.device)
    gs = [None] * t
    for i in range(t - 1, -1, -1):
        g = a_next * g + dh32[:, i]
        gs[i] = g
        a_next = a32[:, i]
    gt = torch.stack(gs, dim=1)
    h_prev = torch.cat([h_init[:, None], h32[:, :-1]], dim=1)
    return (gt * h_prev).to(a.dtype), gt.to(dh.dtype), a_next * g
