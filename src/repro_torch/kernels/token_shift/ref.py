"""Plain PyTorch version of the token-shift kernel (counterpart of
``repro.kernels.token_shift.ref``).

out[b, t, d] = sum_{k=0..K-1} w[k, d] * x[b, t-k, d]   (x[t<0] = 0)

A depthwise causal short convolution: the paper's 1-D convolution (Fig. 1)
as elevator shifts, and RecurrentGemma's width-4 temporal conv.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def token_shift_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x: (B, T, D); w: (K, D) per-channel taps, tap k reads x[t-k].  Sums
    in f32 (f64 for f64 inputs), tap 0 first; output in x.dtype.  Any T >= 1."""
    t = x.shape[1]
    wide = torch.promote_types(x.dtype, torch.float32)
    x32 = x.to(wide)
    w32 = w.to(wide)
    out = torch.zeros_like(x32)
    for tap in range(w.shape[0]):
        shifted = F.pad(x32, (0, 0, tap, 0))[:, :t]
        out = out + w32[tap] * shifted
    return out.to(x.dtype)


def token_shift_bwd_ref(x: torch.Tensor, w: torch.Tensor, dout: torch.Tensor):
    """Plain version of the backward kernel: ``dx[t] = sum_k w[k] dout[t+k]``
    (the taps run anti-causally, dout[t >= T] = 0; tap 0 first, in f32,
    rounded once to x.dtype) and ``dw[k] = sum_{b,t} dout[b,t] x[b,t-k]``
    (f32, rounded once to w.dtype).  Returns (dx, dw)."""
    t = x.shape[1]
    wide = torch.promote_types(x.dtype, torch.float32)
    x32, w32, do32 = x.to(wide), w.to(wide), dout.to(wide)
    dx = torch.zeros_like(do32)
    dw = []
    for tap in range(w.shape[0]):
        ahead = F.pad(do32, (0, 0, 0, tap))[:, tap:]
        dx = dx + w32[tap] * ahead
        dw.append((do32 * F.pad(x32, (0, 0, tap, 0))[:, :t]).sum(dim=(0, 1)))
    return dx.to(x.dtype), torch.stack(dw).to(w.dtype)
