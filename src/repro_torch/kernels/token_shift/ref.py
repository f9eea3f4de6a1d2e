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
    in f32, tap 0 first; output in x.dtype.  Any T >= 1."""
    t = x.shape[1]
    x32 = x.float()
    w32 = w.float()
    out = torch.zeros_like(x32)
    for tap in range(w.shape[0]):
        shifted = F.pad(x32, (0, 0, tap, 0))[:, :t]
        out = out + w32[tap] * shifted
    return out.to(x.dtype)
