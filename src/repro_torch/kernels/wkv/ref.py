"""Plain PyTorch versions of the fused WKV kernels (the port's
counterparts of ``repro.kernels.wkv.ref``).

The RWKV6 (Finch) WKV recurrence, per head with ``Dh``-dim keys/values:

    S_t = diag(w_t) S_{t-1} + k_t^T v_t          (S is Dh x Dh)
    o_t = r_t · (S_{t-1} + u k_t^T v_t)

* :func:`wkv_sequential_ref` — the O(T) sequential loop; the plain version
  of the decode kernels.
* :func:`wkv_chunked_ref` — the decay-ratio chunked form; the plain
  version of the chunked kernel.  ``chunk`` must divide T (the dispatch in
  :mod:`repro_torch.kernels.wkv.ops` picks a divisor explicitly).

Both compute in float32 and return ``(out f32, S_out f32)``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.common import validate_divisible


def wkv_sequential_ref(r, k, v, w, u, h0):
    """O(T) sequential version.  r/k/v/w: (B, H, T, Dh); u: (H, Dh);
    h0: (B, H, Dh, Dh).  Returns (out (B,H,T,Dh) f32, S_out (B,H,Dh,Dh) f32).
    """
    b, h, t, dh = r.shape
    r, k, v, w = (a.float() for a in (r, k, v, w))
    uu = u.float().reshape(1, h, dh, 1)
    S = h0.float()
    outs = []
    for i in range(t):
        kv = k[:, :, i, :, None] * v[:, :, i, None, :]          # (B,H,Dh,Dh)
        outs.append(torch.einsum("bhd,bhde->bhe", r[:, :, i], S + uu * kv))
        S = S * w[:, :, i, :, None] + kv
    return torch.stack(outs, dim=2), S


def wkv_chunked_ref(r, k, v, w, u, h0, chunk: int):
    """Chunked WKV (decay-ratio form).  Same signature/returns as
    :func:`wkv_sequential_ref` plus ``chunk``, which must divide T."""
    b, h, t, dh = r.shape
    validate_divisible("T", t, chunk)
    n = t // chunk
    rc, kc, vc, wc = (
        a.float().reshape(b, h, n, chunk, dh) for a in (r, k, v, w)
    )
    logw = torch.log(wc.clamp(1e-8, 1.0))
    cum_incl = torch.cumsum(logw, dim=3)          # sum_{s<=t} log w_s
    cum_excl = cum_incl - logw                    # sum_{s<t} log w_s
    last = cum_incl[:, :, :, -1:]
    w_total = torch.exp(last[:, :, :, 0])         # (B,H,N,Dh)

    r_dec = rc * torch.exp(cum_excl)              # r_t * D_{<t}
    k_inv = kc * torch.exp(-cum_incl)             # k_s / D_{<=s}
    k_rem = kc * torch.exp(last - cum_incl)       # k_s * D_{(s..L]}

    scores = torch.einsum("bhntd,bhnsd->bhnts", r_dec, k_inv)
    mask = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                 device=r.device), diagonal=-1)
    scores = torch.where(mask, scores, torch.zeros((), device=r.device))
    u_b = u.float().reshape(1, h, 1, 1, dh)
    bonus = torch.einsum("bhntd,bhntd->bhnt", rc * u_b, kc)
    intra = torch.einsum("bhnts,bhnsd->bhntd", scores, vc)
    intra = intra + bonus[..., None] * vc

    S = h0.float()
    inter = []
    for c in range(n):
        inter.append(torch.einsum("bhtd,bhde->bhte", r_dec[:, :, c], S))
        S = S * w_total[:, :, c, :, None] + torch.einsum(
            "bhtd,bhte->bhde", k_rem[:, :, c], vc[:, :, c])
    out = intra + torch.stack(inter, dim=2)
    return out.reshape(b, h, t, dh), S
