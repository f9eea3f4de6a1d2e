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
  :func:`wkv_chunked_hist_ref` is the same sweep that also returns
  ``s_hist``, the state entering each chunk (the training forward).
* :func:`wkv_segment_decay` and :func:`wkv_entry_correction` — the two
  halves the sequence-parallel path adds around a shard's sweep: the
  segment's decay product (the plain version of the summary kernels'
  ``a_seg``) and the contribution of the shard's entering state to its
  outputs.
* :func:`wkv_chunked_bwd_ref` — the hand-derived chunked backward: the
  cotangents of (r, k, v, w, u, h0) from the primals and the output
  cotangents, recomputing the entry states and decays.  The oracle of the
  backward kernel, held against ``torch.autograd`` through
  :func:`wkv_sequential_ref` in the tests.

All compute in float32; the forwards return ``(out f32, S_out f32)``.
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
    out, s, _ = wkv_chunked_hist_ref(r, k, v, w, u, h0, chunk)
    return out, s


def _decays(wc):
    """The decay-ratio factors of chunked w (B,H,N,L,Dh): (cum_incl,
    cum_excl, w_total (B,H,N,Dh)), all f32."""
    logw = torch.log(wc.clamp(1e-8, 1.0))
    cum_incl = torch.cumsum(logw, dim=3)          # sum_{s<=t} log w_s
    cum_excl = cum_incl - logw                    # sum_{s<t} log w_s
    return cum_incl, cum_excl, torch.exp(cum_incl[:, :, :, -1])


def wkv_chunked_hist_ref(r, k, v, w, u, h0, chunk: int):
    """:func:`wkv_chunked_ref` that also returns ``s_hist`` (B, H, T/chunk,
    Dh, Dh) f32, the state entering each chunk."""
    b, h, t, dh = r.shape
    validate_divisible("T", t, chunk)
    n = t // chunk
    rc, kc, vc, wc = (
        a.float().reshape(b, h, n, chunk, dh) for a in (r, k, v, w)
    )
    cum_incl, cum_excl, w_total = _decays(wc)
    last = cum_incl[:, :, :, -1:]

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
    inter, hist = [], []
    for c in range(n):
        hist.append(S)
        inter.append(torch.einsum("bhtd,bhde->bhte", r_dec[:, :, c], S))
        S = S * w_total[:, :, c, :, None] + torch.einsum(
            "bhtd,bhte->bhde", k_rem[:, :, c], vc[:, :, c])
    out = intra + torch.stack(inter, dim=2)
    return out.reshape(b, h, t, dh), S, torch.stack(hist, dim=2)


def wkv_segment_decay(w):
    """Segment decay product ``A_seg`` (B, H, Dh) f32, the diag-decay half
    of the (A, S) segment summary: ``S_exit = A_seg[..., None] * S_enter +
    S_exit_from_zero`` (the DIAG_STATE monoid action of
    :mod:`repro_torch.core.chunk_scan`).  The same decay clip as the
    kernels; ``exp`` of one sum, so a long segment underflows to 0."""
    logw = torch.log(w.float().clamp(1e-8, 1.0))
    return torch.exp(logw.sum(dim=2))


def wkv_entry_correction(r, w, s_in):
    """Contribution of a segment's *entering* state to every output token:
    ``o_t += (r_t ⊙ D_{<t}) @ S_in`` with ``D_{<t}`` the decay product over
    the segment's earlier tokens.  r/w: (B, H, T, Dh); s_in: (B, H, Dh,
    Dh).  Returns (B, H, T, Dh) f32.  Exponents are <= 0 (pure decays), so
    long segments underflow toward 0 instead of overflowing.

    The running sum over T is taken with T as the last, contiguous axis:
    on the card a scan over an outer axis of (B, H, T, Dh) runs one thread
    per (b, h, column) down all T tokens, 206 µs a call at B=1, H=32,
    T=1024 on an H100, against 32 µs for the last-axis scan."""
    logw = torch.log(w.float().clamp(1e-8, 1.0)).transpose(2, 3).contiguous()
    cum_excl = (torch.cumsum(logw, dim=3) - logw).transpose(2, 3)
    r_dec = r.float() * torch.exp(cum_excl)
    return torch.matmul(r_dec, s_in.float())


def _rev_cumsum(x, dim):
    """Suffix sums along ``dim``: the adjoint of ``cumsum``."""
    return torch.flip(torch.cumsum(torch.flip(x, (dim,)), dim), (dim,))


def wkv_chunked_bwd_ref(r, k, v, w, u, h0, d_out, d_s_out, chunk: int):
    """Chunked WKV backward (counterpart of the reference's
    ``wkv_chunked_bwd_ref``): cotangents for (r, k, v, w, u, h0).

    Inputs are the forward primals plus the output cotangents ``d_out``
    (B,H,T,Dh) and ``d_s_out`` (B,H,Dh,Dh).  Returns ``(dr, dk, dv, dw, du,
    dh0)`` in float32 with the primal shapes (``du`` summed over batch).

    Per chunk of length L with entering state S and exit-state adjoint G,
    the adjoint of the entering state is ``diag(W) G + r_dec^T do``: the
    recurrence the back-to-front sweep carries.  The entry states come from
    a forward pre-pass over chunk summaries; the ``w`` gradient flows back
    through the cumulative log-decays as suffix sums.
    """
    b, h, t, dh = r.shape
    validate_divisible("T", t, chunk)
    n = t // chunk
    rc, kc, vc, wc, do = (
        a.float().reshape(b, h, n, chunk, dh) for a in (r, k, v, w, d_out))
    cum_incl, cum_excl, w_total = _decays(wc)
    last_c = cum_incl[:, :, :, -1:]
    r_dec = rc * torch.exp(cum_excl)
    k_inv = kc * torch.exp(-cum_incl)
    k_rem = kc * torch.exp(last_c - cum_incl)

    # Forward pre-pass: the state entering each chunk.
    S = h0.float()
    S_e = []
    for c in range(n):
        S_e.append(S)
        S = S * w_total[:, :, c, :, None] + torch.einsum(
            "bhtd,bhte->bhde", k_rem[:, :, c], vc[:, :, c])
    S_e = torch.stack(S_e, dim=2)                              # (B,H,N,Dh,Dh)

    # Reverse sweep: G[c] = adjoint of chunk c's exit state.
    dS = d_s_out.float()
    G = [None] * n
    for c in reversed(range(n)):
        G[c] = dS
        dS = dS * w_total[:, :, c, :, None] + torch.einsum(
            "bhtd,bhte->bhde", r_dec[:, :, c], do[:, :, c])
    dh0 = dS
    G = torch.stack(G, dim=2)

    mask = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                 device=r.device), diagonal=-1)
    zero = torch.zeros((), device=r.device)
    scores = torch.where(mask, torch.einsum("bhntd,bhnsd->bhnts", r_dec, k_inv), zero)
    dscores = torch.where(mask, torch.einsum("bhnte,bhnse->bhnts", do, vc), zero)

    u_b = u.float().reshape(1, h, 1, 1, dh)
    dov = (do * vc).sum(-1, keepdim=True)                       # (B,H,N,L,1)

    d_rdec = (torch.einsum("bhnts,bhnsd->bhntd", dscores, k_inv)
              + torch.einsum("bhnte,bhnde->bhntd", do, S_e))
    d_kinv = torch.einsum("bhnts,bhntd->bhnsd", dscores, r_dec)
    d_krem = torch.einsum("bhnse,bhnde->bhnsd", vc, G)

    dr = d_rdec * torch.exp(cum_excl) + u_b * kc * dov
    dk = (d_kinv * torch.exp(-cum_incl)
          + d_krem * torch.exp(last_c - cum_incl)
          + rc * u_b * dov)
    dv = (torch.einsum("bhnts,bhnte->bhnse", scores, do)
          + torch.einsum("bhnsd,bhnde->bhnse", k_rem, G)
          + (rc * u_b * kc).sum(-1, keepdim=True) * do)

    # logw adjoint: the cum_incl[-1] terms (k_rem's numerator and w_total
    # in the exit decay) land on the last row before the suffix sums.
    dcum_excl = d_rdec * r_dec
    dcum_incl = -d_kinv * k_inv - d_krem * k_rem
    last = ((d_krem * k_rem).sum(3)
            + w_total * torch.einsum("bhnde,bhnde->bhnd", S_e, G))
    dcum_incl[:, :, :, -1] += last
    dlogw = _rev_cumsum(dcum_incl, 3) + _rev_cumsum(dcum_excl, 3) - dcum_excl
    in_range = (wc >= 1e-8) & (wc <= 1.0)
    dw = torch.where(in_range, dlogw / wc.clamp(1e-8, 1.0), zero)

    du = torch.einsum("bhntd,bhntd,bhnt->hd", rc, kc, dov[..., 0])

    def rs(a):
        return a.reshape(b, h, t, dh)

    return rs(dr), rs(dk), rs(dv), rs(dw), du, dh0
