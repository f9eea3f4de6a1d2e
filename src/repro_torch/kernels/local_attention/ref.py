"""Plain PyTorch versions of the flash-attention kernel (counterparts of
``repro.kernels.local_attention.ref``): the exact masked softmax
(:func:`attention_ref`, and :func:`attention_ref_lse` with each row's
log-sum-exp), the flash-structured blockwise form
(:func:`attention_blockwise`), both in f32, and the backward
(:func:`attention_bwd_ref`), which has no Pallas counterpart.

Visibility of key j to query i, with the decode offset o = S - T: causal
``j <= i + o`` and, with a window W, ``j > i + o - W``; non-causal with a
window ``|j - i| < W``.  A query that sees no key gives 0.
"""

from __future__ import annotations

import torch


def attention_mask(t: int, s: int, *, causal: bool = True,
                   window: int | None = None, device=None) -> torch.Tensor:
    """(T, S) bool: which keys each query sees."""
    q_pos = torch.arange(t, device=device)[:, None]
    k_pos = torch.arange(s, device=device)[None, :]
    mask = torch.ones((t, s), dtype=torch.bool, device=device)
    if causal:
        offset = s - t
        mask &= k_pos <= q_pos + offset
        if window is not None:
            mask &= k_pos > q_pos + offset - window
    elif window is not None:
        mask &= (k_pos - q_pos).abs() < window
    return mask


def _masked_logits(q, k, causal, window, scale):
    """scale * q k^T over the visible pairs, -inf elsewhere, in f32 (f64
    for f64 inputs), K repeated over each group's query heads."""
    b, hq, t, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    wide = torch.promote_types(q.dtype, torch.float32)
    k = k.repeat_interleave(hq // hkv, dim=1)
    logits = torch.einsum("bhtd,bhsd->bhts", q.to(wide), k.to(wide)) * scale
    mask = attention_mask(t, s, causal=causal, window=window, device=q.device)
    return logits.masked_fill(~mask, float("-inf")), mask, scale


def attention_ref_lse(q, k, v, *, causal: bool = True, window: int | None = None,
                      scale: float | None = None):
    """:func:`attention_ref` and each row's natural log-sum-exp of the
    visible ``scale * q.k`` (B, Hq, T) f32, +inf for a row that sees no key
    (the CUDA forward's ``lse`` output, what the backward reads)."""
    return _attention(q, k, v, causal, window, scale, with_lse=True)


def _attention(q, k, v, causal, window, scale, *, with_lse):
    hq, hkv = q.shape[1], k.shape[1]
    logits, _, _ = _masked_logits(q, k, causal, window, scale)
    probs = torch.softmax(logits, dim=-1)
    probs = torch.where(torch.isnan(probs), torch.zeros((), device=q.device), probs)
    v = v.repeat_interleave(hq // hkv, dim=1)
    out = torch.einsum("bhts,bhsd->bhtd", probs, v.to(probs.dtype)).to(q.dtype)
    if not with_lse:
        return out
    lse = torch.logsumexp(logits, dim=-1)
    return out, torch.where(torch.isneginf(lse), float("inf"), lse)


def attention_ref(q, k, v, *, causal: bool = True, window: int | None = None,
                  scale: float | None = None) -> torch.Tensor:
    """q: (B, Hq, T, D); k, v: (B, Hkv, S, D) with Hkv | Hq (kv head =
    q head // group).  f32 math (f64 for f64 inputs), output in q.dtype."""
    return _attention(q, k, v, causal, window, scale, with_lse=False)


def attention_bwd_ref(q, k, v, o, lse, do, *, causal: bool = True,
                      window: int | None = None, scale: float | None = None):
    """Plain version of the backward kernels (``csrc/flash_attention_bwd.cu``):
    (dq, dk, dv) in the inputs' dtypes from the forward's output ``o`` and
    ``lse`` and the output cotangent ``do``.  P = exp(scale q k^T - lse) on
    the visible pairs, dV = P^T dO, dS = P (dO V^T - rowsum(dO o O)),
    dQ = scale dS K, dK = scale dS^T Q; dK and dV summed over each KV head's
    group of query heads.  f32 math (f64 for f64 inputs)."""
    b, hq, t, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    group = hq // hkv
    logits, mask, scale = _masked_logits(q, k, causal, window, scale)
    wide = logits.dtype
    p = torch.exp(logits - lse.to(wide)[..., None]).masked_fill(~mask, 0.0)
    do_w, o_w = do.to(wide), o.to(wide)
    k_w = k.to(wide).repeat_interleave(group, dim=1)
    v_w = v.to(wide).repeat_interleave(group, dim=1)
    dv = torch.einsum("bhts,bhtd->bhsd", p, do_w)
    dp = torch.einsum("bhtd,bhsd->bhts", do_w, v_w)
    delta = (do_w * o_w).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta)
    dq = torch.einsum("bhts,bhsd->bhtd", ds, k_w) * scale
    dk = torch.einsum("bhts,bhtd->bhsd", ds, q.to(wide)) * scale
    dk = dk.reshape(b, hkv, group, s, d).sum(dim=2)
    dv = dv.reshape(b, hkv, group, s, d).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def attention_blockwise(q, k, v, *, causal: bool = True,
                        window: int | None = None, scale: float | None = None,
                        block: int = 512) -> torch.Tensor:
    """The same function as :func:`attention_ref` with O(T * block) live
    memory: query blocks in a loop, each carrying online-softmax sums
    (m, l, acc) over the key blocks; causal windows visit only the last
    ``(window + bq) // bk + 2`` key blocks up to their diagonal."""
    b, hq, t, d = q.shape
    _, hkv, s, _ = k.shape
    group = hq // hkv
    scale_ = scale if scale is not None else 1.0 / (d ** 0.5)
    offset = s - t
    dev = q.device
    bq, bk = min(block, t), min(block, s)
    tp, sp = -(-t // bq) * bq, -(-s // bk) * bk
    pad = torch.nn.functional.pad
    qb = pad(q.float(), (0, 0, 0, tp - t)).reshape(b, hq, tp // bq, bq, d)
    kb = pad(k.float(), (0, 0, 0, sp - s)).reshape(b, hkv, sp // bk, bk, d)
    vb = pad(v.float(), (0, 0, 0, sp - s)).reshape(b, hkv, sp // bk, bk, d)
    n_q, n_k = tp // bq, sp // bk
    banded = causal and window is not None
    n_steps = min(n_k, (window + bq) // bk + 2) if banded else n_k
    outs = []
    for qi in range(n_q):
        q_blk = (qb[:, :, qi] * scale_).reshape(b, hkv, group, bq, d)
        q_pos = qi * bq + torch.arange(bq, device=dev)
        top = (qi * bq + bq - 1 + offset) // bk if banded else 0
        m = torch.full((b, hq, bq), -1e30, device=dev)
        l = torch.zeros((b, hq, bq), device=dev)
        acc = torch.zeros((b, hq, bq, d), device=dev)
        for j in range(n_steps):
            kj_raw = top - (n_steps - 1 - j) if banded else j
            kj = min(max(kj_raw, 0), n_k - 1)
            if kj != kj_raw:
                continue            # a clamped band step sees no key: no update
            k_pos = kj * bk + torch.arange(bk, device=dev)
            sc = torch.einsum("bhgqd,bhsd->bhgqs", q_blk, kb[:, :, kj]).reshape(b, hq, bq, bk)
            mask = (k_pos[None, :] < s) & (q_pos[:, None] < t)
            if causal:
                mask &= k_pos[None, :] <= q_pos[:, None] + offset
                if window is not None:
                    mask &= k_pos[None, :] > q_pos[:, None] + offset - window
            elif window is not None:
                mask &= (k_pos[None, :] - q_pos[:, None]).abs() < window
            sc = torch.where(mask, sc, torch.full((), -1e30, device=dev))
            m_new = torch.maximum(m, sc.amax(dim=-1))
            p = torch.exp(sc - m_new[..., None])
            p = torch.where(mask, p, torch.zeros((), device=dev))
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            pv = torch.einsum("bhgqs,bhsd->bhgqd", p.reshape(b, hkv, group, bq, bk),
                              vb[:, :, kj]).reshape(b, hq, bq, d)
            acc = acc * alpha[..., None] + pv
            m = m_new
        outs.append(acc / l.clamp_min(1e-30)[..., None])
    out = torch.stack(outs, dim=2).reshape(b, hq, tp, d)[:, :, :t]
    return out.to(q.dtype)
