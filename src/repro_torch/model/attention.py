"""Dense self-attention: GQA with RoPE, full and local windows, and the
KV-cache decode path (counterpart of ``repro.model.attention``).

A cache-free call (``forward``, prompt scoring) runs the flash-attention
kernel (:mod:`repro_torch.kernels.local_attention`).  A call with a
:class:`KVCache` (serving) inserts the window's K/V into the cache, a ring
of slots for local layers (slot = position mod S, per request), and
attends to it in plain PyTorch (f32 einsums over the ring), as the
reference does outside any Pallas kernel.  Cross-attention and the paged
cache are not ported yet.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.kernels.local_attention.ops import flash_attention
from repro_torch.model.layers import apply_rope, init_rmsnorm, rms_norm


class KVCache(NamedTuple):
    """Decode-time K/V of one attention layer."""

    k: torch.Tensor          # (B, Hkv, S, Dh)
    v: torch.Tensor          # (B, Hkv, S, Dh)
    length: torch.Tensor     # (B,) int32: tokens filled per request


def init_attention(mk, cfg, name: str, *, cross: bool = False):
    if cross:
        raise NotImplementedError("cross-attention is not ported to repro_torch yet")
    d, hd = cfg.d_model, cfg.head_dim
    nq, nkv = cfg.num_heads + cfg.head_pad, cfg.num_kv_heads
    p = {
        "wq": mk(f"{name}.wq", (d, nq * hd)),
        "wk": mk(f"{name}.wk", (d, nkv * hd)),
        "wv": mk(f"{name}.wv", (d, nkv * hd)),
        "wo": mk(f"{name}.wo", (nq * hd, d)),
    }
    if cfg.qkv_bias:
        p["bq"] = mk(f"{name}.bq", (nq * hd,), "zeros")
        p["bk"] = mk(f"{name}.bk", (nkv * hd,), "zeros")
        p["bv"] = mk(f"{name}.bv", (nkv * hd,), "zeros")
    if cfg.qk_norm:
        p["q_norm"] = init_rmsnorm(mk, hd, f"{name}.q_norm")
        p["k_norm"] = init_rmsnorm(mk, hd, f"{name}.k_norm")
    return p


def _project_qkv(params, x, cfg):
    """q (B, Hq, T, Dh), k and v (B, Hkv, T, Dh)."""
    b, t, _ = x.shape
    nq, nkv, hd = cfg.num_heads + cfg.head_pad, cfg.num_kv_heads, cfg.head_dim
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = q.reshape(b, t, nq, hd).transpose(1, 2)
    k = k.reshape(b, t, nkv, hd).transpose(1, 2)
    v = v.reshape(b, t, nkv, hd).transpose(1, 2)
    if cfg.qk_norm:
        q = rms_norm(params["q_norm"], q, cfg.norm_eps)
        k = rms_norm(params["k_norm"], k, cfg.norm_eps)
    return q, k, v


def _softcap(logits, cap):
    return cap * torch.tanh(logits / cap) if cap else logits


def apply_attention(params, x: torch.Tensor, cfg, *, kind: str = "attn",
                    positions: torch.Tensor | None = None, causal: bool = True,
                    x_kv: torch.Tensor | None = None,
                    kv_cache: KVCache | None = None,
                    token_mask: torch.Tensor | None = None):
    """Returns (out (B, T, D), new KVCache or None).

    ``token_mask`` (B, T) bool (decode only): masked tokens are not
    inserted into the cache and do not advance the per-request length, so
    a finished slot's cache is untouched and pad tokens never become
    attendable.
    """
    if x_kv is not None:
        raise NotImplementedError("cross-attention is not ported to repro_torch yet")
    b, t, _ = x.shape
    q, k, v = _project_qkv(params, x, cfg)
    window = cfg.attn_window if kind == "local" else None
    if positions is None:
        positions = torch.arange(t, device=x.device)[None].expand(b, t)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)

    new_cache = None
    if kv_cache is not None:
        if not isinstance(kv_cache, KVCache):
            raise NotImplementedError(
                f"{type(kv_cache).__name__} is not ported to repro_torch yet")
        advance = (torch.full((), t, dtype=torch.int32, device=x.device)
                   if token_mask is None else token_mask.sum(dim=1, dtype=torch.int32))
        k_cache = _masked_insert(kv_cache.k, k, kv_cache.length, token_mask)
        v_cache = _masked_insert(kv_cache.v, v, kv_cache.length, token_mask)
        new_cache = KVCache(k_cache, v_cache, kv_cache.length + advance)
        out = _decode_attention(q, k_cache, v_cache, kv_cache.length, cfg,
                                window=window)
    else:
        out = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                              causal=causal, window=window)
    out = out.transpose(1, 2).reshape(b, t, (cfg.num_heads + cfg.head_pad) * cfg.head_dim)
    return out @ params["wo"], new_cache


def _lengths_2d(length: torch.Tensor, b: int) -> torch.Tensor:
    """Per-request lengths as (B, 1); a scalar broadcasts (lockstep)."""
    return torch.as_tensor(length).reshape(-1, 1).expand(b, 1)


def _masked_insert(cache: torch.Tensor, new: torch.Tensor, length: torch.Tensor,
                   token_mask: torch.Tensor | None = None) -> torch.Tensor:
    """``cache`` with ``new`` (B, H, t, D) written at absolute positions
    length..length+t-1 of each request, ring-aware (slot = position mod S).
    A masked token writes nothing.  Returns a new tensor."""
    b, _, s, _ = cache.shape
    t = new.shape[2]
    if t > s:
        raise ValueError(
            f"decode window of {t} tokens exceeds cache size {s}; build the "
            f"state with init_decode_state(insert_window >= {t})")
    idx = torch.arange(s, device=cache.device)
    # The window token landing on each slot; t <= S: at most one per slot.
    off = torch.remainder(idx[None, :] - _lengths_2d(length, b), s)    # (B, S)
    sel = off < t
    src = off.clamp(0, t - 1)
    if token_mask is not None:
        sel &= torch.gather(token_mask, 1, src)
    gathered = torch.gather(
        new.to(cache.dtype), 2,
        src[:, None, :, None].expand(b, cache.shape[1], s, cache.shape[3]))
    return torch.where(sel[:, None, :, None], gathered, cache)


def _decode_attention(q, k_cache, v_cache, cur_pos, cfg, *, window=None):
    """Attention of a window of t >= 1 queries at positions
    cur_pos..cur_pos+t-1 per request (``cur_pos`` (B,) or a scalar, the
    pre-insert length) against a cache that already holds the window.
    Slot i of request b holds absolute position last_b - ((last_b - i) mod S)
    with last_b = cur_pos[b] + t - 1; query j sees the slots at absolute
    positions in [0, cur_pos[b] + j] (and inside the window).  f32 math."""
    b, hq, t, hd = q.shape
    nkv = k_cache.shape[1]
    group = hq // nkv
    s = k_cache.shape[2]
    qg = q.reshape(b, nkv, group, t, hd)
    logits = torch.einsum("bhgtd,bhsd->bhgts", qg.float(), k_cache.float())
    logits = logits * (1.0 / math.sqrt(hd))
    logits = _softcap(logits, cfg.attn_logit_softcap)

    slot = torch.arange(s, device=q.device)
    cur2 = _lengths_2d(cur_pos, b).to(torch.int64)                    # (B, 1)
    last = cur2 + t - 1
    abs_pos = last - torch.remainder(last - slot[None, :], s)         # (B, S)
    qpos = cur2 + torch.arange(t, device=q.device)[None]              # (B, t)
    valid = (abs_pos[:, None, :] >= 0) & (abs_pos[:, None, :] <= qpos[:, :, None])
    if window is not None:
        valid &= abs_pos[:, None, :] > qpos[:, :, None] - window
    valid = valid[:, None, None]                                      # (B,1,1,t,S)
    logits = torch.where(valid, logits, torch.full((), -1e30, device=q.device))
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    p = torch.where(valid, p, torch.zeros((), device=q.device))
    denom = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgts,bhsd->bhgtd", p, v_cache.float())
    out = out / denom.clamp_min(1e-30)
    return out.reshape(b, hq, t, hd).to(q.dtype)
