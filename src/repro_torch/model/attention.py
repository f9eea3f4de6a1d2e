"""Dense self-attention: GQA with RoPE, full and local windows, and the
KV-cache decode path (counterpart of ``repro.model.attention``).

A cache-free call (``forward``, prompt scoring) runs the flash-attention
kernel (:mod:`repro_torch.kernels.local_attention`).  A call with a
:class:`KVCache` (serving) inserts the window's K/V into the cache, a ring
of slots for local layers (slot = position mod S, per request), and
attends to it in plain PyTorch (f32 einsums over the ring), as the
reference does outside any Pallas kernel.

A :class:`PagedKVCache` (paged serving, :mod:`repro_torch.serve.paging`)
holds the same K/V in pooled fixed-size pages behind a per-slot page
table: the window's K/V are written into the pool in place, the dense view
is gathered back through the table, and the same positional-mask attention
runs on it, so streams equal the dense cache's bit for bit.

Cross-attention (the encoder-decoder arch's decoder blocks) takes q from
the decoder and K/V from the encoder's output ``x_kv`` of its own length
S, with no RoPE and no cache: every call projects K/V again and runs the
flash kernel non-causally, as the reference does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import ClassVar, NamedTuple

import torch

from repro_torch.kernels.local_attention.ops import flash_attention
from repro_torch.model.layers import apply_rope, init_rmsnorm, rms_norm


class KVCache(NamedTuple):
    """Decode-time K/V of one attention layer."""

    k: torch.Tensor          # (B, Hkv, S, Dh)
    v: torch.Tensor          # (B, Hkv, S, Dh)
    length: torch.Tensor     # (B,) int32: tokens filled per request


#: Physical page 0 of every pool is the null page: never allocated, so it
#: stays exactly zero for the life of the pool.  A gather clips unmapped
#: table entries (-1) onto it, so a masked read of an unmapped slot sees
#: the zeros a dense cache's never-written slot holds.
NULL_PAGE = 0


@dataclasses.dataclass(frozen=True, eq=False)
class PagedKVCache:
    """A KV cache stored as pooled fixed-size pages and a per-slot page
    table (the reference's ``PagedKVCache``).

    Logical ring slot ``i`` (position mod ``s_view``) of request ``b``
    lives at offset ``i % page_size`` of physical page
    ``page_table[b, i // page_size]``; ``s_view`` is exactly the sequence
    extent the dense cache would have had, so the gathered view has the
    dense cache's shape and content.  Stacked layers carry a leading L
    axis on every tensor (the same table in every layer).

    ``_fields`` names the tensor children (what :mod:`repro_torch.tree`
    walks and a snapshot stores); ``s_view`` and ``page_size`` are static.
    """

    k: torch.Tensor           # (P, page_size, Hkv, Dh) pooled pages
    v: torch.Tensor           # (P, page_size, Hkv, Dh)
    page_table: torch.Tensor  # (B, NL) int32 physical page ids; -1 = unmapped
    length: torch.Tensor      # (B,) int32: tokens filled per request
    s_view: int               # dense-equivalent sequence extent
    page_size: int            # tokens per page

    _fields: ClassVar[tuple[str, ...]] = ("k", "v", "page_table", "length")

    def _replace(self, **kw) -> "PagedKVCache":
        return dataclasses.replace(self, **kw)

    def layer(self, i: int) -> "PagedKVCache":
        """Layer ``i`` of a stacked node, as views of its tensors."""
        return self._replace(k=self.k[i], v=self.v[i], page_table=self.page_table[i],
                             length=self.length[i])


def init_attention(mk, cfg, name: str, *, cross: bool = False):
    """Self-attention's params; cross-attention (``cross``) has the same."""
    d, hd = cfg.d_model, cfg.head_dim
    nq, nkv = cfg.num_heads + cfg.head_pad, cfg.num_kv_heads
    p = {
        "wq": mk(f"{name}.wq", (d, nq * hd), ("embed", "heads_out")),
        "wk": mk(f"{name}.wk", (d, nkv * hd), ("embed", "kv_out")),
        "wv": mk(f"{name}.wv", (d, nkv * hd), ("embed", "kv_out")),
        "wo": mk(f"{name}.wo", (nq * hd, d), ("heads_out", "embed")),
    }
    if cfg.qkv_bias:
        p["bq"] = mk(f"{name}.bq", (nq * hd,), ("heads_out",), "zeros")
        p["bk"] = mk(f"{name}.bk", (nkv * hd,), ("kv_out",), "zeros")
        p["bv"] = mk(f"{name}.bv", (nkv * hd,), ("kv_out",), "zeros")
    if cfg.qk_norm:
        p["q_norm"] = init_rmsnorm(mk, hd, f"{name}.q_norm")
        p["k_norm"] = init_rmsnorm(mk, hd, f"{name}.k_norm")
    return p


def _project_qkv(params, x, x_kv, cfg):
    """q (B, Hq, T, Dh) from ``x``; k and v (B, Hkv, S, Dh) from ``x_kv``."""
    b, t, _ = x.shape
    s = x_kv.shape[1]
    nq, nkv, hd = cfg.num_heads + cfg.head_pad, cfg.num_kv_heads, cfg.head_dim
    q = x @ params["wq"]
    k = x_kv @ params["wk"]
    v = x_kv @ params["wv"]
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = q.reshape(b, t, nq, hd).transpose(1, 2)
    k = k.reshape(b, s, nkv, hd).transpose(1, 2)
    v = v.reshape(b, s, nkv, hd).transpose(1, 2)
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

    ``x_kv`` (B, S, D) makes it cross-attention over that memory: no RoPE,
    non-causal, and ``kv_cache`` (with ``token_mask``) is ignored, as in
    the reference.
    """
    b, t, _ = x.shape
    cross = x_kv is not None
    q, k, v = _project_qkv(params, x, x_kv if cross else x, cfg)
    window = cfg.attn_window if kind == "local" else None
    if not cross:
        if positions is None:
            positions = torch.arange(t, device=x.device)[None].expand(b, t)
        q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)

    new_cache = None
    if kv_cache is not None and not cross:
        advance = (torch.full((), t, dtype=torch.int32, device=x.device)
                   if token_mask is None else token_mask.sum(dim=1, dtype=torch.int32))
        if isinstance(kv_cache, PagedKVCache):
            # Write the window into the slots' mapped pages in place, gather
            # the dense-shaped view back and run the same positional-mask
            # attention: every valid slot holds the dense cache's value.
            _paged_insert(kv_cache, k, v, token_mask)
            new_cache = kv_cache._replace(length=kv_cache.length + advance)
            k_cache = _paged_gather(kv_cache, kv_cache.k)
            v_cache = _paged_gather(kv_cache, kv_cache.v)
        else:
            k_cache = _masked_insert(kv_cache.k, k, kv_cache.length, token_mask)
            v_cache = _masked_insert(kv_cache.v, v, kv_cache.length, token_mask)
            new_cache = KVCache(k_cache, v_cache, kv_cache.length + advance)
        out = _decode_attention(q, k_cache, v_cache, kv_cache.length, cfg,
                                window=window)
    else:
        out = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                              causal=causal and not cross, window=window)
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


def _paged_gather(cache: PagedKVCache, pool: torch.Tensor) -> torch.Tensor:
    """The dense view ``(B, Hkv, s_view, Dh)`` of ``pool`` through
    ``cache``'s page table.  Unmapped entries (-1) clip to the all-zero
    :data:`NULL_PAGE`; the positional masks reject every such slot, so the
    zeros only keep it finite, as a dense cache's never-written slots."""
    s, ps = cache.s_view, cache.page_size
    b = cache.page_table.shape[0]
    p, _, hkv, dh = pool.shape
    i = torch.arange(s, device=pool.device)
    pages = cache.page_table[:, i // ps].long().clamp_min(0)            # (B, S)
    flat = pages * ps + (i % ps)[None, :]
    out = pool.reshape(p * ps, hkv, dh).index_select(0, flat.reshape(-1))
    return out.reshape(b, s, hkv, dh).transpose(1, 2)


def _paged_targets(cache: PagedKVCache, t: int, token_mask=None):
    """Flat pool rows ``(B * t,)`` that a ``t``-token window written at
    positions ``length..length+t-1`` lands on (ring slot = position mod
    ``s_view``, then the page table), and ``(B * t,)`` bool: which of them
    are real writes (mapped and not masked)."""
    b = cache.page_table.shape[0]
    s, ps = cache.s_view, cache.page_size
    dev = cache.page_table.device
    pos = _lengths_2d(cache.length, b).long() + torch.arange(t, device=dev)[None]
    slot = torch.remainder(pos, s)                                      # (B, t)
    pages = torch.gather(cache.page_table.long(), 1, slot // ps)
    ok = pages >= 0
    if token_mask is not None:
        ok &= token_mask
    return (pages.clamp_min(0) * ps + slot % ps).reshape(-1), ok.reshape(-1)


def _null_rows(flat: torch.Tensor, ok: torch.Tensor, ps: int) -> torch.Tensor:
    """``flat`` where ``ok``, else the :data:`NULL_PAGE` row of the same
    offset: a write that must not land goes there, with the value 0 the
    null page already holds, so every index stays in range and no filter
    has to sync the host."""
    return torch.where(ok, flat, flat % ps)


def _paged_insert(cache: PagedKVCache, k_new: torch.Tensor, v_new: torch.Tensor,
                  token_mask: torch.Tensor | None = None):
    """Write ``k_new`` / ``v_new`` (B, Hkv, t, Dh) into ``cache``'s pools in
    place, at positions ``length..length+t-1`` of each request.

    Only mapped, unmasked targets are written.  The reference scatters the
    others with index -1 and ``mode="drop"``, which JAX normalises to the
    pool's last row before it drops anything, so its masked writes land
    on the last page; here they never reach a live row.  A boolean filter
    would sync the host on every layer, so a dropped write is instead
    routed to the :data:`NULL_PAGE` row of its offset with the value 0,
    which that row already holds: every index stays in range, the null
    page stays zero, and no live row is touched.  The real targets are
    unique (t <= s_view, slots own disjoint pages, and shared pages lie
    below every start length), so the write order does not matter."""
    b, hkv, t, dh = k_new.shape
    s, ps = cache.s_view, cache.page_size
    if t > s:
        raise ValueError(
            f"decode window of {t} tokens exceeds paged view size {s}; "
            f"build the state with init_decode_state(insert_window >= {t})")
    flat, ok = _paged_targets(cache, t, token_mask)
    rows = _null_rows(flat, ok, ps)
    keep = ok[:, None, None]
    for pool, new in ((cache.k, k_new), (cache.v, v_new)):
        src = new.transpose(1, 2).reshape(b * t, hkv, dh).to(pool.dtype)
        pool.view(-1, hkv, dh).index_put_(
            (rows,), torch.where(keep, src, torch.zeros((), dtype=pool.dtype,
                                                        device=pool.device)))


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
