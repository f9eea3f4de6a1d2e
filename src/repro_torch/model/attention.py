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

On a (data, model) mesh (:mod:`repro_torch.model.sharding`) the
projections are column-parallel over the heads and the output projection
row-parallel, as the reference's ``attention.py:103-112, 202-205`` place
them.  A cache-free call (and cross-attention under train or prefill
rules, whose frames stay whole on each batch shard) runs the flash kernel
once a shard on that shard's heads.  Where the heads do not divide the
model axis (:func:`heads_plan`), the port replicates what GSPMD would:

* ``"share_kv"``: the query heads divide it but the KV heads do not
  (qwen2-vl's 4 KV heads, or qwen3-moe's, over 8): K and V are
  all-gathered over the model axis and each shard keeps the KV heads its
  query heads read (a GQA group shared across shards);
* ``"replicate"``: the query heads do not divide it (qwen2-vl's 28 over
  8, where ``head_pad=4`` makes 32): Q, K and V are all-gathered and every
  shard computes every head, then keeps its slice of the output for the
  row-parallel ``wo``.

Under the decode rules the keys are split over the KV sequence's mesh
axes (``model`` under ``decode``, every axis under ``decode_long``), and
each shard holds every head of its slots.  So q and the window's new K/V
rows are all-gathered over the model axis (heads whole: at most a window
of rows), each shard writes the rows whose ring slot (position mod the
global cache length S) it owns and attends over its slots, and the
shards' softmax partials are merged by
:func:`~repro_torch.model.sharding.combine_partials` (an all-reduce max of
the row maxima, then an all-reduce sum of the rescaled numerators and
denominators, over each KV axis); the merged output is whole on every
shard and splits onto its heads for ``wo`` at no cost.  Cross-attention
under ``decode`` takes the encoder's frames split over the KV sequence's
axes: each shard runs the flash kernel's log-sum-exp instantiation over
its frames and the same combine merges them.  One spec cannot map the
model axis twice, so there ``wk`` and ``wv`` are gathered whole (over the
model axis, and over data where FSDP splits them) and the frames stay
split: each shard projects every head of its own frames.
"""

from __future__ import annotations

import dataclasses
import math
from typing import ClassVar, NamedTuple

import torch

from repro_torch.kernels.local_attention.ops import flash_attention, flash_attention_lse
from repro_torch.model.layers import apply_rope, init_rmsnorm, rms_norm
from repro_torch.model.sharding import (
    along,
    axes_size,
    combine_partials,
    constrain,
    dense,
    gather_for_use,
    is_sharded,
    offset,
    reshard,
    rule_axes,
    shard_index,
    smap,
)


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
    """q (B, T, Hq*Dh) from ``x``; k and v (B, S, Hkv*Dh) from ``x_kv``:
    column-parallel over the heads on a mesh."""
    g = cfg.fsdp_gather_weights
    out = []
    for src, w, bias, axis in ((x, "wq", "bq", "heads_out"), (x_kv, "wk", "bk", "kv_out"),
                               (x_kv, "wv", "bv", "kv_out")):
        z = dense(src, gather_for_use(params[w], ("embed", axis), g))
        z = constrain(z, "batch", "seq", "act_heads")
        if cfg.qkv_bias:
            z = smap(torch.add, z, along(params[bias], z))
        out.append(z)
    return tuple(out)


def _heads(z, hd: int):
    """(B, T, H*Dh) -> (B, H, T, Dh)."""
    return z.reshape(z.shape[0], z.shape[1], -1, hd).transpose(1, 2)


def heads_plan(nq: int, nkv: int, tp: int) -> str:
    """How attention splits ``nq`` query and ``nkv`` KV heads over a model
    axis of ``tp`` shards: ``"split"`` (both divide it), ``"share_kv"``
    (the query heads divide it and each shard's query heads read whole KV
    heads of one GQA grouping) or ``"replicate"``."""
    if nq % tp == 0 and nkv % tp == 0:
        return "split"
    if nq % tp == 0:
        nql, group = nq // tp, nq // nkv
        if nql % group == 0 or group % nql == 0:
            return "share_kv"
    return "replicate"


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
    cross = x_kv is not None
    if is_sharded(x) and cross and x_kv.dims[1]:
        return _cross_split_frames(params, x, x_kv, cfg), None
    if kv_cache is not None and not cross:
        if not isinstance(kv_cache, PagedKVCache):
            return _decode_dense(params, x, cfg, kind, positions, kv_cache, token_mask)
        if is_sharded(x):
            raise NotImplementedError("a paged cache under a mesh is not ported: its pools "
                                      "are replicated while its tables split by batch")
    nq, nkv, hd = cfg.num_heads + cfg.head_pad, cfg.num_kv_heads, cfg.head_dim
    q, k, v = _project_qkv(params, x, x_kv if cross else x, cfg)
    plan, heads_axes = "split", ()
    if is_sharded(x):
        heads_axes = rule_axes("act_heads")
        tp = axes_size(x.mesh, heads_axes)
        plan = heads_plan(nq, nkv, tp)
        whole = q.dims[:-1] + ((),)
        if plan == "replicate":
            q = reshard(q, whole)
        if plan != "split":
            k, v = reshard(k, whole), reshard(v, whole)
    window = cfg.attn_window if kind == "local" else None
    new_cache = None

    def core(cell, ql, kl, vl, pos, qn, kn):
        """One shard's heads (all of them off a mesh): qk-norm, RoPE, and
        flash attention or the paged cache's decode attention."""
        nonlocal new_cache
        b, t = ql.shape[:2]
        q, k, v = _heads(ql, hd), _heads(kl, hd), _heads(vl, hd)
        if plan == "share_kv":      # the KV heads this shard's query heads read
            m, nql = shard_index(x.mesh, cell, heads_axes), nq // tp
            lo, hi = m * nql * nkv // nq, ((m + 1) * nql - 1) * nkv // nq + 1
            k, v = k[:, lo:hi], v[:, lo:hi]
        if not cross and pos is None:
            pos = torch.arange(t, device=ql.device)[None].expand(b, t)
        q, k = _norm_rope(cfg, q, k, qn, kn, None if cross else pos)
        if kv_cache is not None and not cross:
            # A paged cache: write the window into the slots' mapped pages
            # in place, gather the dense-shaped view back and run the same
            # positional-mask attention: every valid slot holds the dense
            # cache's value.
            _paged_insert(kv_cache, k, v, token_mask)
            new_cache = kv_cache._replace(length=kv_cache.length + _advance(token_mask, t, ql))
            parts = _decode_partials(q, _paged_gather(kv_cache, kv_cache.k),
                                     _paged_gather(kv_cache, kv_cache.v), kv_cache.length, cfg,
                                     window=window)
            out = combine_partials(*parts, ()).to(q.dtype)
        else:
            out = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                  causal=causal and not cross, window=window)
        return out.transpose(1, 2).reshape(b, t, -1)

    out = constrain(smap(core, q, k, v, positions, *_norms(params, cfg), cell=True),
                    "batch", "seq", "act_heads")
    wo = gather_for_use(params["wo"], ("heads_out", "embed"), cfg.fsdp_gather_weights)
    return constrain(dense(out, wo), "batch", "seq", "act_embed"), new_cache


def _whole(z):
    """``z`` (B, T, H*Dh) with its heads whole on every shard: an
    all-gather over the axes that split them (a plain tensor as it is)."""
    return reshard(z, z.dims[:-1] + ((),)) if is_sharded(z) else z


def _advance(token_mask, t, like):
    """How far a window of ``t`` tokens moves each request's length: ``t``,
    or its unmasked tokens."""
    if token_mask is None:
        return torch.full((), t, dtype=torch.int32, device=like.device)
    return token_mask.sum(dim=1, dtype=torch.int32)


def _finish_split(parts, axes, q, params, cfg):
    """The shards' softmax ``parts`` (row maxima, denominators (B, Hq, t,
    1) and numerators (B, Hq, t, Dh)) merged over the KV ``axes``
    (:func:`~repro_torch.model.sharding.combine_partials`; plain tensors
    are only normalised), as (B, t, Hq*Dh) in q's dtype and layout, its
    heads onto the model axis (a split) and through the row-parallel
    ``wo``."""
    out = smap(lambda z: z.to(q.dtype).transpose(1, 2).reshape(z.shape[0], z.shape[2], -1),
               combine_partials(*parts, axes), dims=q.dims if is_sharded(q) else None)
    out = constrain(out, "batch", "seq", "act_heads")
    wo = gather_for_use(params["wo"], ("heads_out", "embed"), cfg.fsdp_gather_weights)
    return constrain(dense(out, wo), "batch", "seq", "act_embed")


def _norms(params, cfg):
    """The qk-norm scales, or (None, None)."""
    if cfg.qk_norm:
        return params["q_norm"]["scale"], params["k_norm"]["scale"]
    return None, None


def _norm_rope(cfg, q, k, qn, kn, pos):
    """q and k (B, H, T, Dh) through the qk-norm (where the config has one)
    and RoPE at ``pos`` (none for ``pos=None``: cross-attention)."""
    if cfg.qk_norm:
        q = rms_norm({"scale": qn}, q, cfg.norm_eps)
        k = rms_norm({"scale": kn}, k, cfg.norm_eps)
    if pos is not None:
        q = apply_rope(q, pos, cfg.rope_theta, cfg.mrope_sections)
        k = apply_rope(k, pos, cfg.rope_theta, cfg.mrope_sections)
    return q, k


def _decode_dense(params, x, cfg, kind, positions, kv_cache: KVCache, token_mask):
    """Self-attention of a decode window against a dense cache, whole or
    split over the KV sequence's mesh axes (module docstring); off a mesh
    every slot is the one shard's."""
    hd = cfg.head_dim
    q, k, v = (_whole(z) for z in _project_qkv(params, x, x, cfg))
    window = cfg.attn_window if kind == "local" else None
    kc = kv_cache
    s_total = kc.k.shape[2]

    def part(cell, ql, kl, vl, pos, qn, kn, k_old, v_old, length, mask):
        b, t = ql.shape[:2]
        if pos is None:
            pos = torch.arange(t, device=ql.device)[None].expand(b, t)
        qh, kh = _norm_rope(cfg, _heads(ql, hd), _heads(kl, hd), qn, kn, pos)
        vh = _heads(vl, hd)
        slot0 = offset(kc.k, 2, cell)
        k_new = _masked_insert(k_old, kh, length, mask, slot0=slot0, s_total=s_total)
        v_new = _masked_insert(v_old, vh, length, mask, slot0=slot0, s_total=s_total)
        parts = _decode_partials(qh, k_new, v_new, length, cfg, window=window, slot0=slot0,
                                 s_total=s_total)
        return (k_new, v_new, length + _advance(mask, t, ql)) + parts

    split = is_sharded(kc.k)
    pd = (x.dims[0], (), (), ()) if split else None
    k_new, v_new, length, *parts = smap(
        part, q, k, v, positions, *_norms(params, cfg), kc.k, kc.v, kc.length, token_mask,
        cell=True, n_out=6,
        dims=[kc.k.dims, kc.v.dims, kc.length.dims, pd, pd, pd] if split else None)
    return (_finish_split(parts, kc.k.dims[2] if split else (), q, params, cfg),
            KVCache(k_new, v_new, length))


def _cross_split_frames(params, x, x_kv, cfg):
    """Cross-attention over frames split over the KV sequence's mesh axes
    (module docstring): q's heads all-gathered, ``wk`` and ``wv`` gathered
    whole, the flash kernel's log-sum-exp instantiation a shard over its
    frames, then the combine."""
    hd, g = cfg.head_dim, cfg.fsdp_gather_weights
    q = constrain(dense(x, gather_for_use(params["wq"], ("embed", "heads_out"), g)),
                  "batch", "seq", "act_heads")
    if cfg.qkv_bias:
        q = smap(torch.add, q, along(params["bq"], q))
    q = _whole(q)
    kv = []
    for w, bias in (("wk", "bk"), ("wv", "bv")):
        z = dense(x_kv, reshard(params[w], ((), ())))
        if cfg.qkv_bias:
            z = smap(torch.add, z, along(params[bias], z))
        kv.append(z)

    def part(ql, kl, vl, qn, kn):
        """Flash's output is normalised against its own log-sum-exp: the
        part (lse, 1, out)."""
        qh, kh = _norm_rope(cfg, _heads(ql, hd), _heads(kl, hd), qn, kn, None)
        o, lse = flash_attention_lse(qh.contiguous(), kh.contiguous(),
                                     _heads(vl, hd).contiguous(), causal=False)
        lse = lse[..., None]
        return lse, torch.ones_like(lse), o.float()

    pd = (x.dims[0], (), (), ())
    parts = smap(part, q, *kv, *_norms(params, cfg), n_out=3, dims=[pd, pd, pd])
    return _finish_split(parts, x_kv.dims[1], q, params, cfg)


def _lengths_2d(length: torch.Tensor, b: int) -> torch.Tensor:
    """Per-request lengths as (B, 1); a scalar broadcasts (lockstep)."""
    return torch.as_tensor(length).reshape(-1, 1).expand(b, 1)


def _masked_insert(cache: torch.Tensor, new: torch.Tensor, length: torch.Tensor,
                   token_mask: torch.Tensor | None = None, *, slot0: int = 0,
                   s_total: int | None = None) -> torch.Tensor:
    """``cache`` with ``new`` (B, H, t, D) written at absolute positions
    length..length+t-1 of each request, ring-aware (slot = position mod S).
    A masked token writes nothing.  Returns a new tensor.  A shard of a
    cache split along its slots holds global slots ``slot0..slot0+s-1`` of
    ``s_total``: it writes the rows that land there, every other slot
    bit-identical."""
    b, _, s, _ = cache.shape
    s_total = s if s_total is None else s_total
    t = new.shape[2]
    if t > s_total:
        raise ValueError(
            f"decode window of {t} tokens exceeds cache size {s_total}; build the "
            f"state with init_decode_state(insert_window >= {t})")
    idx = torch.arange(slot0, slot0 + s, device=cache.device)
    # The window token landing on each slot; t <= S: at most one per slot.
    off = torch.remainder(idx[None, :] - _lengths_2d(length, b), s_total)    # (B, S)
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


def _decode_partials(q, k_cache, v_cache, cur_pos, cfg, *, window=None, slot0: int = 0,
                     s_total: int | None = None):
    """The softmax partial of a window of t >= 1 queries at positions
    cur_pos..cur_pos+t-1 per request (``cur_pos`` (B,) or a scalar, the
    pre-insert length) over cache slots ``slot0..slot0+s-1`` of a ring of
    ``s_total`` (default: the whole cache) that already holds the window.
    Slot i of request b holds absolute position last_b - ((last_b - i) mod
    S) with last_b = cur_pos[b] + t - 1; query j sees the slots at absolute
    positions in [0, cur_pos[b] + j] (and inside the window).  f32 math:
    returns each row's maximum and denominator (B, Hq, t, 1) and its
    numerators (B, Hq, t, Dh) against that maximum (what
    :func:`~repro_torch.model.sharding.combine_partials` merges, or
    normalises)."""
    b, hq, t, hd = q.shape
    nkv = k_cache.shape[1]
    group = hq // nkv
    s = k_cache.shape[2]
    s_total = s if s_total is None else s_total
    qg = q.reshape(b, nkv, group, t, hd)
    logits = torch.einsum("bhgtd,bhsd->bhgts", qg.float(), k_cache.float())
    logits = logits * (1.0 / math.sqrt(hd))
    logits = _softcap(logits, cfg.attn_logit_softcap)

    slot = torch.arange(slot0, slot0 + s, device=q.device)
    cur2 = _lengths_2d(cur_pos, b).to(torch.int64)                    # (B, 1)
    last = cur2 + t - 1
    abs_pos = last - torch.remainder(last - slot[None, :], s_total)   # (B, S)
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
    return m.reshape(b, hq, t, 1), denom.reshape(b, hq, t, 1), out.reshape(b, hq, t, hd)
