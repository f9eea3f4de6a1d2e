"""Top-level model: init params, forward, encode, decode state, decode step
(counterpart of ``repro.model.model``; every arch of the reference: RWKV6,
RecurrentGemma, Gemma3, the dense Qwen2 and Nemotron families, Qwen2-VL's
backbone with its stub frontend, the MoE archs DBRX and Qwen3-MoE, and the
encoder-decoder SeamlessM4T, whose stub audio frontend hands the encoder
precomputed frame embeddings).

Parameters are a plain dict with the reference's layout::

    {"tok": {"embedding", "unembed"}, "final_norm": {"scale"},
     "decoder": {"scanned": [block dict with stacked leaves], "remainder": []}}

(the encoder-decoder arch adds ``"encoder"``, a stack of the same layout,
and ``"enc_final_norm"``, with ``"ln_cross"`` and ``"cross"`` in every
decoder block), and the decode state is ``{"scanned": [RecState, KVCache
or PagedKVCache of stacked leaves], "remainder": [...]}``, so
:mod:`repro_torch.model.convert` maps both frameworks' trees one to one.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels.common import resolve_device
from repro_torch.model import transformer as tf
from repro_torch.model.attention import KVCache, PagedKVCache
from repro_torch.model.layers import (
    dtype_of,
    embed_tokens,
    init_embeddings,
    init_rmsnorm,
    logits_projection,
    rms_norm,
)
from repro_torch.model.recurrent import RWKV_HEAD_DIM, RecState
from repro_torch.model import sharding as sh
from repro_torch.model.sharding import P, PartitionSpec, spec_mk, to_pspec


# --------------------------------------------------------------------------
# Parameters
# --------------------------------------------------------------------------

def init_mk(gen: torch.Generator, dtype: torch.dtype, device: torch.device):
    """Real-tensor constructor with the reference's distributions
    (``repro.model.sharding.init_mk``): ``normal`` draws N(0, 1) times
    ``scale`` (default ``shape[0] ** -0.5`` for matrices, 0.02 for
    vectors); ``ones`` and ``zeros`` are constant.  The meta device draws
    nothing: its constructor is :func:`abstract_mk`."""
    if device.type == "meta":
        raise ValueError("init_mk draws random numbers, which the meta device cannot "
                         "hold: build meta params with abstract_params(cfg)")

    def mk(name, shape, axes, init="normal", scale=None):
        if init == "ones":
            return torch.ones(shape, dtype=dtype, device=device)
        if init == "zeros":
            return torch.zeros(shape, dtype=dtype, device=device)
        if init == "normal":
            s = scale if scale is not None else (
                shape[0] ** -0.5 if len(shape) > 1 else 0.02)
            x = torch.randn(shape, generator=gen, dtype=torch.float32,
                            device=device)
            return (x * s).to(dtype)
        raise ValueError(init)

    return mk


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    if isinstance(trees[0], PartitionSpec):
        return P(None, *trees[0])          # the (unsharded) layer axis
    return torch.stack(trees)


def _init_stack(mk, cfg, *, num_layers=None, cross=False, name="dec"):
    """A layer stack's params: ``{"scanned": [block dict of stacked
    leaves, one a kind of the pattern] or None, "remainder": [block]}``."""
    pattern, n_periods, remainder = tf.plan_groups(cfg, num_layers)
    periods = [
        [tf.init_block(mk, cfg, kind, f"{name}.p{i}.l{j}", cross=cross)
         for j, kind in enumerate(pattern)]
        for i in range(n_periods)
    ]
    scanned = (
        [_stack([per[j] for per in periods]) for j in range(len(pattern))]
        if n_periods else None
    )
    del periods
    rem = [tf.init_block(mk, cfg, kind, f"{name}.r{i}", cross=cross)
           for i, kind in enumerate(remainder)]
    return {"scanned": scanned, "remainder": rem}


def _encoder_cfg(cfg):
    """The encoder's config: attention layers only, no experts."""
    return dataclasses.replace(cfg, pattern=("attn",), num_experts=0)


def abstract_mk(dtype: torch.dtype):
    """Meta-tensor constructor: the shape and dtype of every parameter,
    nothing allocated (``repro.model.sharding.abstract_mk``)."""

    def mk(name, shape, axes, init="normal", scale=None):
        return torch.empty(shape, dtype=dtype, device="meta")

    return mk


def init_params(cfg, seed: int = 0, *, device=None):
    """Random parameters from a seeded ``torch.Generator`` on ``device``
    (``None``: the card).  The reference draws from JAX keys, so the two
    frameworks' numbers differ; tests convert the reference's params
    instead (:func:`repro_torch.model.convert.params_from_jax`).
    ``device="meta"`` gives :func:`abstract_params`."""
    device = resolve_device(device)
    if device.type == "meta":
        return abstract_params(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return _build_params(cfg, init_mk(gen, dtype_of(cfg), device))


def abstract_params(cfg):
    """The parameter tree on the meta device: every leaf's shape and dtype,
    nothing allocated or drawn (the dry run's parameters; the counterpart
    of the reference's ``ShapeDtypeStruct`` tree)."""
    return _build_params(cfg, abstract_mk(dtype_of(cfg)))


def param_pspecs(cfg, rules: dict):
    """The :class:`~repro_torch.model.sharding.PartitionSpec` of every
    parameter under ``rules``: the parameter tree built through
    :func:`~repro_torch.model.sharding.spec_mk` (the reference's
    ``param_pspecs``).  A stacked leaf's layer axis is replicated."""
    return _build_params(cfg, spec_mk(rules))


def _build_params(cfg, mk):
    decoder = _init_stack(mk, cfg, cross=cfg.is_enc_dec)
    p = {
        "tok": init_embeddings(mk, cfg),
        "final_norm": init_rmsnorm(mk, cfg.d_model, "final_norm"),
        "decoder": decoder,
    }
    if cfg.is_enc_dec:
        p["encoder"] = _init_stack(mk, _encoder_cfg(cfg), num_layers=cfg.encoder_layers,
                                   name="enc")
        p["enc_final_norm"] = init_rmsnorm(mk, cfg.d_model, "enc_final_norm")
    return p


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------

def _embed(params, cfg, tokens, frontend_embeds=None):
    x = embed_tokens(params["tok"], tokens, cfg)
    if frontend_embeds is not None:
        # The stub frontend's patch embeddings take the first S_f
        # positions, before the sqrt(d) scale, as in the reference.
        s_f = frontend_embeds.shape[1]
        x = sh.smap(lambda f, e: torch.cat([f.to(e.dtype), e[:, s_f:]], dim=1),
                    frontend_embeds, x)
    return sh.smap(lambda t: t * torch.tensor(cfg.d_model ** 0.5, dtype=t.dtype,
                                              device=t.device), x)


def _place(x, *axes):
    """A plain input split over the active mesh by its logical ``axes``."""
    if x is None or sh.is_sharded(x):
        return x
    mesh = sh.active_mesh()
    return sh.device_put(x, sh.NamedSharding(mesh, to_pspec(axes, sh._CTX.rules)))


def encode(params, cfg, enc_tokens_embeds: torch.Tensor) -> torch.Tensor:
    """The encoder's output ``enc_out`` (B, S, D) of an encoder-decoder
    arch: the frame embeddings (B, S, D), cast to the model's dtype with no
    sqrt(d) scale, through the encoder's layers non-causally (RoPE at
    0..S-1) and its final norm.  What :func:`forward` hands the decoder,
    and what :func:`decode_step` takes as ``enc_out``.  With sharded
    parameters (under a sharding context) the frames are split as
    ``("batch", "seq", "act_embed")`` and ``enc_out`` comes back so."""
    if sh.is_sharded(params["enc_final_norm"]["scale"]):
        enc_tokens_embeds = _place(enc_tokens_embeds, "batch", "seq", "act_embed")
    ex = sh.smap(lambda t: t.to(dtype_of(cfg)), enc_tokens_embeds)
    ex, _ = tf.apply_stack(params["encoder"], ex, _encoder_cfg(cfg), causal=False,
                           num_layers=cfg.encoder_layers)
    return rms_norm(params["enc_final_norm"], ex, cfg.norm_eps)


def _need_mesh():
    if sh.active_mesh() is None:
        raise NotImplementedError(
            "sharded parameters run under a train, prefill, decode or decode_long "
            "sharding context; under prefill_seq the dense layers stay whole (their "
            "sharding there is ROADMAP Queue 1, item 7c)")


def _need_frames(cfg, given, what: str):
    if cfg.is_enc_dec and given is None:
        raise ValueError(f"{cfg.name} is an encoder-decoder arch: {what}")


def forward(params, cfg, tokens: torch.Tensor, *,
            positions: torch.Tensor | None = None,
            frontend_embeds: torch.Tensor | None = None,
            enc_tokens_embeds: torch.Tensor | None = None) -> torch.Tensor:
    """Logits (B, S, V) of a whole sequence from a zero state (the
    decoder's, for an encoder-decoder arch).

    ``positions`` (B, S), or (3, B, S) for M-RoPE (qwen2-vl); ``None`` is
    0..S-1.  ``frontend_embeds`` (B, S_f, D): precomputed patch embeddings
    (the vision frontend is a stub, as in the reference) that replace the
    first S_f embedded tokens.  ``enc_tokens_embeds`` (B, S_enc, D): the
    encoder's frame embeddings, which an encoder-decoder arch needs (see
    :func:`encode`).

    With :class:`~repro_torch.model.sharding.Sharded` parameters (under a
    train or prefill sharding context) the inputs are split over the mesh
    and the logits come back sharded, split over the vocabulary
    (:func:`~repro_torch.model.sharding.to_global` reads them whole)."""
    enc_out = None
    if sh.is_sharded(params["tok"]["embedding"]):
        # The sharded forward (train and prefill rules): logits stay split
        # over the vocabulary.
        _need_mesh()
        tokens = _place(tokens, "batch", "seq")
        if positions is not None:
            positions = _place(positions, *((None,) if positions.ndim == 3 else ()),
                               "batch", "seq")
        frontend_embeds = _place(frontend_embeds, "batch", "seq", "act_embed")
    if cfg.is_enc_dec:
        _need_frames(cfg, enc_tokens_embeds, "forward needs enc_tokens_embeds")
        enc_out = encode(params, cfg, enc_tokens_embeds)
    x = _embed(params, cfg, tokens, frontend_embeds)
    x, _ = tf.apply_stack(params["decoder"], x, cfg, positions=positions,
                          enc_out=enc_out)
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    return logits_projection(params["tok"], x, cfg)


# --------------------------------------------------------------------------
# Decode state
# --------------------------------------------------------------------------

class PageSpec(NamedTuple):
    """Geometry of a paged decode state (see
    :class:`repro_torch.model.attention.PagedKVCache`).

    ``page_size``: tokens per physical page, a multiple of the 32-token
    admission bucket.  ``private_pages``: allocatable pages per KV node
    pool; ``None`` is the dense-equivalent capacity (``batch`` times the
    logical pages of a slot), which can never starve, and every pool is
    capped at that.  ``shared_pages``: read-only pages reserved, in every
    node whose view spans ``max_len``, for prefilled shared prefixes."""

    page_size: int = 32
    private_pages: int | None = None
    shared_pages: int = 0


def _layer_state(cfg, kind: str, batch: int, max_len: int, insert_window: int,
                 lead: tuple, device, paged: PageSpec | None = None):
    tf.check_kind(kind)
    dt = dtype_of(cfg)
    if kind in tf.ATTN_KINDS:
        window = cfg.attn_window if kind == "local" else None
        # A local layer keeps a ring of window + insert_window - 1 slots, so
        # a window inserted at once never overwrites a position its earlier
        # queries still attend to; capped at max_len the ring never wraps.
        s = min(max_len, window + insert_window - 1) if window else max_len
        if paged is not None:
            ps = int(paged.page_size)
            nl = -(-s // ps)                       # logical pages per slot
            cap = batch * nl
            private = cap if paged.private_pages is None else min(int(paged.private_pages), cap)
            # Shared pages exist only where they are immutable: a view that
            # spans every position never wraps, so pages below a slot's
            # start length are never written.
            shared = int(paged.shared_pages) if s == max_len else 0
            pool = lead + (1 + shared + private, ps, cfg.num_kv_heads, cfg.head_dim)
            return PagedKVCache(
                k=torch.zeros(pool, dtype=dt, device=device),
                v=torch.zeros(pool, dtype=dt, device=device),
                page_table=torch.full(lead + (batch, nl), -1, dtype=torch.int32,
                                      device=device),
                length=torch.zeros(lead + (batch,), dtype=torch.int32, device=device),
                s_view=s, page_size=ps)
        kv = lead + (batch, cfg.num_kv_heads, s, cfg.head_dim)
        return KVCache(
            k=torch.zeros(kv, dtype=dt, device=device),
            v=torch.zeros(kv, dtype=dt, device=device),
            length=torch.zeros(lead + (batch,), dtype=torch.int32, device=device),
        )
    if kind == "rec":
        return RecState(
            h=torch.zeros(lead + (batch, cfg.d_rnn), dtype=torch.float32, device=device),
            conv=torch.zeros(lead + (batch, cfg.conv_width - 1, cfg.d_rnn), dtype=dt,
                             device=device),
        )
    h = cfg.d_model // RWKV_HEAD_DIM
    return RecState(
        h=torch.zeros(lead + (batch, h, RWKV_HEAD_DIM, RWKV_HEAD_DIM),
                      dtype=torch.float32, device=device),
        conv=torch.zeros(lead + (batch, 1, cfg.d_model), dtype=dt, device=device),
    )


def init_decode_state(cfg, batch: int, max_len: int, insert_window: int = 1,
                      paged: PageSpec | None = None, *, device=None):
    """Zeroed decode state on ``device`` (``None``: the card).
    ``insert_window`` is the widest token window any single ``decode_step``
    call will insert: it sizes the local-attention ring slack.  Recurrent
    states are O(1) in both; their hidden states stay float32 end to end.

    ``paged`` swaps every KV node for a :class:`PagedKVCache` pool of that
    geometry; page tables start at -1 (nothing mapped)."""
    device = resolve_device(device)
    pattern, n_periods, remainder = tf.plan_groups(cfg)
    scanned = (
        [_layer_state(cfg, k, batch, max_len, insert_window, (n_periods,), device, paged)
         for k in pattern]
        if n_periods else None
    )
    rem = [_layer_state(cfg, k, batch, max_len, insert_window, (), device, paged)
           for k in remainder]
    return {"scanned": scanned, "remainder": rem}


def abstract_decode_state(cfg, batch: int, max_len: int, insert_window: int = 1,
                          paged: PageSpec | None = None):
    """:func:`init_decode_state` on the meta device: the dry run's decode
    state, every leaf's shape and dtype and nothing allocated."""
    return init_decode_state(cfg, batch, max_len, insert_window, paged, device="meta")


def decode_state_pspecs(cfg, batch: int, max_len: int, rules: dict,
                        insert_window: int = 1, paged: PageSpec | None = None):
    """The decode state's partition specs under ``rules`` (the reference's
    ``decode_state_pspecs``), built by walking :func:`abstract_decode_state`
    so that stacked (leading ``layers``) axes come from the leaves' ranks:
    KV caches shard (batch, ., kv_seq, .), recurrent states (batch, ...)
    with the conv tail's channels on ``rnn``; paged pools stay replicated
    (any slot's table may map any page), their tables and lengths shard
    along the batch."""
    return state_pspecs(abstract_decode_state(cfg, batch, max_len, insert_window, paged),
                        rules)


def state_pspecs(state, rules: dict):
    """The partition specs of a decode state's leaves under ``rules``
    (:func:`decode_state_pspecs` of the state it is)."""

    def node_spec(node):
        if isinstance(node, KVCache):
            prefix = ("layers",) * (node.k.ndim - 4)
            kv = to_pspec(prefix + ("batch", None, "kv_seq", None), rules)
            return KVCache(k=kv, v=kv, length=to_pspec(prefix + ("batch",), rules))
        if isinstance(node, PagedKVCache):
            prefix = ("layers",) * (node.k.ndim - 4)
            pool = to_pspec(prefix + (None, None, None, None), rules)
            return PagedKVCache(k=pool, v=pool,
                                page_table=to_pspec(prefix + ("batch", None), rules),
                                length=to_pspec(prefix + ("batch",), rules),
                                s_view=node.s_view, page_size=node.page_size)
        extra = node.conv.ndim - 3
        prefix = ("layers",) * extra
        h_axes = prefix + ("batch",) + (None,) * (node.h.ndim - extra - 1)
        return RecState(h=to_pspec(h_axes, rules),
                        conv=to_pspec(prefix + ("batch", None, "rnn"), rules))

    return {"scanned": None if state["scanned"] is None
            else [node_spec(n) for n in state["scanned"]],
            "remainder": [node_spec(n) for n in state["remainder"]]}


def shard_decode_state(state, mesh, rules: dict):
    """An unsharded decode ``state`` split over ``mesh`` by its specs under
    ``rules`` (:func:`state_pspecs`): each shard a copy of its piece on its
    device, what the sharded :func:`decode_step` updates in place.
    :func:`~repro_torch.model.sharding.to_global` of each leaf gives the
    state back whole.  Every cache's slots must split evenly over the KV
    sequence's axes: a local ring's do for the insert window
    :func:`split_insert_window` gives."""
    return sh.device_put_tree(state, state_pspecs(state, rules), mesh)


def split_insert_window(cfg, k: int, mesh, rules: dict) -> int:
    """The smallest insert window >= ``k`` whose local-attention ring
    (``attn_window + insert_window - 1`` slots) splits evenly over the KV
    sequence's mesh axes under ``rules``: the ``insert_window`` that
    :func:`init_decode_state` takes for a state :func:`shard_decode_state`
    splits (``k`` where the config has no local window, or the rules do
    not split the KV sequence)."""
    n = sh.axes_size(mesh, rules.get("kv_seq"))
    iw = k
    while cfg.attn_window and (cfg.attn_window + iw - 1) % n:
        iw += 1
    return iw


def state_nodes(state):
    """Every node (``RecState``, ``KVCache`` or ``PagedKVCache``) of a
    decode state: the stacked ones (leaves (L, B, ...)), then the
    remainder's (leaves (B, ...))."""
    return list(state["scanned"] or []) + list(state["remainder"])


def decode_state_finite(state) -> torch.Tensor:
    """(B,) bool: per-slot finiteness of every recurrent state leaf.  KV
    caches are not scanned, as in the reference: a non-finite K/V row
    poisons that slot's logits the step it is attended, which the caller's
    logits check sees.  An attention-only state returns all True (B from
    its first cache's ``length``): slot health then rests on the logits
    check alone."""
    flags, first_kv = [], None
    for node in state_nodes(state):
        if isinstance(node, (KVCache, PagedKVCache)):
            first_kv = node.length if first_kv is None else first_kv
            continue
        stacked = node.conv.ndim - 3           # 1 for (L, B, ...), else 0
        for leaf in (node.h, node.conv):
            fin = torch.isfinite(leaf).flatten(stacked + 1).all(-1)
            flags.append(fin.all(0) if stacked else fin)
    if not flags:
        return torch.ones(first_kv.shape[-1], dtype=torch.bool,
                          device=first_kv.device)
    return functools.reduce(torch.logical_and, flags)


_MASK32 = 0xFFFFFFFF


def _checksum_words(leaf: torch.Tensor, batch_axis: int) -> torch.Tensor:
    """Per-slot sum (mod 2**32) of ``leaf``'s raw bit patterns as unsigned
    words: (B,) int64 below 2**32.  The bits are reinterpreted, never
    converted, so the sum is an exact, order-free function of the stored
    bits (the reference's uint32 wraparound sum); int64 holds the unsigned
    words and their partial sums without overflow."""
    size = leaf.element_size()
    if size >= 4:        # 8-byte leaves become pairs of 32-bit words, as in JAX
        words = leaf.contiguous().view(torch.int32).long() & _MASK32
    elif size == 2:
        words = leaf.view(torch.int16).long() & 0xFFFF
    else:
        words = leaf.view(torch.uint8).long()
    dims = [d for d in range(words.ndim) if d != batch_axis]
    return (words.sum(dim=dims) if dims else words) & _MASK32


def _paged_words(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """(B,) sums (mod 2**32) of the words of each slot's mapped pages:
    ``pool`` (P, ps, Hkv, Dh) gathered through ``table`` (B, NL); an
    unmapped entry (-1) adds nothing."""
    per_page = _checksum_words(pool, 0)                                  # (P,)
    got = per_page[table.long().clamp_min(0)]                            # (B, NL)
    return torch.where(table >= 0, got, 0).sum(dim=1) & _MASK32


def decode_state_checksum(state) -> torch.Tensor:
    """(B,) int64 holding each slot's uint32 wraparound checksum of the
    decode state, bit for bit the reference's ``decode_state_checksum``:
    the sum of the raw words of every per-slot leaf, recurrent states (h,
    conv), dense KV caches (contents and lengths) and paged nodes (each
    slot's mapped pages gathered through its table, a shared page in every
    slot that maps it, plus the table and length words).  A flipped bit
    leaves a value finite but always moves its slot's sum."""
    sums = []
    for node in state_nodes(state):
        if isinstance(node, PagedKVCache):
            stacked = node.k.ndim - 4
            for pool in (node.k, node.v):
                if stacked:
                    sums.append(functools.reduce(torch.add, (
                        _paged_words(pool[i], node.page_table[i])
                        for i in range(pool.shape[0]))) & _MASK32)
                else:
                    sums.append(_paged_words(pool, node.page_table))
            sums.append(_checksum_words(node.page_table, node.page_table.ndim - 2))
            sums.append(_checksum_words(node.length, node.length.ndim - 1))
            continue
        if isinstance(node, KVCache):
            ax = node.k.ndim - 4
            leaves = ((node.k, ax), (node.v, ax), (node.length, node.length.ndim - 1))
        else:
            ax = node.conv.ndim - 3
            leaves = ((node.h, ax), (node.conv, ax))
        sums += [_checksum_words(leaf, a) for leaf, a in leaves]
    return functools.reduce(torch.add, sums) & _MASK32


def _check_ring_slack(cfg, state, t: int, max_len: int | None):
    """Raise if a ``t``-token window would wrap a local-attention ring of
    ``state`` onto positions its earlier queries still attend to: the rule
    of the reference's ``analysis.ringslack.ring_slack_violations``.  A ring
    of S slots takes the window iff S >= attn_window + t - 1, or the ring
    is capped at ``max_len`` and never wraps (``max_len=None``: the caller
    does not vouch for the cap)."""
    if t <= 1 or state is None or cfg.attn_window is None:
        return
    pattern, n_periods, remainder = tf.plan_groups(cfg)
    layers = list(zip(pattern, state["scanned"] or [])) if n_periods else []
    layers += list(zip(remainder, state["remainder"]))
    window = cfg.attn_window
    for kind, node in layers:
        if kind != "local" or not isinstance(node, (KVCache, PagedKVCache)):
            continue
        s_ring = node.s_view if isinstance(node, PagedKVCache) else node.k.shape[-2]
        if s_ring >= window + t - 1 or (max_len is not None and s_ring >= max_len):
            continue
        raise ValueError(
            f"decode window of {t} tokens would wrap the local-attention ring "
            f"(cache {tuple(node.k.shape)}, attn_window={window}): earlier "
            f"in-window queries would attend to evicted slots.  Build the state "
            f"with init_decode_state(insert_window >= {t}) (ring >= "
            f"{window + t - 1} slots) or pass max_len= to vouch that the ring "
            f"is capped at the position limit.")


# --------------------------------------------------------------------------
# Decode step
# --------------------------------------------------------------------------

def decode_step(params, cfg, state, tokens: torch.Tensor, lengths, *,
                enc_out: torch.Tensor | None = None,
                last_only: bool = False,
                token_mask: torch.Tensor | None = None,
                max_len: int | None = None):
    """One serve step over a window of tokens (B, K), K >= 1, given states
    filled to ``lengths`` (a scalar, or per request ``(B,)``).

    ``token_mask`` (B, K) bool marks the real tokens and must be a prefix
    per row: masked tokens leave every state untouched, so an all-False row
    keeps a finished or empty slot bit-identical.  ``last_only=True``
    projects logits at each row's last valid position only ((B, 1, V)).

    The state is updated in place and returned — the reference donates it
    to its jit, so no caller may read the old state afterwards either.
    ``lengths`` places the window's tokens for attention layers (RoPE
    positions, ring slots).  The state must have been built with
    ``init_decode_state(insert_window >= K)``; a local-attention ring
    without that slack raises (pass ``max_len``, the position cap the state
    was built with, to allow rings capped at it).

    ``enc_out`` (B, S, D), from :func:`encode`, is the memory every decoder
    block of an encoder-decoder arch cross-attends to; such an arch
    refuses a call without it, where the reference would silently skip
    its cross-attention.

    With :class:`~repro_torch.model.sharding.Sharded` parameters and a
    state split by :func:`shard_decode_state`, under a ``decode`` or
    ``decode_long`` sharding context, the step runs sharded and the logits
    come back split over the vocabulary.

    Returns (logits (B, K, V) or (B, 1, V), state).
    """
    _need_frames(cfg, enc_out, "decode_step needs enc_out (see encode)")
    b, t = tokens.shape
    lengths = torch.as_tensor(lengths)
    if lengths.ndim > 1 or (lengths.ndim == 1 and lengths.shape[0] != b):
        raise ValueError(f"lengths must be a scalar or ({b},), got {tuple(lengths.shape)}")
    if token_mask is not None and token_mask.shape != (b, t):
        raise ValueError(f"token_mask shape {tuple(token_mask.shape)} != {(b, t)}")
    _check_ring_slack(cfg, state, t, max_len)
    positions = (lengths.to(tokens.device).reshape(-1, 1)
                 + torch.arange(t, device=tokens.device)[None]).expand(b, t)
    if sh.is_sharded(params["tok"]["embedding"]):
        # The sharded decode (decode and decode_long rules): the state split
        # by its specs, the tokens, positions and mask by batch, the frames'
        # encoding by (batch, kv_seq); logits split over the vocabulary.
        _need_mesh()
        tokens, positions, token_mask = (_place(z, "batch", None)
                                         for z in (tokens, positions, token_mask))
        enc_out = _place(enc_out, "batch", "kv_seq", "act_embed")
    x = _embed(params, cfg, tokens)
    x, state = tf.apply_stack(params["decoder"], x, cfg, positions=positions,
                              states=state, enc_out=enc_out, token_mask=token_mask)
    if last_only:
        def last(z, mask):
            if mask is None:
                return z[:, -1:]
            # Per-row last valid position (clamped: an all-False row yields
            # logits the caller must ignore).
            idx = (mask.sum(dim=1) - 1).clamp(0, t - 1)
            return z[torch.arange(z.shape[0], device=z.device), idx][:, None]

        x = sh.smap(last, x, token_mask)
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    return logits_projection(params["tok"], x, cfg), state
