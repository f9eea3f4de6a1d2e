"""Top-level model: init params, forward, decode state, decode step
(counterpart of ``repro.model.model``; decoder-only text archs built from
the ported layer kinds: RWKV6 and RecurrentGemma).

Parameters are a plain dict with the reference's layout::

    {"tok": {"embedding", "unembed"}, "final_norm": {"scale"},
     "decoder": {"scanned": [block dict with stacked leaves], "remainder": []}}

and the decode state is ``{"scanned": [RecState or KVCache of stacked
leaves], "remainder": [...]}``, so :mod:`repro_torch.model.convert` maps
both frameworks' trees one to one.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels.common import resolve_device
from repro_torch.model import transformer as tf
from repro_torch.model.attention import KVCache
from repro_torch.model.layers import (
    dtype_of,
    embed_tokens,
    init_embeddings,
    init_rmsnorm,
    logits_projection,
    rms_norm,
)
from repro_torch.model.recurrent import RWKV_HEAD_DIM, RecState


# --------------------------------------------------------------------------
# Parameters
# --------------------------------------------------------------------------

def init_mk(gen: torch.Generator, dtype: torch.dtype, device: torch.device):
    """Real-tensor constructor with the reference's distributions
    (``repro.model.sharding.init_mk``): ``normal`` draws N(0, 1) times
    ``scale`` (default ``shape[0] ** -0.5`` for matrices, 0.02 for
    vectors); ``ones`` and ``zeros`` are constant."""

    def mk(name, shape, init="normal", scale=None):
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
    return torch.stack(trees)


def init_params(cfg, seed: int = 0, *, device=None):
    """Random parameters from a seeded ``torch.Generator`` on ``device``
    (``None``: the card).  The reference draws from JAX keys, so the two
    frameworks' numbers differ; tests convert the reference's params
    instead (:func:`repro_torch.model.convert.params_from_jax`)."""
    if cfg.is_enc_dec:
        raise NotImplementedError("enc-dec models are not ported yet")
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    mk = init_mk(gen, dtype_of(cfg), device)
    pattern, n_periods, remainder = tf.plan_groups(cfg)
    periods = [
        [tf.init_block(mk, cfg, kind, f"dec.p{i}.l{j}")
         for j, kind in enumerate(pattern)]
        for i in range(n_periods)
    ]
    scanned = (
        [_stack([per[j] for per in periods]) for j in range(len(pattern))]
        if n_periods else None
    )
    del periods
    rem = [tf.init_block(mk, cfg, kind, f"dec.r{i}")
           for i, kind in enumerate(remainder)]
    return {
        "tok": init_embeddings(mk, cfg),
        "final_norm": init_rmsnorm(mk, cfg.d_model, "final_norm"),
        "decoder": {"scanned": scanned, "remainder": rem},
    }


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------

def _embed(params, cfg, tokens):
    x = embed_tokens(params["tok"], tokens, cfg)
    return x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype, device=x.device)


def forward(params, cfg, tokens: torch.Tensor) -> torch.Tensor:
    """Logits (B, S, V) of a whole sequence from a zero state."""
    x = _embed(params, cfg, tokens)
    x, _ = tf.apply_stack(params["decoder"], x, cfg)
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    return logits_projection(params["tok"], x, cfg)


# --------------------------------------------------------------------------
# Decode state
# --------------------------------------------------------------------------

def _layer_state(cfg, kind: str, batch: int, max_len: int, insert_window: int,
                 lead: tuple, device):
    tf.check_kind(kind)
    dt = dtype_of(cfg)
    if kind in tf.ATTN_KINDS:
        window = cfg.attn_window if kind == "local" else None
        # A local layer keeps a ring of window + insert_window - 1 slots, so
        # a window inserted at once never overwrites a position its earlier
        # queries still attend to; capped at max_len the ring never wraps.
        s = min(max_len, window + insert_window - 1) if window else max_len
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


def init_decode_state(cfg, batch: int, max_len: int, insert_window: int = 1, *,
                      device=None):
    """Zeroed decode state on ``device`` (``None``: the card).
    ``insert_window`` is the widest token window any single ``decode_step``
    call will insert: it sizes the local-attention ring slack.  Recurrent
    states are O(1) in both; their hidden states stay float32 end to end."""
    device = resolve_device(device)
    pattern, n_periods, remainder = tf.plan_groups(cfg)
    scanned = (
        [_layer_state(cfg, k, batch, max_len, insert_window, (n_periods,), device)
         for k in pattern]
        if n_periods else None
    )
    rem = [_layer_state(cfg, k, batch, max_len, insert_window, (), device)
           for k in remainder]
    return {"scanned": scanned, "remainder": rem}


def state_nodes(state):
    """Every node (``RecState`` or ``KVCache``) of a decode state: the
    stacked ones (leaves (L, B, ...)), then the remainder's (leaves
    (B, ...))."""
    return list(state["scanned"] or []) + list(state["remainder"])


def decode_state_finite(state) -> torch.Tensor:
    """(B,) bool: per-slot finiteness of every recurrent state leaf.  KV
    caches are not scanned, as in the reference: a non-finite K/V row
    poisons that slot's logits the step it is attended, which the caller's
    logits check sees."""
    flags = []
    for node in state_nodes(state):
        if isinstance(node, KVCache):
            continue
        stacked = node.conv.ndim - 3           # 1 for (L, B, ...), else 0
        for leaf in (node.h, node.conv):
            fin = torch.isfinite(leaf).movedim(stacked, 0)
            flags.append(fin.reshape(fin.shape[0], -1).all(dim=1))
    return functools.reduce(torch.logical_and, flags)


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
        if kind != "local" or not isinstance(node, KVCache):
            continue
        s_ring = node.k.shape[-2]
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

    Returns (logits (B, K, V) or (B, 1, V), state).
    """
    b, t = tokens.shape
    lengths = torch.as_tensor(lengths)
    if lengths.ndim > 1 or (lengths.ndim == 1 and lengths.shape[0] != b):
        raise ValueError(f"lengths must be a scalar or ({b},), got {tuple(lengths.shape)}")
    if token_mask is not None and token_mask.shape != (b, t):
        raise ValueError(f"token_mask shape {tuple(token_mask.shape)} != {(b, t)}")
    _check_ring_slack(cfg, state, t, max_len)
    positions = (lengths.to(tokens.device).reshape(-1, 1)
                 + torch.arange(t, device=tokens.device)[None]).expand(b, t)
    x = _embed(params, cfg, tokens)
    x, state = tf.apply_stack(params["decoder"], x, cfg, positions=positions,
                              states=state, token_mask=token_mask)
    if last_only:
        if token_mask is None:
            x = x[:, -1:]
        else:
            # Per-row last valid position (clamped: an all-False row yields
            # logits the caller must ignore).
            idx = (token_mask.sum(dim=1) - 1).clamp(0, t - 1)
            x = x[torch.arange(b, device=x.device), idx][:, None]
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    return logits_projection(params["tok"], x, cfg), state
