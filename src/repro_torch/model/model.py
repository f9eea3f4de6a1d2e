"""Top-level model: init params, forward, decode state, decode step
(counterpart of ``repro.model.model``, RWKV6 family only).

Parameters are a plain dict with the reference's layout::

    {"tok": {"embedding", "unembed"}, "final_norm": {"scale"},
     "decoder": {"scanned": [block dict with stacked leaves], "remainder": []}}

and the decode state is ``{"scanned": [RecState of stacked leaves],
"remainder": [...]}``, so :mod:`repro_torch.model.convert` maps both
frameworks' trees one to one.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels.common import resolve_device
from repro_torch.model import transformer as tf
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
    vectors); ``ones`` is constant."""

    def mk(name, shape, init="normal", scale=None):
        if init == "ones":
            return torch.ones(shape, dtype=dtype, device=device)
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

def _layer_state(cfg, kind: str, batch: int, lead: tuple, device):
    tf._check_kind(kind)
    h = cfg.d_model // RWKV_HEAD_DIM
    return RecState(
        h=torch.zeros(lead + (batch, h, RWKV_HEAD_DIM, RWKV_HEAD_DIM),
                      dtype=torch.float32, device=device),
        conv=torch.zeros(lead + (batch, 1, cfg.d_model), dtype=dtype_of(cfg),
                         device=device),
    )


def init_decode_state(cfg, batch: int, max_len: int, *, device=None):
    """Zeroed decode state on ``device`` (``None``: the card).  The WKV
    state stays (B, H, Dh, Dh) float32 end to end; recurrent states are
    O(1) in ``max_len``, which is kept for the reference's signature."""
    device = resolve_device(device)
    pattern, n_periods, remainder = tf.plan_groups(cfg)
    scanned = (
        [_layer_state(cfg, k, batch, (n_periods,), device) for k in pattern]
        if n_periods else None
    )
    rem = [_layer_state(cfg, k, batch, (), device) for k in remainder]
    return {"scanned": scanned, "remainder": rem}


def state_nodes(state):
    """Every ``RecState`` of a decode state: the stacked ones (leaves
    (L, B, ...)), then the remainder's (leaves (B, ...))."""
    return list(state["scanned"] or []) + list(state["remainder"])


def decode_state_finite(state) -> torch.Tensor:
    """(B,) bool — per-slot finiteness of every recurrent state leaf."""
    flags = []
    for node in state_nodes(state):
        stacked = node.conv.ndim - 3           # 1 for (L, B, ...), else 0
        for leaf in (node.h, node.conv):
            fin = torch.isfinite(leaf).movedim(stacked, 0)
            flags.append(fin.reshape(fin.shape[0], -1).all(dim=1))
    return functools.reduce(torch.logical_and, flags)


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
    ``lengths`` and ``max_len`` place tokens for attention layers; the
    recurrent layers ported so far do not read them.

    Returns (logits (B, K, V) or (B, 1, V), state).
    """
    b, t = tokens.shape
    lengths = torch.as_tensor(lengths)
    if lengths.ndim > 1 or (lengths.ndim == 1 and lengths.shape[0] != b):
        raise ValueError(f"lengths must be a scalar or ({b},), got {tuple(lengths.shape)}")
    if token_mask is not None and token_mask.shape != (b, t):
        raise ValueError(f"token_mask shape {tuple(token_mask.shape)} != {(b, t)}")
    x = _embed(params, cfg, tokens)
    x, state = tf.apply_stack(params["decoder"], x, cfg, states=state,
                              token_mask=token_mask)
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
