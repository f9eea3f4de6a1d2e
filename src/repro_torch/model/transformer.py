"""Layer stack: pre-norm blocks over the layer pattern, stored as stacked
periods plus a remainder (counterpart of ``repro.model.transformer``).

The reference scans a jitted period body over the stacked parameters; the
port walks the same ``{"scanned": [...], "remainder": [...]}`` layout in a
Python loop.  Ported kinds: ``rwkv``, ``rec`` (RG-LRU) and the attention
kinds ``attn``/``global`` (no window) and ``local`` (``cfg.attn_window``).

Under autograd, ``cfg.remat == "full"`` (the reference's default,
``jax.checkpoint`` with nothing saveable) wraps each period in
``torch.utils.checkpoint``: a period keeps only its input, and its forward
runs again in the backward (the remainder layers, as in the reference,
are not recomputed).  ``"none"`` keeps every activation; ``"dots"``
is not ported.  Without grad (serving) the stack runs plain.
"""

from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.model import attention as attn_mod
from repro_torch.model import recurrent as rec_mod
from repro_torch.model.layers import apply_mlp, init_mlp, init_rmsnorm, rms_norm

ATTN_KINDS = ("attn", "local", "global")


def check_kind(kind: str):
    if kind not in ATTN_KINDS + ("rec", "rwkv"):
        raise NotImplementedError(
            f"layer kind {kind!r} is not ported to repro_torch yet")


def init_block(mk, cfg, kind: str, name: str):
    check_kind(kind)
    p: dict[str, Any] = {"ln1": init_rmsnorm(mk, cfg.d_model, f"{name}.ln1"),
                         "ln2": init_rmsnorm(mk, cfg.d_model, f"{name}.ln2")}
    if kind in ATTN_KINDS:
        p["attn"] = attn_mod.init_attention(mk, cfg, f"{name}.attn")
    elif kind == "rec":
        p["rec"] = rec_mod.init_rglru_block(mk, cfg, f"{name}.rec")
    else:
        p["rwkv"] = rec_mod.init_rwkv_block(mk, cfg, f"{name}.rwkv")
    p["ffn"] = init_mlp(mk, cfg, f"{name}.mlp")
    return p


def apply_block(params, x, cfg, kind: str, *, positions=None, state=None,
                token_mask=None):
    """Pre-norm block.  Returns (x, new_state_or_None).  ``token_mask``
    (B, t) bool (stateful calls): masked tokens leave every state leaf
    untouched."""
    check_kind(kind)
    h = rms_norm(params["ln1"], x, cfg.norm_eps)
    if kind in ATTN_KINDS:
        out, new_state = attn_mod.apply_attention(
            params["attn"], h, cfg, kind=kind, positions=positions,
            kv_cache=state, token_mask=token_mask)
    elif kind == "rec":
        out, new_state = rec_mod.apply_rglru_block(
            params["rec"], h, cfg, state=state, token_mask=token_mask)
    else:
        out, new_state = rec_mod.apply_rwkv_block(
            params["rwkv"], h, cfg, state=state, token_mask=token_mask)
    x = x + out
    h = rms_norm(params["ln2"], x, cfg.norm_eps)
    return x + apply_mlp(params["ffn"], h, cfg), new_state


def plan_groups(cfg, num_layers: int | None = None):
    """(pattern, n_periods, remainder_kinds) of the layer stack."""
    pattern = cfg.pattern
    n = num_layers if num_layers is not None else cfg.num_layers
    p = len(pattern)
    n_periods = n // p
    remainder = tuple(pattern[i % p] for i in range(n_periods * p, n))
    return pattern, n_periods, remainder


def _unstack(tree, n: int) -> list:
    """The ``n`` periods of a stacked parameter tree, as views.  One
    ``unbind`` per leaf: under autograd the periods' grads come back as one
    stack per leaf, where indexing each period would add ``n`` zero-padded
    full-size grads per leaf."""
    if isinstance(tree, dict):
        per = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: per[k][i] for k in tree} for i in range(n)]
    return list(tree.unbind(0))


def _remat(cfg) -> bool:
    """Whether to recompute each period in the backward (grad on only)."""
    if cfg.remat not in ("none", "dots", "full"):
        raise ValueError(f"unknown remat policy {cfg.remat!r}")
    if not torch.is_grad_enabled() or cfg.remat == "none":
        return False
    if cfg.remat == "dots":
        raise NotImplementedError(
            'remat="dots" is not ported to repro_torch yet; use "full" or "none"')
    return True


def _write_back(node, new):
    """Copy a layer's new state into its node of the decode state, leaf by
    leaf, in place."""
    for dst, src in zip(node, new):
        dst.copy_(src)


def apply_stack(stack_params, x, cfg, *, positions=None, states=None,
                token_mask=None):
    """Apply the stacked periods, then the remainder.  Returns
    ``(x, states)``.  With ``states`` each layer's new state (a
    ``RecState`` or a ``KVCache``) is written into it in place (the
    reference donates the state to its jit), and the same tree is
    returned; without, ``(x, None)``."""
    pattern, n_periods, remainder = plan_groups(cfg)
    periods = [_unstack(tree, n_periods) for tree in stack_params["scanned"] or []]
    if states is None and _remat(cfg):
        def period(x, p):
            for j, kind in enumerate(pattern):
                x, _ = apply_block(periods[j][p], x, cfg, kind, positions=positions)
            return x

        for p in range(n_periods):
            x = checkpoint(period, x, p, use_reentrant=False)
        # The reference remats the scanned periods only.
        for i, kind in enumerate(remainder):
            x, _ = apply_block(stack_params["remainder"][i], x, cfg, kind,
                               positions=positions)
        return x, None
    for p in range(n_periods):
        for j, kind in enumerate(pattern):
            st = None
            if states is not None:
                node = states["scanned"][j]
                st = type(node)(*(leaf[p] for leaf in node))
            x, ns = apply_block(periods[j][p], x, cfg, kind, positions=positions,
                                state=st, token_mask=token_mask)
            if st is not None:
                _write_back(st, ns)
    for i, kind in enumerate(remainder):
        st = states["remainder"][i] if states is not None else None
        x, ns = apply_block(stack_params["remainder"][i], x, cfg, kind,
                            positions=positions, state=st, token_mask=token_mask)
        if st is not None:
            _write_back(st, ns)
    return x, states
