"""Layer stack: pre-norm blocks over the layer pattern, stored as stacked
periods plus a remainder (counterpart of ``repro.model.transformer``).

The reference scans a jitted period body over the stacked parameters; the
port walks the same ``{"scanned": [...], "remainder": [...]}`` layout in a
Python loop.  Only the ``rwkv`` kind is ported; any other kind raises.
"""

from __future__ import annotations

from typing import Any

from repro_torch.model import recurrent as rec_mod
from repro_torch.model.layers import apply_mlp, init_mlp, init_rmsnorm, rms_norm
from repro_torch.model.recurrent import RecState


def _check_kind(kind: str):
    if kind != "rwkv":
        raise NotImplementedError(
            f"layer kind {kind!r} is not ported to repro_torch yet (rwkv only)")


def init_block(mk, cfg, kind: str, name: str):
    _check_kind(kind)
    p: dict[str, Any] = {"ln1": init_rmsnorm(mk, cfg.d_model, f"{name}.ln1"),
                         "ln2": init_rmsnorm(mk, cfg.d_model, f"{name}.ln2")}
    p["rwkv"] = rec_mod.init_rwkv_block(mk, cfg, f"{name}.rwkv")
    p["ffn"] = init_mlp(mk, cfg, f"{name}.mlp")
    return p


def apply_block(params, x, cfg, kind: str, *, state=None, token_mask=None):
    """Pre-norm block.  Returns (x, new_state_or_None)."""
    _check_kind(kind)
    h = rms_norm(params["ln1"], x, cfg.norm_eps)
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


def _index(tree, i):
    """Period ``i`` of a stacked parameter tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def apply_stack(stack_params, x, cfg, *, states=None, token_mask=None):
    """Apply the stacked periods, then the remainder.  Returns
    ``(x, states)``.  With ``states`` each layer's new state is written
    into it in place (the reference donates the state to its jit), and the
    same tree is returned; without, ``(x, None)``."""
    pattern, n_periods, remainder = plan_groups(cfg)
    for p in range(n_periods):
        for j, kind in enumerate(pattern):
            st = None
            if states is not None:
                node = states["scanned"][j]
                st = RecState(h=node.h[p], conv=node.conv[p])
            x, ns = apply_block(_index(stack_params["scanned"][j], p), x, cfg,
                                kind, state=st, token_mask=token_mask)
            if st is not None:
                st.h.copy_(ns.h)
                st.conv.copy_(ns.conv)
    for i, kind in enumerate(remainder):
        st = states["remainder"][i] if states is not None else None
        x, ns = apply_block(stack_params["remainder"][i], x, cfg, kind,
                            state=st, token_mask=token_mask)
        if st is not None:
            st.h.copy_(ns.h)
            st.conv.copy_(ns.conv)
    return x, states
