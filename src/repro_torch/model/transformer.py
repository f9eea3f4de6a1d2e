"""Layer stack: pre-norm blocks over the layer pattern, stored as stacked
periods plus a remainder (counterpart of ``repro.model.transformer``).

The reference scans a jitted period body over the stacked parameters; the
port walks the same ``{"scanned": [...], "remainder": [...]}`` layout in a
Python loop.  Ported kinds: ``rwkv``, ``rec`` (RG-LRU) and the attention
kinds ``attn``/``global`` (no window) and ``local`` (``cfg.attn_window``);
the feed-forward is the dense MLP or, where ``cfg.num_experts`` is set,
the MoE layer (:mod:`repro_torch.model.moe`, or with ``cfg.moe_impl ==
"a2a"`` the expert-parallel :mod:`repro_torch.model.moe_a2a`).  A block built with
``cross`` (the encoder-decoder arch's decoder) runs cross-attention over
the encoder's output between its self-attention and its feed-forward.

Under autograd, ``cfg.remat == "full"`` (the reference's default,
``jax.checkpoint`` with nothing saveable) wraps each period in
``torch.utils.checkpoint``: a period keeps only its input, and its forward
runs again in the backward (the remainder layers, as in the reference,
are not recomputed), under the sharding rules its forward ran under.
``"dots"`` (the reference's ``checkpoint_dots_with_no_batch_dims``) is the
same checkpoint with a selective policy: the outputs of the matrix products
with no batch dims (``aten.mm``, ``aten.addmm``: the projections) are saved
and everything else, batched products (``bmm``) included, is recomputed.
``"none"`` keeps every activation.  Without grad (serving) the stack runs
plain.
"""

from __future__ import annotations

import contextlib
from typing import Any

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.model import attention as attn_mod
from repro_torch.model import moe as moe_mod
from repro_torch.model import moe_a2a
from repro_torch.model import recurrent as rec_mod
from repro_torch.model.layers import apply_mlp, init_mlp, init_rmsnorm, rms_norm
from repro_torch.model.sharding import remat_context

ATTN_KINDS = ("attn", "local", "global")


def check_kind(kind: str):
    if kind not in ATTN_KINDS + ("rec", "rwkv"):
        raise NotImplementedError(
            f"layer kind {kind!r} is not ported to repro_torch yet")


def init_block(mk, cfg, kind: str, name: str, *, cross: bool = False):
    check_kind(kind)
    p: dict[str, Any] = {"ln1": init_rmsnorm(mk, cfg.d_model, f"{name}.ln1"),
                         "ln2": init_rmsnorm(mk, cfg.d_model, f"{name}.ln2")}
    if kind in ATTN_KINDS:
        p["attn"] = attn_mod.init_attention(mk, cfg, f"{name}.attn")
    elif kind == "rec":
        p["rec"] = rec_mod.init_rglru_block(mk, cfg, f"{name}.rec")
    else:
        p["rwkv"] = rec_mod.init_rwkv_block(mk, cfg, f"{name}.rwkv")
    if cross:
        p["ln_cross"] = init_rmsnorm(mk, cfg.d_model, f"{name}.ln_cross")
        p["cross"] = attn_mod.init_attention(mk, cfg, f"{name}.cross", cross=True)
    if cfg.num_experts:
        p["ffn"] = moe_mod.init_moe(mk, cfg, f"{name}.moe")
    else:
        p["ffn"] = init_mlp(mk, cfg, f"{name}.mlp")
    return p


def apply_ffn(params, h, cfg):
    """The block's feed-forward: the MoE layer where ``cfg.num_experts``
    is set, else the dense MLP."""
    if not cfg.num_experts:
        return apply_mlp(params, h, cfg)
    if cfg.moe_impl == "a2a":
        return moe_a2a.apply_moe_sharded(params, h, cfg)
    return moe_mod.apply_moe(params, h, cfg)


def apply_block(params, x, cfg, kind: str, *, positions=None, causal=True,
                state=None, enc_out=None, token_mask=None):
    """Pre-norm block.  Returns (x, new_state_or_None).  ``token_mask``
    (B, t) bool (stateful calls): masked tokens leave every state leaf
    untouched.  ``causal=False`` is the encoder's self-attention;
    ``enc_out`` (B, S, D) feeds a block's cross-attention, which runs only
    where both it and the block's ``"cross"`` params are there."""
    check_kind(kind)
    h = rms_norm(params["ln1"], x, cfg.norm_eps)
    if kind in ATTN_KINDS:
        out, new_state = attn_mod.apply_attention(
            params["attn"], h, cfg, kind=kind, positions=positions,
            causal=causal, kv_cache=state, token_mask=token_mask)
    elif kind == "rec":
        out, new_state = rec_mod.apply_rglru_block(
            params["rec"], h, cfg, state=state, token_mask=token_mask)
    else:
        out, new_state = rec_mod.apply_rwkv_block(
            params["rwkv"], h, cfg, state=state, token_mask=token_mask)
    x = x + out
    if enc_out is not None and "cross" in params:
        h = rms_norm(params["ln_cross"], x, cfg.norm_eps)
        out, _ = attn_mod.apply_attention(params["cross"], h, cfg, x_kv=enc_out)
        x = x + out
    h = rms_norm(params["ln2"], x, cfg.norm_eps)
    return x + apply_ffn(params["ffn"], h, cfg), new_state


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
    return torch.is_grad_enabled() and cfg.remat != "none"


#: The products whose outputs ``remat="dots"`` saves: those with no batch
#: dims, as the reference's ``checkpoint_dots_with_no_batch_dims``.
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


@contextlib.contextmanager
def _entered(*managers):
    with contextlib.ExitStack() as stack:
        for m in managers:
            stack.enter_context(m)
        yield


def _dots_context():
    """``context_fn`` of ``remat="dots"``: the selective policy's two
    contexts, each entered with :func:`remat_context`'s."""
    sel_fwd, sel_re = create_selective_checkpoint_contexts(_save_dots)
    fwd, re = remat_context()
    return _entered(sel_fwd, fwd), _entered(sel_re, re)


def _context_fn(cfg):
    return _dots_context if cfg.remat == "dots" else remat_context


def _layer_view(node, p: int):
    """Period ``p`` of a stacked state node, as views of its tensors."""
    if isinstance(node, attn_mod.PagedKVCache):
        return node.layer(p)
    return type(node)(*(leaf[p] for leaf in node))


def _write_back(node, new):
    """Copy a layer's new state into its node of the decode state, leaf by
    leaf, in place.  A paged node's pools were written in place and its
    table is unchanged: only its lengths are copied."""
    if isinstance(node, attn_mod.PagedKVCache):
        node.length.copy_(new.length)
        return
    for dst, src in zip(node, new):
        dst.copy_(src)


def apply_stack(stack_params, x, cfg, *, positions=None, causal=True, states=None,
                enc_out=None, num_layers=None, token_mask=None):
    """Apply the stacked periods, then the remainder.  Returns
    ``(x, states)``.  With ``states`` each layer's new state (a
    ``RecState``, ``KVCache`` or ``PagedKVCache``) is written into it in
    place (the reference donates the state to its jit), and the same tree
    is returned; without, ``(x, None)``.  ``causal`` and ``enc_out`` go to
    every block (:func:`apply_block`); ``num_layers`` is the stack's depth
    where it is not ``cfg.num_layers`` (the encoder's)."""
    pattern, n_periods, remainder = plan_groups(cfg, num_layers)
    periods = [_unstack(tree, n_periods) for tree in stack_params["scanned"] or []]
    block = dict(positions=positions, causal=causal, enc_out=enc_out)
    if states is None and _remat(cfg):
        def period(x, p):
            for j, kind in enumerate(pattern):
                x, _ = apply_block(periods[j][p], x, cfg, kind, **block)
            return x

        for p in range(n_periods):
            x = checkpoint(period, x, p, use_reentrant=False,
                           context_fn=_context_fn(cfg))
        # The reference remats the scanned periods only.
        for i, kind in enumerate(remainder):
            x, _ = apply_block(stack_params["remainder"][i], x, cfg, kind, **block)
        return x, None
    for p in range(n_periods):
        for j, kind in enumerate(pattern):
            st = None
            if states is not None:
                st = _layer_view(states["scanned"][j], p)
            x, ns = apply_block(periods[j][p], x, cfg, kind, state=st,
                                token_mask=token_mask, **block)
            if st is not None:
                _write_back(st, ns)
    for i, kind in enumerate(remainder):
        st = states["remainder"][i] if states is not None else None
        x, ns = apply_block(stack_params["remainder"][i], x, cfg, kind, state=st,
                            token_mask=token_mask, **block)
        if st is not None:
            _write_back(st, ns)
    return x, states
