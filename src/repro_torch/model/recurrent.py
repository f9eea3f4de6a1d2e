"""Recurrent blocks: RG-LRU (RecurrentGemma / Griffin) and RWKV6 (Finch),
the port's counterparts of ``repro.model.recurrent``.

Both hand a state from token to token (the paper's Δ=1 elevator hand-off).
RG-LRU: the width-4 temporal conv is the token-shift kernel
(:mod:`repro_torch.kernels.token_shift`) and the recurrence
``h[t] = a[t] h[t-1] + b[t]`` is the elevator scan
(:mod:`repro_torch.kernels.elevator_scan`): the chunked kernel for a
cache-free forward or a prefill window of more than 64 tokens, the decode
window kernel for every shorter stateful window.  RWKV6: the token shift
(``_rwkv_mix``) is the Δ=1 hand-off of the previous token, and the WKV
state (Dh × Dh per head) is carried by the WKV kernels
(:mod:`repro_torch.kernels.wkv`).  Under sequence-parallel rules
(``prefill_seq``, :mod:`repro_torch.model.sharding`) the RWKV block's WKV
runs sharded over the sequence (:mod:`repro_torch.kernels.wkv.seqpar`).

On a (data, model) mesh (cache-free train and prefill rules) both blocks
run as the reference's ``gather_for_use`` / ``constrain`` place them
(``recurrent.py:83-133, 199-291``): RWKV's ``w_r``, ``w_k``, ``w_v`` and
``w_g`` column-parallel over ``heads_out``, the WKV kernels once a shard
on its heads (heads are independent: no WKV state crosses shards), the
output norm's sum of squares all-reduced over the heads' shards, and
``w_o`` row-parallel; its token-shift weights ``mu`` are all-gathered,
and the decay LoRA's first matrix (replicated over the model axis) and
second (column-parallel) take no ``gather_for_use``, as in the reference.
The RG-LRU's ``w_y`` and ``w_x`` are column-parallel over ``rnn``, the
token shift and the scan run once a shard on its ``rnn`` channels, the
gates gather the conv output over the model axis to contract against
their (``embed``, ``rnn``) weights, and ``w_out`` is row-parallel.  Heads
that do not divide the model axis (RWKV's 2 reduced heads over 4) are
all-gathered and every shard runs every head, then keeps its slice.

Stateful calls (the decode rules) run the same layout on states in their
spec layout (``repro.model.model.decode_state_pspecs``): ``h`` split by
batch and whole over the model axis, the conv tail (RG-LRU's last taps,
RWKV's previous token) with its channels over ``rnn``.  Each shard runs
the decode window (WKV, or the elevator window and the token shift) on
its own heads or channels from its slice of ``h``; the new ``h`` is
all-gathered over the model axis back into its layout (none where every
shard ran every head).  RWKV's previous token is all-gathered over the
model axis for the token shift and its new value split back (no bytes);
RG-LRU's conv tail is already split as the channels it extends.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.elevator_scan.ops import elevator_scan
from repro_torch.kernels.token_shift.ops import token_shift
from repro_torch.kernels.wkv.ops import wkv_fused
from repro_torch.kernels.wkv.seqpar import wkv_seqshard
from repro_torch.model.layers import init_rmsnorm, rms_norm
from repro_torch.model.sharding import (
    along,
    axes_size,
    constrain,
    dense,
    gather_for_use,
    is_sharded,
    offset,
    reshard,
    seq_shard_info,
    smap,
)

_RGLRU_C = 8.0  # Griffin's fixed recurrence-sharpness constant


class RecState(NamedTuple):
    """Decode-time state for one recurrent layer."""

    h: torch.Tensor        # RG-LRU hidden (B, d_rnn) | RWKV S (B, H, dk, dv), f32
    conv: torch.Tensor     # conv tail (B, width-1, d_rnn) | x_prev (B, 1, D)


# ==========================================================================
# RG-LRU (RecurrentGemma)
# ==========================================================================

def init_rglru_block(mk, cfg, name: str):
    d, dr, w = cfg.d_model, cfg.d_rnn, cfg.conv_width
    return {
        "w_y": mk(f"{name}.w_y", (d, dr), ("embed", "rnn")),
        "w_x": mk(f"{name}.w_x", (d, dr), ("embed", "rnn")),
        "conv_w": mk(f"{name}.conv_w", (w, dr), ("taps", "rnn"), "normal", 0.1),
        "gate_a": mk(f"{name}.gate_a", (dr, dr), ("embed", "rnn")),
        "gate_x": mk(f"{name}.gate_x", (dr, dr), ("embed", "rnn")),
        "log_lambda": mk(f"{name}.log_lambda", (dr,), ("rnn",), "normal", 0.5),
        "w_out": mk(f"{name}.w_out", (dr, d), ("rnn", "embed")),
    }


def _rglru_gates(pre_a, pre_x, log_lambda, xb):
    """The recurrence's (a, b) from the gates' pre-activations."""
    r = torch.sigmoid(pre_a)
    i = torch.sigmoid(pre_x)
    log_a = -_RGLRU_C * F.softplus(log_lambda) * r
    a = torch.exp(log_a)
    # sqrt(1 - a^2) keeps the state's variance bounded.
    b = torch.sqrt(torch.clamp_min(1.0 - a.square(), 1e-6)) * (i * xb)
    return a, b


def apply_rglru_block(params, x: torch.Tensor, cfg, *,
                      state: RecState | None = None,
                      token_mask: torch.Tensor | None = None):
    """x: (B, T, D) -> ((B, T, D), new_state_or_None).

    ``token_mask`` (B, T) bool (stateful calls): masked tokens are state
    no-ops, the recurrence sees (a=1, b=0) there, so ``h`` carries through,
    and the conv tail is taken at each row's last valid tokens.  Must be a
    prefix mask per row.
    """
    g = is_sharded(x) and cfg.fsdp_gather_weights      # a mesh's option only

    def proj(z, name):
        w = gather_for_use(params[name], ("embed", "rnn"), g)
        return constrain(dense(z, w), "batch", "seq", "rnn")

    y = smap(lambda t: F.gelu(t, approximate="tanh"), proj(x, "w_y"))   # gate branch
    xb = proj(x, "w_x")                                                 # recurrent branch

    # Temporal conv (width 4): the token-shift elevator chain.
    if state is not None:
        ext = smap(lambda c, t: torch.cat([c.to(t.dtype), t], dim=1), state.conv, xb)
        xb_conv = smap(lambda e, w: token_shift(e, w)[:, state.conv.shape[1]:], ext,
                       along(params["conv_w"], xb))
    else:
        xb_conv = smap(token_shift, xb, along(params["conv_w"], xb))

    def scan(cell, xl, pa, px, lam, yl, h0, mask):
        a, bb = _rglru_gates(pa, px, lam, xl)
        a32, b32 = a.float(), bb.float()
        if mask is not None and state is not None:
            # Masked tokens are identity steps: h passes through, so h[:, -1]
            # is each request's state at its last valid token.
            m = mask[:, :, None]
            a32 = torch.where(m, a32, torch.ones((), device=xl.device))
            b32 = torch.where(m, b32, torch.zeros((), device=xl.device))
        if h0 is not None:              # this shard's channels of the state
            h0 = h0.float().narrow(-1, offset(xb, 2, cell), xl.shape[-1]).contiguous()
        h32 = elevator_scan(a32.contiguous(), b32.contiguous(), h0,
                            decode=state is not None)
        # The state is read off the f32 scan output, not the model-dtype
        # cast: a frozen slot round-trips bit for bit even in bf16.
        return h32.to(xl.dtype) * yl, h32[:, -1]

    hy, h_last = smap(scan, xb_conv, proj(xb_conv, "gate_a"), proj(xb_conv, "gate_x"),
                      along(params["log_lambda"], xb), y,
                      state.h if state is not None else None, token_mask, cell=True,
                      n_out=2, dims=None if not is_sharded(xb) else
                      [xb.dims, (xb.dims[0], xb.dims[2])])

    new_state = None
    if state is not None:
        width = cfg.conv_width - 1

        def tail(e, mask):
            if mask is None:
                return e[:, e.shape[1] - width:]
            # Rows count..count+width-1 of [old tail | window]: an all-False
            # row keeps the old tail.
            counts = mask.sum(dim=1)
            idx = counts[:, None] + torch.arange(width, device=e.device)[None]
            return torch.gather(e, 1, idx[:, :, None].expand(e.shape[0], width, e.shape[2]))

        conv_tail = smap(tail, ext, token_mask)
        if is_sharded(h_last):          # h whole over the model axis again
            h_last = reshard(h_last, state.h.dims)
        new_state = RecState(h=h_last, conv=conv_tail)
    out = dense(hy, gather_for_use(params["w_out"], ("rnn", "embed"), g))
    return constrain(out, "batch", "seq", "act_embed"), new_state


# ==========================================================================
# RWKV6 (Finch)
# ==========================================================================

RWKV_HEAD_DIM = 64
#: WKV chunk of the chunked kernel.  The decay clip bounds |log w| by 4, so
#: per-chunk decay ratios stay within e^64, which f32 holds.
WKV_CHUNK = 16


def init_rwkv_block(mk, cfg, name: str):
    d = cfg.d_model
    return {
        "mu": mk(f"{name}.mu", (5, d), ("taps", "embed"), "normal", 0.2),
        "w_r": mk(f"{name}.w_r", (d, d), ("embed", "heads_out")),
        "w_k": mk(f"{name}.w_k", (d, d), ("embed", "heads_out")),
        "w_v": mk(f"{name}.w_v", (d, d), ("embed", "heads_out")),
        "w_g": mk(f"{name}.w_g", (d, d), ("embed", "heads_out")),
        # Data-dependent decay (the Finch signature): base + low-rank delta.
        "w_decay_base": mk(f"{name}.w_decay_base", (d,), ("heads_out",), "normal", 0.5),
        "w_decay_lora_a": mk(f"{name}.w_decay_a", (d, 64), ("embed", None)),
        "w_decay_lora_b": mk(f"{name}.w_decay_b", (64, d), (None, "heads_out")),
        "u_bonus": mk(f"{name}.u_bonus", (d,), ("heads_out",), "normal", 0.3),
        "w_o": mk(f"{name}.w_o", (d, d), ("heads_out", "embed")),
        "out_norm": init_rmsnorm(mk, d, f"{name}.out_norm"),
    }


def _seq_plan(b: int, t: int):
    """(mesh, seq_axis, batch_axes) when the active rules shard the
    sequence over one named mesh axis of more than one shard and (B, T)
    split evenly over it; None otherwise (the reference's conditions)."""
    info = seq_shard_info()
    if info is None or t <= 1:
        return None
    mesh, seq_ax, batch_ax = info
    n_seq, n_b = axes_size(mesh, seq_ax), axes_size(mesh, batch_ax)
    if isinstance(seq_ax, str) and n_seq > 1 and t % n_seq == 0 and b % n_b == 0:
        return mesh, seq_ax, batch_ax
    return None


def _rwkv_mix(x, x_prev, mu_row):
    """Token-shift lerp: x + (shift(x) - x) * mu  (Δ=1 hand-off)."""
    shifted = torch.cat([x_prev, x[:, :-1]], dim=1)
    return x + (shifted - x) * mu_row


def apply_rwkv_block(params, x: torch.Tensor, cfg, *,
                     state: RecState | None = None,
                     token_mask: torch.Tensor | None = None):
    """x: (B, T, D) -> ((B, T, D), new_state_or_None).

    ``token_mask`` (B, T) bool (stateful calls): masked tokens are state
    no-ops — the WKV recurrence sees (w=1, k=0) there, so S carries through
    unchanged, and the token-shift state is taken at each row's last valid
    token.  Must be a prefix mask per row.
    """
    gg = is_sharded(x) and cfg.fsdp_gather_weights     # a mesh's option only
    d, dh = x.shape[-1], RWKV_HEAD_DIM
    x_prev = None
    if state is not None:               # the previous token, whole over the model axis
        x_prev = (reshard(state.conv, state.conv.dims[:-1] + ((),))
                  if is_sharded(state.conv) else state.conv)

    def mix(t, mu, prev):
        prev = prev.to(t.dtype) if prev is not None else torch.zeros_like(t[:, :1])
        return tuple(_rwkv_mix(t, prev, mu[i]) for i in range(5))

    xr, xk, xv, xg, xw = smap(mix, x, constrain(params["mu"], None, None), x_prev, n_out=5)

    def proj(z, name):
        w = gather_for_use(params[name], ("embed", "heads_out"), gg)
        return constrain(dense(z, w), "batch", "seq", "act_heads")

    r, k, v = proj(xr, "w_r"), proj(xk, "w_k"), proj(xv, "w_v")
    g = smap(F.silu, proj(xg, "w_g"))
    lora = smap(torch.tanh, constrain(dense(xw, params["w_decay_lora_a"]),
                                      "batch", "seq", None))
    delta = constrain(dense(lora, params["w_decay_lora_b"]), "batch", "seq", "act_heads")
    heads_split = not is_sharded(x) or (d // dh) % axes_size(x.mesh, r.dims[-1]) == 0
    if not heads_split:          # heads that do not divide the model axis
        sharded = r.dims
        r, k, v, delta = (reshard(z, z.dims[:-1] + ((),)) for z in (r, k, v, delta))

    def wkv(cell, rl, kl, vl, dl, base, ul, h_state, mask):
        b, t, dl_ = rl.shape
        h = dl_ // dh
        # Data-dependent decay in (0, 1): exp(-exp(...)).  The logit is
        # clamped so |log w| <= 4: the chunked kernel holds per-chunk decay
        # ratios in f32, which stay finite while chunk * |log w| < ~80
        # (WKV_CHUNK -> 64).
        w = torch.exp(-torch.exp((base + dl).float().clamp(-6.0, 1.386)))

        def heads(z):
            return z.reshape(b, t, h, dh).transpose(1, 2).contiguous()  # (B,H,T,Dh)

        # w reaches the kernel in the model dtype (bf16 at full size).
        r_, k_, v_, w_ = heads(rl), heads(kl), heads(vl), heads(w.to(rl.dtype))
        if mask is not None and state is not None:
            # Masked tokens are identity steps for S: decay 1, zero k^T v.
            m = mask[:, None, :, None]                       # (B, 1, T, 1)
            w_ = torch.where(m, w_, torch.ones((), dtype=w_.dtype, device=w_.device))
            k_ = torch.where(m, k_, torch.zeros((), dtype=k_.dtype, device=k_.device))
        u = ul.reshape(h, dh)
        if h_state is not None:         # this shard's heads of the state
            h0 = h_state.float().narrow(1, offset(r, 2, cell) // dh, h).contiguous()
        else:
            h0 = torch.zeros((b, h, dh, dh), dtype=torch.float32, device=rl.device)
        seq_plan = _seq_plan(b, t)
        if seq_plan is not None:
            # Sequence-parallel rules: each shard sweeps its own tokens and
            # only the O(Dh²) (decay, state) summary crosses the seq axis.
            mesh, seq_ax, batch_ax = seq_plan
            out, S = wkv_seqshard(r_, k_, v_, w_, u, h0, mesh=mesh, seq_axis=seq_ax,
                                  batch_axis=batch_ax, chunk=WKV_CHUNK)
        else:
            out, S = wkv_fused(r_, k_, v_, w_, u, h0, chunk=WKV_CHUNK,
                               decode=state is not None, warn_scope=cfg.name)
        return out.transpose(1, 2).reshape(b, t, dl_).to(rl.dtype), S

    out, S = smap(wkv, r, k, v, delta, along(params["w_decay_base"], r),
                  along(params["u_bonus"], r), state.h if state is not None else None,
                  token_mask, cell=True, n_out=2,
                  dims=None if not is_sharded(r) else [r.dims, (r.dims[0], r.dims[2], (), ())])
    out = rms_norm(params["out_norm"], out, cfg.norm_eps)
    if not heads_split:
        out = reshard(out, sharded)
    out = dense(out * g, gather_for_use(params["w_o"], ("heads_out", "embed"), gg))
    out = constrain(out, "batch", "seq", "act_embed")

    new_state = None
    if state is not None:
        def last(t, prev, mask):
            if mask is None:
                return t[:, -1:]
            # Token-shift state = each row's last valid token (row `count`
            # of [x_prev | x]); an all-False row keeps x_prev.
            ext = torch.cat([prev.to(t.dtype), t], dim=1)
            return ext[torch.arange(t.shape[0], device=t.device), mask.sum(dim=1)][:, None]

        conv = smap(last, x, x_prev, token_mask)
        if is_sharded(S):               # back into the state's layout: h whole over
            S = reshard(S, state.h.dims)             # the model axis, the token split
            conv = reshard(conv, state.conv.dims)
        new_state = RecState(h=S, conv=conv)
    return out, new_state
