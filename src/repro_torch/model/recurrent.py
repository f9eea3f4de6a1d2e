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
from repro_torch.model.sharding import axes_size, seq_shard_info

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


def _rglru_gates(params, xb):
    r = torch.sigmoid(xb @ params["gate_a"])
    i = torch.sigmoid(xb @ params["gate_x"])
    log_a = -_RGLRU_C * F.softplus(params["log_lambda"]) * r
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
    b_, t, _ = x.shape
    y = F.gelu(x @ params["w_y"], approximate="tanh")           # gate branch
    xb = x @ params["w_x"]                                       # recurrent branch

    # Temporal conv (width 4): the token-shift elevator chain.
    if state is not None:
        ext = torch.cat([state.conv.to(xb.dtype), xb], dim=1)
        xb_conv = token_shift(ext, params["conv_w"])[:, state.conv.shape[1]:]
    else:
        xb_conv = token_shift(xb, params["conv_w"])

    a, bb = _rglru_gates(params, xb_conv)
    a32, b32 = a.float(), bb.float()
    if token_mask is not None and state is not None:
        # Masked tokens are identity steps: h passes through, so h[:, -1] is
        # each request's state at its last valid token.
        m = token_mask[:, :, None]
        a32 = torch.where(m, a32, torch.ones((), device=x.device))
        b32 = torch.where(m, b32, torch.zeros((), device=x.device))
    h0 = state.h.float() if state is not None else None
    h32 = elevator_scan(a32.contiguous(), b32.contiguous(), h0,
                        decode=state is not None)
    h = h32.to(x.dtype)

    new_state = None
    if state is not None:
        width = cfg.conv_width - 1
        if token_mask is None:
            conv_tail = ext[:, ext.shape[1] - width:]
        else:
            # Rows count..count+width-1 of [old tail | window]: an all-False
            # row keeps the old tail.
            counts = token_mask.sum(dim=1)
            idx = counts[:, None] + torch.arange(width, device=x.device)[None]
            conv_tail = torch.gather(
                ext, 1, idx[:, :, None].expand(b_, width, ext.shape[2]))
        # The state is read off the f32 scan output, not the model-dtype
        # cast: a frozen slot round-trips bit for bit even in bf16.
        new_state = RecState(h=h32[:, -1], conv=conv_tail)
    out = (h * y) @ params["w_out"]
    return out, new_state


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
    b, t, d = x.shape
    dh = RWKV_HEAD_DIM
    h = d // dh

    x_prev = (
        state.conv.to(x.dtype) if state is not None
        else torch.zeros((b, 1, d), dtype=x.dtype, device=x.device)
    )
    mu = params["mu"]
    xr, xk, xv, xg, xw = (_rwkv_mix(x, x_prev, mu[i]) for i in range(5))

    r = xr @ params["w_r"]
    k = xk @ params["w_k"]
    v = xv @ params["w_v"]
    g = F.silu(xg @ params["w_g"])
    # Data-dependent decay in (0, 1): exp(-exp(...)).  The logit is clamped
    # so |log w| <= 4: the chunked kernel holds per-chunk decay ratios in
    # f32, which stay finite while chunk * |log w| < ~80 (WKV_CHUNK -> 64).
    decay_logit = params["w_decay_base"] + (
        torch.tanh(xw @ params["w_decay_lora_a"]) @ params["w_decay_lora_b"]
    )
    decay_logit = decay_logit.float().clamp(-6.0, 1.386)
    w = torch.exp(-torch.exp(decay_logit))

    def heads(z):
        return z.reshape(b, t, h, dh).transpose(1, 2).contiguous()  # (B,H,T,Dh)

    # w reaches the kernel in the model dtype (bf16 at full size).
    r_, k_, v_, w_ = heads(r), heads(k), heads(v), heads(w.to(x.dtype))
    if token_mask is not None and state is not None:
        # Masked tokens are identity steps for S: decay 1, zero k^T v.
        m = token_mask[:, None, :, None]                 # (B, 1, T, 1)
        w_ = torch.where(m, w_, torch.ones((), dtype=w_.dtype, device=w_.device))
        k_ = torch.where(m, k_, torch.zeros((), dtype=k_.dtype, device=k_.device))
    u = params["u_bonus"].reshape(h, dh)

    h0 = (
        state.h.float() if state is not None
        else torch.zeros((b, h, dh, dh), dtype=torch.float32, device=x.device)
    )
    seq_plan = _seq_plan(b, t)
    if seq_plan is not None:
        # Sequence-parallel rules: each shard sweeps its own tokens and only
        # the O(Dh²) (decay, state) summary crosses the seq axis.
        mesh, seq_ax, batch_ax = seq_plan
        out, S = wkv_seqshard(r_, k_, v_, w_, u, h0, mesh=mesh, seq_axis=seq_ax,
                              batch_axis=batch_ax, chunk=WKV_CHUNK)
    else:
        out, S = wkv_fused(
            r_, k_, v_, w_, u, h0, chunk=WKV_CHUNK, decode=state is not None,
            warn_scope=cfg.name,
        )

    out = out.transpose(1, 2).reshape(b, t, d).to(x.dtype)
    out = rms_norm(params["out_norm"], out, cfg.norm_eps) * g
    out = out @ params["w_o"]

    new_state = None
    if state is not None:
        if token_mask is None:
            conv = x[:, -1:]
        else:
            # Token-shift state = each row's last valid token (row `count`
            # of [x_prev | x]); an all-False row keeps x_prev.
            counts = token_mask.sum(dim=1)
            ext = torch.cat([x_prev, x], dim=1)
            conv = ext[torch.arange(b, device=x.device), counts][:, None]
        new_state = RecState(h=S, conv=conv)
    return out, new_state
