"""Mixture-of-Experts with sort-based capacity dispatch (counterpart of
``repro.model.moe``).

Tokens are sorted by destination expert and gathered into per-expert
buffers of ``cap`` rows: the point-to-point forwarding of each token to
its consumer.  An assignment past its expert's capacity is dropped (the
residual path carries that token unchanged), as in Switch and DBRX.

The reference's semantics hold exactly:

* the router and its softmax in f32, top-k with the lower expert index
  first on a tie (``jax.lax.top_k``'s order; a stable descending sort
  here, since ``torch.topk`` promises none), then renormalised;
* ``cap = max(1, int(n * k * cf / e))`` rounded up to a multiple of 8,
  where ``n`` is every token of the call (pads and finished slots too);
* the (token, k) assignments stably sorted by expert, each expert keeping
  its first ``cap``.

The combine is deterministic: each token sums its at most k weighted
expert rows in ascending expert order (the order of the reference's
scatter-add), with no atomics, so the same input gives the same bits on
every run.  The expert products are plain batched GEMMs, which the
reference also computes outside any kernel of its own.  DBRX: 16 experts
top-4; Qwen3-MoE: 128 experts top-8 (both fine-grained, no shared expert).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


def init_moe(mk, cfg, name: str):
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {
        "router": mk(f"{name}.router", (d, e)),
        "w_gate": mk(f"{name}.w_gate", (e, d, f)),
        "w_up": mk(f"{name}.w_up", (e, d, f)),
        "w_down": mk(f"{name}.w_down", (e, f, d)),
    }


def _topk_routing(logits: torch.Tensor, k: int):
    """(weights (n, k) f32 renormalised, experts (n, k) int64), the
    largest probability first and, on a tie, the lower expert index."""
    probs = torch.softmax(logits.float(), dim=-1)
    weights, experts = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, experts = weights[:, :k], experts[:, :k]
    return weights / weights.sum(dim=-1, keepdim=True), experts


def capacity(n: int, cfg, capacity_factor: float | None = None) -> int:
    """Rows per expert buffer for ``n`` tokens: the reference's
    ``max(1, int(n * k * cf / e))`` rounded up to a multiple of 8."""
    cf = capacity_factor if capacity_factor is not None else cfg.moe_capacity_factor
    cap = max(1, int(n * cfg.num_experts_per_tok * cf / cfg.num_experts))
    return -(-cap // 8) * 8


class Dispatch(NamedTuple):
    """Where each (token, k) assignment of a call went.

    ``slot`` (n, k): its row of the flattened (E * cap) expert buffers, or
    ``E * cap`` (the spill row) if its expert was full; ``weight`` (n, k)
    f32 its routing weight; ``expert`` (n, k) its expert."""

    slot: torch.Tensor
    weight: torch.Tensor
    expert: torch.Tensor
    cap: int


def dispatch(params, xf: torch.Tensor, cfg, capacity_factor: float | None = None):
    """Route ``xf`` (n, D) and place each assignment in its expert's buffer."""
    n = xf.shape[0]
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    cap = capacity(n, cfg, capacity_factor)
    logits = xf.float() @ params["router"].float()
    weights, experts = _topk_routing(logits, k)                       # (n, k)
    flat_expert = experts.reshape(-1)                                 # (n*k,)
    order = torch.sort(flat_expert, stable=True).indices
    sorted_expert = flat_expert[order]
    # Integer adds are exact in any order; unlike ``bincount`` this sizes
    # its output without reading the largest expert back to the host.
    counts = torch.zeros(e, dtype=torch.int64, device=xf.device).index_add_(
        0, flat_expert, torch.ones_like(flat_expert))
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(n * k, device=xf.device) - starts[sorted_expert]
    sorted_slot = torch.where(pos < cap, sorted_expert * cap + pos, e * cap)
    slot = torch.empty_like(sorted_slot)
    slot[order] = sorted_slot
    return Dispatch(slot.reshape(n, k), weights, experts, cap)


def _act(cfg):
    if cfg.mlp_type == "geglu":
        return lambda g: F.gelu(g, approximate="tanh")
    return F.silu


def apply_moe(params, x: torch.Tensor, cfg, *,
              capacity_factor: float | None = None) -> torch.Tensor:
    """x: (B, T, D) -> (B, T, D).  Capacity-dropped top-k MoE."""
    b, t, d = x.shape
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    n = b * t
    xf = x.reshape(n, d)
    route = dispatch(params, xf, cfg, capacity_factor)
    cap = route.cap
    # The token in each buffer row; n marks an empty row, whose input is 0.
    flat_slot = route.slot.reshape(-1)
    tok = torch.full((e * cap + 1,), n, dtype=torch.int64, device=x.device)
    tok[flat_slot] = torch.arange(n, device=x.device).repeat_interleave(k)
    tok = tok[: e * cap]
    xpad = torch.cat([xf, xf.new_zeros(1, d)])
    xe = xpad[tok].reshape(e, cap, d)

    h = _act(cfg)(torch.bmm(xe, params["w_gate"])) * torch.bmm(xe, params["w_up"])
    ye = torch.bmm(h, params["w_down"]).reshape(e * cap, d)
    # Each assignment's row weighted in f32 (bf16 rows times f32 weights,
    # as the reference promotes), a dropped one's 0; each token sums its
    # rows in ascending expert order.
    rows = torch.cat([ye, ye.new_zeros(1, d)])[route.slot]           # (n, k, D)
    rows = rows * route.weight[..., None]
    rows = torch.where((route.slot < e * cap)[..., None], rows, 0.0)
    by_expert = torch.argsort(route.expert, dim=1)
    rows = torch.gather(rows, 1, by_expert[..., None].expand(n, k, d))
    out = rows[:, 0]
    for j in range(1, k):
        out = out + rows[:, j]
    return out.reshape(b, t, d).to(x.dtype)


def load_balance_loss(router_logits: torch.Tensor, experts: torch.Tensor, e: int):
    """Switch-style auxiliary loss: E * sum(frac_tokens * frac_probs)."""
    probs = torch.softmax(router_logits.float(), dim=-1)
    frac_probs = probs.mean(dim=0)
    frac_tokens = F.one_hot(experts[:, 0].long(), e).float().mean(dim=0)
    return e * torch.sum(frac_tokens * frac_probs)
