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
        "router": mk(f"{name}.router", (d, e), ("embed", "experts")),
        "w_gate": mk(f"{name}.w_gate", (e, d, f), ("experts", "embed", None)),
        "w_up": mk(f"{name}.w_up", (e, d, f), ("experts", "embed", None)),
        "w_down": mk(f"{name}.w_down", (e, f, d), ("experts", None, "embed")),
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


def dispatch(params, xf: torch.Tensor, cfg, capacity_factor: float | None = None,
             *, cap: int | None = None):
    """Route ``xf`` (n, D) and place each assignment in its expert's buffer
    of ``cap`` rows (default :func:`capacity`)."""
    n = xf.shape[0]
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    if cap is None:
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


def fill(xf: torch.Tensor, route: Dispatch, e: int) -> torch.Tensor:
    """The (E, cap, D) expert buffers of ``route``: each row holds its
    assignment's token, in the sorted expert-major order; an empty row
    holds 0."""
    n, d = xf.shape
    k = route.slot.shape[1]
    cap = route.cap
    # The token in each buffer row; n marks an empty row, whose input is 0.
    tok = torch.full((e * cap + 1,), n, dtype=torch.int64, device=xf.device)
    tok[route.slot.reshape(-1)] = torch.arange(n, device=xf.device).repeat_interleave(k)
    xpad = torch.cat([xf, xf.new_zeros(1, d)])
    return xpad[tok[: e * cap]].reshape(e, cap, d)


def experts(w_gate, w_up, w_down, xe: torch.Tensor, cfg) -> torch.Tensor:
    """The expert FFN over buffers ``xe`` (E', C, D) with weights of E'
    experts: (E', C, D)."""
    h = _act(cfg)(torch.bmm(xe, w_gate)) * torch.bmm(xe, w_up)
    return torch.bmm(h, w_down)


def combine(ye: torch.Tensor, route: Dispatch) -> torch.Tensor:
    """(n, D) f32 outputs from the experts' (E, cap, D) rows: each
    assignment's row weighted in f32 (bf16 rows times f32 weights, as the
    reference promotes), a dropped one's 0, and each token sums its rows
    in ascending expert order."""
    e, cap, d = ye.shape
    n, k = route.slot.shape
    ye = ye.reshape(e * cap, d)
    rows = torch.cat([ye, ye.new_zeros(1, d)])[route.slot]           # (n, k, D)
    rows = rows * route.weight[..., None]
    rows = torch.where((route.slot < e * cap)[..., None], rows, 0.0)
    by_expert = torch.argsort(route.expert, dim=1)
    rows = torch.gather(rows, 1, by_expert[..., None].expand(n, k, d))
    out = rows[:, 0]
    for j in range(1, k):
        out = out + rows[:, j]
    return out


def apply_moe(params, x: torch.Tensor, cfg, *,
              capacity_factor: float | None = None) -> torch.Tensor:
    """x: (B, T, D) -> (B, T, D).  Capacity-dropped top-k MoE."""
    b, t, d = x.shape
    xf = x.reshape(b * t, d)
    route = dispatch(params, xf, cfg, capacity_factor)
    xe = fill(xf, route, cfg.num_experts)
    ye = experts(params["w_gate"], params["w_up"], params["w_down"], xe, cfg)
    return combine(ye, route).reshape(b, t, d).to(x.dtype)


def load_balance_loss(router_logits: torch.Tensor, experts: torch.Tensor, e: int):
    """Switch-style auxiliary loss: E * sum(frac_tokens * frac_probs)."""
    probs = torch.softmax(router_logits.float(), dim=-1)
    frac_probs = probs.mean(dim=0)
    frac_tokens = F.one_hot(experts[:, 0].long(), e).float().mean(dim=0)
    return e * torch.sum(frac_tokens * frac_probs)
