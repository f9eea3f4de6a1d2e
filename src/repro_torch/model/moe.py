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
every run.

On a (data, model) mesh (:mod:`repro_torch.model.sharding`) the layer runs
as the reference's GSPMD partitions it (``moe.py:89-111``): the token
activations are all-gathered over data, so every shard routes every
token of the call with the router's logits all-gathered over the experts'
shards, and the capacity counts every token: the dropped (token, k) set
is the unsharded one exactly.  Each model shard fills and runs the
buffers of its own experts (weights all-gathered over data with
``fsdp_gather_weights``; without, each data shard contracts its slice of
``d_model`` and the partial sums are all-reduced), combines their rows
for its own batch rows into partial sums and all-reduces them over the
model axis.  The expert products are plain batched GEMMs, which the
reference also computes outside any kernel of its own.  DBRX: 16 experts
top-4; Qwen3-MoE: 128 experts top-8 (both fine-grained, no shared expert).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.model.sharding import (
    shard_index,
    cell_scope,
    constrain,
    dense,
    gather_for_use,
    is_sharded,
    reshard,
    smap,
)


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
    if cap is None:
        cap = capacity(xf.shape[0], cfg, capacity_factor)
    return place(xf.float() @ params["router"].float(), cfg, cap)


def place(logits: torch.Tensor, cfg, cap: int) -> Dispatch:
    """The :class:`Dispatch` of router ``logits`` (n, E) into buffers of
    ``cap`` rows."""
    n = logits.shape[0]
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    weights, experts = _topk_routing(logits, k)                       # (n, k)
    flat_expert = experts.reshape(-1)                                 # (n*k,)
    order = torch.sort(flat_expert, stable=True).indices
    sorted_expert = flat_expert[order]
    # Integer adds are exact in any order; unlike ``bincount`` this sizes
    # its output without reading the largest expert back to the host.
    counts = torch.zeros(e, dtype=torch.int64, device=logits.device).index_add_(
        0, flat_expert, torch.ones_like(flat_expert))
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(n * k, device=logits.device) - starts[sorted_expert]
    sorted_slot = torch.where(pos < cap, sorted_expert * cap + pos, e * cap)
    slot = torch.empty_like(sorted_slot)
    slot[order] = sorted_slot
    return Dispatch(slot.reshape(n, k), weights, experts, cap)


def _act(cfg):
    if cfg.mlp_type == "geglu":
        return lambda g: F.gelu(g, approximate="tanh")
    return F.silu


def fill(xf: torch.Tensor, route: Dispatch, e: int, lo: int = 0,
         hi: int | None = None) -> torch.Tensor:
    """The (E, cap, D) expert buffers of ``route`` (of experts ``lo`` to
    ``hi`` only, where given): each row holds its assignment's token, in
    the sorted expert-major order; an empty row holds 0."""
    n, d = xf.shape
    k = route.slot.shape[1]
    cap = route.cap
    hi = e if hi is None else hi
    # The token in each buffer row; n marks an empty row, whose input is 0.
    tok = torch.full((e * cap + 1,), n, dtype=torch.int64, device=xf.device)
    tok[route.slot.reshape(-1)] = torch.arange(n, device=xf.device).repeat_interleave(k)
    xpad = torch.cat([xf, xf.new_zeros(1, d)])
    return xpad[tok[lo * cap: hi * cap]].reshape(hi - lo, cap, d)


def experts(w_gate, w_up, w_down, xe: torch.Tensor, cfg) -> torch.Tensor:
    """The expert FFN over buffers ``xe`` (E', C, D) with weights of E'
    experts: (E', C, D)."""
    return torch.bmm(_gated(torch.bmm(xe, w_gate), torch.bmm(xe, w_up), cfg), w_down)


def _gated(gate, up, cfg):
    return _act(cfg)(gate) * up


def combine(ye: torch.Tensor, route: Dispatch, lo: int = 0) -> torch.Tensor:
    """(n, D) f32 outputs from the experts' (E, cap, D) rows: each
    assignment's row weighted in f32 (bf16 rows times f32 weights, as the
    reference promotes), a dropped one's 0, and each token sums its rows
    in ascending expert order.  ``ye`` may hold experts ``lo`` to ``lo +
    E`` only: the others' rows count 0 (a model shard's partial sums)."""
    e, cap, d = ye.shape
    n, k = route.slot.shape
    ye = ye.reshape(e * cap, d)
    slot = route.slot - lo * cap
    mine = (slot >= 0) & (slot < e * cap)
    slot = torch.where(mine, slot, e * cap)
    rows = torch.cat([ye, ye.new_zeros(1, d)])[slot]                  # (n, k, D)
    rows = rows * route.weight[..., None]
    rows = torch.where(mine[..., None], rows, 0.0)
    by_expert = torch.argsort(route.expert, dim=1)
    rows = torch.gather(rows, 1, by_expert[..., None].expand(n, k, d))
    out = rows[:, 0]
    for j in range(1, k):
        out = out + rows[:, j]
    return out


def apply_moe(params, x, cfg, *, capacity_factor: float | None = None):
    """x: (B, T, D) -> (B, T, D).  Capacity-dropped top-k MoE."""
    if is_sharded(x):
        return _moe_sharded(params, x, cfg, capacity_factor)
    b, t, d = x.shape
    xf = x.reshape(b * t, d)
    route = dispatch(params, xf, cfg, capacity_factor)
    xe = fill(xf, route, cfg.num_experts)
    ye = experts(params["w_gate"], params["w_up"], params["w_down"], xe, cfg)
    return combine(ye, route).reshape(b, t, d).to(x.dtype)


def _moe_sharded(params, x, cfg, capacity_factor):
    b, t, d = x.shape
    e, mesh, g = cfg.num_experts, x.mesh, cfg.fsdp_gather_weights
    cap = capacity(b * t, cfg, capacity_factor)
    xf = smap(lambda z: z.reshape(-1, d), reshard(x, ((),) * 3), dims=((), ()))
    router = gather_for_use(params["router"], ("embed", "experts"), g)
    logits = dense(smap(lambda z: z.float(), xf), smap(lambda z: z.float(), router))
    logits = reshard(logits, ((), ()))                 # every expert's logit
    routes = {}
    for c in logits.cells():
        with cell_scope(c):
            routes[c] = place(logits.shards[c], cfg, cap)
    w = {n: gather_for_use(params[n], ax, g) for n, ax in (
        ("w_gate", ("experts", "embed", None)), ("w_up", ("experts", "embed", None)),
        ("w_down", ("experts", None, "embed")))}
    ex, kx = w["w_up"].dims[0], w["w_up"].dims[1]      # kx: d_model's data axes, if kept
    e_loc = w["w_up"].local_shape()[0]

    def buffers(cell, xl):
        lo = shard_index(mesh, cell, ex) * e_loc
        xe = fill(xl, routes[cell], e, lo, lo + e_loc)
        if kx:                                         # this shard's slice of d_model
            m = w["w_up"].local_shape()[1]
            xe = xe.narrow(2, shard_index(mesh, cell, kx) * m, m)
        return xe

    xe = smap(buffers, xf, cell=True, dims=(ex, (), kx))
    pg = smap(torch.bmm, xe, w["w_gate"], dims=(ex, (), ()))
    pu = smap(torch.bmm, xe, w["w_up"], dims=(ex, (), ()))
    pg.partial = pu.partial = kx
    h = smap(lambda a, c: _gated(a, c, cfg), reshard(pg, pg.dims), reshard(pu, pu.dims))
    ye = reshard(smap(torch.bmm, h, w["w_down"], dims=(ex, (), kx)), (ex, (), ()))

    rows = x.local_shape()[0] * t                     # this shard's batch rows, flattened

    def comb(cell, y):
        rt = routes[cell]
        lo = shard_index(mesh, cell, x.dims[0]) * rows
        mine = Dispatch(*(z[lo:lo + rows] for z in rt[:3]), rt.cap)
        out = combine(y, mine, shard_index(mesh, cell, ex) * e_loc)
        return out.reshape(rows // t, t, d)

    out = smap(comb, ye, cell=True, dims=x.dims)
    out.partial = ex
    out = constrain(out, "batch", "seq", "act_embed")
    return smap(lambda z: z.to(x.dtype), out)


def load_balance_loss(router_logits: torch.Tensor, experts: torch.Tensor, e: int):
    """Switch-style auxiliary loss: E * sum(frac_tokens * frac_probs)."""
    probs = torch.softmax(router_logits.float(), dim=-1)
    frac_probs = probs.mean(dim=0)
    frac_tokens = F.one_hot(experts[:, 0].long(), e).float().mean(dim=0)
    return e * torch.sum(frac_tokens * frac_probs)
