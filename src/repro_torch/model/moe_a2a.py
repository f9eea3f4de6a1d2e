"""Expert-parallel MoE with an explicit all-to-all exchange (counterpart of
``repro.model.moe_a2a``; ``cfg.moe_impl == "a2a"``).

The gather MoE (:mod:`repro_torch.model.moe`) routes every token of the
call in one place: sharded, that is an all-gather of the token activations
before the expert gather.  Here each shard routes its own tokens and sends
them to their experts' shard in ONE exchange over the ``model`` axis, and
back in one more: point-to-point producer-to-consumer delivery, the
paper's elevator / eLDST discipline at the scale of the mesh::

  per shard:   tokens (n_loc, D) --route--> (E, cap, D)
  all_to_all:  (E, cap, D) -> (E / tp, tp * cap, D)     [model axis]
  expert FFN on the shard's E / tp experts; the inverse all_to_all;
  the local weighted combine.

Per layer each shard sends 2 (tp - 1) / tp of its E * cap * D buffer rows,
where the gather would move every token activation of the call.

Single-controller, as the reference's CPU tests run it (its
``shard_map``): one process holds every shard of a
:class:`repro_torch.launch.mesh.Mesh`, a shard's tokens are a (B / dp,
T / tp) window of the caller's ``x`` moved to its device (in place where
the devices agree), and the exchanges are
:func:`repro_torch.core.device_comm.all_to_all`.  The outputs come back to
``x``'s device.

Semantics kept from the reference:

* ``x`` (B, T, D) splits as ``P(batch, "model", None)``: the batch over
  the rules' ``batch`` axes, the sequence over ``model``;
* each shard routes its own tokens (router replicated, f32, the gather
  path's ``_topk_routing``), with the exchange's own capacity
  ``max(8, int(n_loc * k * cf / E))`` rounded up to 8 (not
  :func:`~repro_torch.model.moe.capacity`'s ``max(1, ...)``): drops are
  per shard, so under pressure they differ from the gather path's by
  design;
* the receive layout is slot = sender * cap + c;
* the fallbacks to :func:`~repro_torch.model.moe.apply_moe`: no mesh or no
  ``model`` axis, a batch that the data extent does not divide, or E or T
  that ``tp`` does not divide.

The combine is the gather path's: no ``bincount``, no host read, no
atomics, each token's rows summed in ascending expert order.  The expert
FFN runs on narrow views of the stacked (E, D, F) weights: no copy where
the shards share a device, and the gradients reach the full stacked
parameters.  On a mesh over several cards each call copies a shard's
experts to its card (``.to``); placing them there once waits for the
port's parameter sharding.
"""

from __future__ import annotations

import torch

from repro_torch.core.device_comm import all_to_all
from repro_torch.model import moe as moe_mod
from repro_torch.model import sharding

__all__ = ["a2a_capacity", "apply_moe_a2a", "apply_moe_sharded"]


def a2a_capacity(n_loc: int, cfg) -> int:
    """Rows per expert buffer of a shard of ``n_loc`` tokens: the
    reference's ``max(8, int(n_loc * k * cf / e))`` rounded up to 8, with
    ``cf = cfg.moe_capacity_factor``."""
    cf = cfg.moe_capacity_factor
    cap = max(8, int(n_loc * cfg.num_experts_per_tok * cf / cfg.num_experts))
    return -(-cap // 8) * 8


def _local_experts(params, j: int, e_loc: int, device):
    """Shard ``j``'s experts: narrow views of the stacked weights (a copy
    only where ``device`` is another card)."""
    return [params[n].narrow(0, j * e_loc, e_loc).to(device)
            for n in ("w_gate", "w_up", "w_down")]


def apply_moe_a2a(params, xs, cfg):
    """The exchange over one row of shards along the model axis.

    ``xs``: the shards' (b_loc, t_loc, D) tokens, in axis order, each on
    its shard's device.  Returns each shard's (b_loc, t_loc, D) outputs on
    its device."""
    tp = len(xs)
    e = cfg.num_experts
    e_loc = e // tp
    b, t, d = xs[0].shape
    n = b * t
    cap = a2a_capacity(n, cfg)
    flats = [x.reshape(n, d) for x in xs]
    local = [moe_mod.dispatch({"router": params["router"].to(xf.device)}, xf, cfg,
                              cap=cap) for xf in flats]
    bufs = [moe_mod.fill(xf, r, e) for xf, r in zip(flats, local)]     # (E, cap, D)
    # Tokens travel to their expert's shard: shard j receives the rows of
    # experts j*e_loc.. from every sender, slot = sender * cap + c.
    recv = all_to_all(bufs, 0, 1)                                      # (e_loc, tp*cap, D)
    ys = [moe_mod.experts(*_local_experts(params, j, e_loc, xe.device), xe, cfg)
          for j, xe in enumerate(recv)]
    back = all_to_all(ys, 1, 0)                                        # (E, cap, D)
    return [moe_mod.combine(ye, r).reshape(b, t, d).to(x.dtype)
            for ye, r, x in zip(back, local, xs)]


def apply_moe_sharded(params, x: torch.Tensor, cfg) -> torch.Tensor:
    """x (B, T, D) -> (B, T, D) through :func:`apply_moe_a2a` on the
    active sharding context's mesh, batch group by batch group; the gather
    path where the reference falls back to it."""
    mesh, rules = sharding._CTX.mesh, sharding._CTX.rules
    if mesh is None or "model" not in mesh.axis_names:
        return moe_mod.apply_moe(params, x, cfg)
    data = rules.get("batch")
    dp = sharding.axes_size(mesh, data)
    tp = mesh.shape["model"]
    b, t, _ = x.shape
    if b % dp or cfg.num_experts % tp or t % tp:
        return moe_mod.apply_moe(params, x, cfg)
    home = x.device
    rows = mesh.device_grid("model", data)
    outs = []
    for row, xb in zip(rows, x.split(b // dp, dim=0)):
        xs = [xt.to(dev) for xt, dev in zip(xb.split(t // tp, dim=1), row)]
        ys = apply_moe_a2a(params, xs, cfg)
        outs.append(torch.cat([y.to(home) for y in ys], dim=1))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)
