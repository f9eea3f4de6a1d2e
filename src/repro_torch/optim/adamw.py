"""AdamW with global-norm clipping and a warmup + cosine schedule
(counterpart of ``repro.optim.adamw``).

The moments are f32 trees shaped like the parameters, and the update runs
in f32 and is cast back to each parameter's dtype.  Where the reference
returns new trees (and its launcher donates the old ones), the port
updates the parameters and moments in place under ``torch.no_grad()``.
Stacked leaves (a leading layer axis) update one layer slice at a time, as
the reference's ``lax.map`` does, so the f32 working set is one layer.

On sharded leaves (:class:`~repro_torch.model.sharding.Sharded`) every
shard updates its own piece; the global norm of the clip sums each
shard's squares (a replicated leaf's divided by its replicas) and
all-reduces the sum over every mesh axis.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.model import sharding as sh
from repro_torch.tree import tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor   # () int32
    mu: Any              # first moment (param tree, f32)
    nu: Any              # second moment (param tree, f32)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def init_state(params) -> AdamWState:
    leaf = tree_leaves(params)[0]

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=leaf.device),
        mu=tree_map(zeros, params),
        nu=tree_map(zeros, params),
    )


def abstract_state(params) -> AdamWState:
    """:func:`init_state` on the meta device: the moments' shapes and
    dtypes (f32, shaped like the parameters), nothing allocated."""

    def meta(p):
        return torch.empty(p.shape, dtype=torch.float32, device="meta")

    return AdamWState(step=torch.empty((), dtype=torch.int32, device="meta"),
                      mu=tree_map(meta, params), nu=tree_map(meta, params))


def state_pspecs(param_specs) -> AdamWState:
    """The moments' partition specs: the parameters' (ZeRO for free, since
    the parameter specs already shard every tensor over the mesh), the
    step replicated."""
    from repro_torch.model.sharding import P

    return AdamWState(step=P(), mu=param_specs, nu=param_specs)


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to ``min_lr_ratio``, in f32."""
    s = torch.as_tensor(step).float()
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((s - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * frac))
    decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.lr * warm * decay


def global_norm(tree):
    leaves = tree_leaves(tree)
    if not sh.is_sharded(leaves[0]):
        return torch.sqrt(sum(g.float().square().sum() for g in leaves))
    first = leaves[0]
    sq = np.empty(first.shards.shape, dtype=object)
    for c in first.cells():
        with sh.cell_scope(c):
            sq[c] = sum(g.shards[c].float().square().sum() / sh.replicas(g) for g in leaves)
    total = sh.Sharded(first.mesh, (), sq, (),
                       tuple(a for a, n in first.mesh.shape.items() if n > 1))
    return sh.smap(torch.sqrt, sh.reshard(total, ()))


def _scalars(cfg, gnorm, step):
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = step + 1
    lr = schedule(cfg, step)
    s = step.float()
    bc1 = 1 - torch.pow(torch.tensor(cfg.b1, device=s.device), s)
    bc2 = 1 - torch.pow(torch.tensor(cfg.b2, device=s.device), s)
    return scale, step, lr, bc1, bc2


@torch.no_grad()
def apply_updates(params, grads, state: AdamWState, cfg: AdamWConfig):
    """One AdamW step in place.  Returns ``(params, state, metrics)``: the
    same parameter tree, updated, the new state (its moments updated in
    place) and ``{"grad_norm", "lr"}`` as 0-d f32 tensors (of the first
    shard, for a sharded tree)."""
    gnorm = global_norm(grads)
    if sh.is_sharded(gnorm):
        return _apply_sharded(params, grads, state, cfg, gnorm)
    scale, step, lr, bc1, bc2 = _scalars(cfg, gnorm, state.step)
    _update_leaves(cfg, zip(tree_leaves(params), tree_leaves(grads),
                            tree_leaves(state.mu), tree_leaves(state.nu)),
                   scale, lr, bc1, bc2)
    return params, AdamWState(step, state.mu, state.nu), {"grad_norm": gnorm, "lr": lr}


def _apply_sharded(params, grads, state, cfg, gnorm):
    step_sh = state.step
    new_step = np.empty(step_sh.shards.shape, dtype=object)
    lr0 = None
    leaves = [tree_leaves(t) for t in (params, grads, state.mu, state.nu)]
    for c in step_sh.cells():
        with sh.cell_scope(c):
            scale, new_step[c], lr, bc1, bc2 = _scalars(cfg, gnorm.shards[c], step_sh.shards[c])
            lr0 = lr if lr0 is None else lr0
            _update_leaves(cfg, ((p.shards[c], g.shards[c], m.shards[c], v.shards[c])
                                 for p, g, m, v in zip(*leaves)), scale, lr, bc1, bc2)
    step = sh.Sharded(step_sh.mesh, step_sh.dims, new_step, step_sh.shape)
    return params, AdamWState(step, state.mu, state.nu), {
        "grad_norm": gnorm.shards.flat[0], "lr": lr0}


def _update_leaves(cfg, leaves, scale, lr, bc1, bc2):
    def upd(p, g, m, v):
        g = g.float() * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g.square())
        p32 = p.float()
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) + cfg.weight_decay * p32
        p.copy_(p32 - lr * delta)

    for p, g, m, v in leaves:
        if p.ndim >= 3 and p.shape[0] > 1:
            for i in range(p.shape[0]):
                upd(p[i], g[i], m[i], v[i])
        else:
            upd(p, g, m, v)
