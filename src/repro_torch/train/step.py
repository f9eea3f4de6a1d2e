"""Training step: cross-entropy loss, microbatched gradient accumulation in
f32, optional int8 gradient compression, AdamW (counterpart of
``repro.train.step``).

``make_train_step(cfg, opt_cfg)`` returns ``train_step(state, batch) ->
(state, metrics)``.  The reference scans a jitted body over microbatches
and donates the state; the port loops over microbatches in Python, sums
their grads into f32 buffers, and updates the state's parameters and
moments in place.  ``metrics`` holds 0-d tensors (``loss``,
``grad_norm``, ``lr``) on the parameters' device.

A train state of :class:`~repro_torch.model.sharding.Sharded` leaves
(:func:`shard_train_state`, under ``sharding_context(mesh,
make_rules(mesh, "train"))``) trains sharded: each microbatch of the
global batch is split over the data axis, the loss is the vocab-sharded
cross-entropy (its max and its sums all-reduced over the vocabulary's
shards, the token sum over data), each shard's gradients accumulate in
f32, and once a step the gradients of every leaf replicated over a mesh
axis are all-reduced over it (the data-parallel all-reduce; over the
model axis for a leaf every model shard used, whose shards hold partial
sums).  AdamW then updates every shard in place.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.model import model as M
from repro_torch.model import sharding as sh
from repro_torch.optim import adamw
from repro_torch.optim.compression import (
    ErrorFeedbackState,
    compressed_gradients,
    init_error_feedback,
)
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


class TrainState(NamedTuple):
    params: Any
    opt: adamw.AdamWState
    ef: ErrorFeedbackState | None = None


def init_train_state(cfg, seed: int = 0, *, device=None, compress: bool = False) -> TrainState:
    """Random parameters from ``seed`` on ``device`` (``None``: the card),
    zero f32 moments and, with ``compress``, zero error-feedback
    residuals."""
    params = M.init_params(cfg, seed, device=device)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    return TrainState(
        params=params,
        opt=adamw.init_state(params),
        ef=init_error_feedback(params) if compress else None,
    )


def abstract_train_state(cfg, *, compress: bool = False) -> TrainState:
    """The train state on the meta device (the dry run's): the parameters
    of :func:`~repro_torch.model.model.abstract_params`, requiring grad, f32
    moments and, with ``compress``, f32 residuals; nothing allocated."""
    params = M.abstract_params(cfg)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    ef = None
    if compress:
        ef = ErrorFeedbackState(residual=tree_map(
            lambda p: torch.empty(p.shape, dtype=torch.float32, device="meta"), params))
    return TrainState(params=params, opt=adamw.abstract_state(params), ef=ef)


def train_state_pspecs(cfg, rules) -> TrainState:
    """The train state's partition specs under ``rules``: the parameters'
    (:func:`~repro_torch.model.model.param_pspecs`) and the moments'
    (:func:`~repro_torch.optim.adamw.state_pspecs`), with no
    error-feedback specs, as the reference's."""
    pspecs = M.param_pspecs(cfg, rules)
    return TrainState(params=pspecs, opt=adamw.state_pspecs(pspecs), ef=None)


def shard_train_state(state: TrainState, cfg, mesh, rules) -> TrainState:
    """``state`` split over ``mesh`` by :func:`train_state_pspecs` under
    ``rules``: every parameter shard a leaf that requires grad, the
    moments and the step placed alike (no error-feedback residuals)."""
    if state.ef is not None:
        raise NotImplementedError("gradient compression is not ported to sharded states")
    specs = train_state_pspecs(cfg, rules)
    params = sh.device_put_tree(state.params, specs.params, mesh, requires_grad=True)
    opt = adamw.AdamWState(
        step=sh.device_put(state.opt.step, sh.NamedSharding(mesh, specs.opt.step)),
        mu=sh.device_put_tree(state.opt.mu, specs.opt.mu, mesh, requires_grad=False),
        nu=sh.device_put_tree(state.opt.nu, specs.opt.nu, mesh, requires_grad=False))
    return TrainState(params, opt, None)


def cross_entropy(logits, labels):
    """Mean token cross-entropy in f32.  Sharded logits (split over the
    vocabulary) take the max and the sums over the vocabulary's shards by
    all-reduces and the token sum over the batch's; the result is a
    replicated 0-d :class:`~repro_torch.model.sharding.Sharded`."""
    if sh.is_sharded(logits):
        return _sharded_cross_entropy(logits, labels)
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels[..., None].long())[..., 0].mean()


def _sharded_cross_entropy(logits, labels):
    labels = M._place(labels, "batch", "seq")
    vocab = logits.dims[-1]
    row = logits.dims[:-1] + ((),)
    m = sh.smap(lambda t: t.detach().float().amax(dim=-1, keepdim=True), logits, dims=row)
    m = sh.all_reduce_max(m, vocab)
    s = sh.smap(lambda t, mm: torch.exp(t.float() - mm).sum(dim=-1, keepdim=True),
                logits, m, dims=row)
    s.partial = vocab

    def pick(cell, t, y):
        ids = y.long()[..., None] - sh.offset(logits, -1, cell)
        hit = (ids >= 0) & (ids < t.shape[-1])
        z = torch.gather(t.float(), -1, ids.clamp(0, t.shape[-1] - 1))
        return torch.where(hit, z, torch.zeros((), device=z.device))

    z = sh.smap(pick, logits, labels, cell=True, dims=row)
    z.partial = vocab
    s, z = sh.reshard(s, row), sh.reshard(z, row)
    total = sh.smap(lambda mm, ss, zz: (mm + torch.log(ss) - zz).sum(), m, s, z, dims=())
    total.partial = tuple(a for d in row for a in d)
    n = logits.shape[0] * logits.shape[1]
    return sh.smap(lambda t: t / n, sh.reshard(total, ()))


def _model_kwargs(batch):
    """The forward's extra inputs a batch may carry, as the reference's:
    ``frontend_embeds`` (B, S_f, D), ``positions`` ((B, S), or (3, B, S)
    for M-RoPE) and ``enc_embeds`` (the encoder's frames)."""
    kw = {}
    if "frontend_embeds" in batch:
        kw["frontend_embeds"] = batch["frontend_embeds"]
    if "positions" in batch:
        kw["positions"] = batch["positions"]
    if "enc_embeds" in batch:
        kw["enc_tokens_embeds"] = batch["enc_embeds"]
    return kw


def make_loss_fn(cfg):
    def loss_fn(params, batch):
        logits = M.forward(params, cfg, batch["tokens"], **_model_kwargs(batch))
        return cross_entropy(logits, batch["labels"])

    return loss_fn


def _split_micro(batch, n_micro: int):
    """Each (B, ...) entry as (n_micro, B / n_micro, ...); M-RoPE's (3, B,
    S) ``positions`` split along their batch axis, 1."""
    out = {}
    for k, x in batch.items():
        mrope = k == "positions" and x.ndim == 3 and x.shape[0] == 3
        b = x.shape[1] if mrope else x.shape[0]
        if b % n_micro:
            raise ValueError(f"batch {b} not divisible by microbatch {n_micro}")
        if mrope:
            out[k] = x.reshape(3, n_micro, b // n_micro, x.shape[2]).movedim(1, 0)
        else:
            out[k] = x.reshape((n_micro, b // n_micro) + tuple(x.shape[1:]))
    return out


def make_train_step(cfg, opt_cfg: adamw.AdamWConfig | None = None, *,
                    compress: bool = False, accum_dtype=torch.float32):
    """The train step for ``cfg``: ``cfg.microbatch`` microbatches, their
    grads summed in ``accum_dtype`` and divided by their number.  Every
    arch trains; on the card each gradient runs through the kernels'
    backward (WKV, flash attention, the RG-LRU scan and the token shift)."""
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    loss_fn = make_loss_fn(cfg)
    n_micro = max(1, cfg.microbatch)

    def train_step(state: TrainState, batch) -> tuple[TrainState, dict]:
        params = state.params
        leaves = tree_leaves(params)
        if sh.is_sharded(leaves[0]):
            if compress:
                raise NotImplementedError("gradient compression is not ported to "
                                          "sharded states")
            return _sharded_step(state, batch, loss_fn, n_micro, accum_dtype, opt_cfg)
        if n_micro == 1:
            loss = loss_fn(params, batch)
            grads = list(torch.autograd.grad(loss, leaves))
            loss = loss.detach()
        else:
            micro = _split_micro(batch, n_micro)
            grads = [torch.zeros(p.shape, dtype=accum_dtype, device=p.device)
                     for p in leaves]
            loss = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
            for i in range(n_micro):
                loss_i = loss_fn(params, {k: v[i] for k, v in micro.items()})
                for acc, g in zip(grads, torch.autograd.grad(loss_i, leaves)):
                    acc.add_(g.to(accum_dtype))
                loss += loss_i.detach()
            loss = loss / n_micro
            for g in grads:
                g.div_(n_micro)
        grads = tree_unflatten(params, grads)

        ef = state.ef
        if compress and ef is not None:
            grads, ef = compressed_gradients(grads, ef)
        params, opt, opt_metrics = adamw.apply_updates(params, grads, state.opt, opt_cfg)
        return TrainState(params, opt, ef), {"loss": loss, **opt_metrics}

    return train_step


def sharded_loss_and_grads(params, batch, loss_fn, n_micro: int = 1,
                           accum_dtype=torch.float32):
    """``(loss, grads)`` of sharded ``params`` over ``n_micro`` microbatches
    of ``batch``: the mean loss (a 0-d tensor of the first shard) and a
    tree of :class:`~repro_torch.model.sharding.Sharded` gradients laid
    out as the parameters, each microbatch's summed in ``accum_dtype`` on
    its shard, divided by their number and, for every leaf replicated over
    a mesh axis, all-reduced over it (the data-parallel all-reduce: a
    replicated value's cotangent is held as partial sums on its replicas)."""
    leaves = tree_leaves(params)
    shards = [leaf.shards[c] for leaf in leaves for c in leaf.cells()]
    acc = [torch.zeros(t.shape, dtype=accum_dtype, device=t.device) for t in shards]
    micro = _split_micro(batch, n_micro) if n_micro > 1 else None
    loss = None
    for i in range(n_micro):
        mb = batch if micro is None else {k: v[i] for k, v in micro.items()}
        loss_i = loss_fn(params, mb)
        # Every replica of the loss seeds its 1 / n share: the cotangent of a
        # replicated value is held as partial sums on its replicas, and each
        # shard runs the same backward, as every card of a mesh does.
        seeds = list(loss_i.shards.flat)
        ones = [torch.full_like(t, 1.0 / len(seeds)) for t in seeds]
        grads = torch.autograd.grad(seeds, shards, ones, allow_unused=True)
        for a, g in zip(acc, grads):
            if g is not None:
                a.add_(g.to(accum_dtype))
        part = sh.smap(torch.Tensor.detach, loss_i)
        loss = part if loss is None else loss + part
        del loss_i, seeds, grads
    if n_micro > 1:
        loss = sh.smap(lambda t: t / n_micro, loss)
        for a in acc:
            a.div_(n_micro)
    it = iter(acc)
    grads = []
    for leaf in leaves:
        arr = np.empty(leaf.shards.shape, dtype=object)
        for c in leaf.cells():
            arr[c] = next(it)
        used = {a for d in leaf.dims for a in d}
        g = sh.Sharded(leaf.mesh, leaf.dims, arr, leaf.shape,
                       tuple(a for a, n in leaf.mesh.shape.items() if n > 1 and a not in used))
        grads.append(sh.reshard(g, g.dims) if g.partial else g)
    return loss.shards.flat[0], tree_unflatten(params, grads)


def _sharded_step(state: TrainState, batch, loss_fn, n_micro: int, accum_dtype, opt_cfg):
    loss, grads = sharded_loss_and_grads(state.params, batch, loss_fn, n_micro, accum_dtype)
    params, opt, opt_metrics = adamw.apply_updates(state.params, grads, state.opt, opt_cfg)
    return TrainState(params, opt, state.ef), {"loss": loss, **opt_metrics}


def audit_dispatch_entrypoints(cfg, *, device=None, batch: int | None = None, seq: int = 16):
    """Registration hook for :mod:`repro_torch.analysis.donation`: the train
    step, with a closure that builds a train state of ``cfg`` on ``device``
    (``None``: the card) from seed 0 and a random batch, and runs one
    step.  Its contract: the parameters and the AdamW moments are updated
    in place (:func:`repro_torch.optim.adamw.apply_updates`)."""
    from repro_torch.analysis.donation import DispatchEntry
    from repro_torch.kernels.common import resolve_device
    from repro_torch.model.layers import dtype_of

    def prepare():
        dev = resolve_device(device)
        b = batch if batch is not None else 2 * max(1, cfg.microbatch)
        gen = torch.Generator().manual_seed(0)
        tokens = torch.randint(0, cfg.vocab_size, (b, seq), generator=gen)
        bt = {"tokens": tokens.to(dev), "labels": tokens.roll(-1, 1).to(dev)}
        if cfg.is_enc_dec:
            bt["enc_embeds"] = torch.randn((b, seq, cfg.d_model), generator=gen).to(
                dev, dtype_of(cfg))
        step = make_train_step(cfg)
        held = {"state": init_train_state(cfg, 0, device=dev)}

        def run():
            held["state"] = step(held["state"], bt)[0]

        def tree():
            s = held["state"]
            return {"params": s.params, "mu": s.opt.mu, "nu": s.opt.nu}

        return run, tree

    return [DispatchEntry("train.step", prepare, "src/repro_torch/train/step.py:make_train_step",
                          updated="params and moments")]
