"""Training step: cross-entropy loss, microbatched gradient accumulation in
f32, optional int8 gradient compression, AdamW (counterpart of
``repro.train.step``).

``make_train_step(cfg, opt_cfg)`` returns ``train_step(state, batch) ->
(state, metrics)``.  The reference scans a jitted body over microbatches
and donates the state; the port loops over microbatches in Python, sums
their grads into f32 buffers, and updates the state's parameters and
moments in place.  ``metrics`` holds 0-d tensors (``loss``,
``grad_norm``, ``lr``) on the parameters' device.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.model import model as M
from repro_torch.optim import adamw
from repro_torch.optim.compression import (
    ErrorFeedbackState,
    compressed_gradients,
    init_error_feedback,
)
from repro_torch.tree import tree_leaves, tree_unflatten


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


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels[..., None].long())[..., 0].mean()


def make_loss_fn(cfg):
    def loss_fn(params, batch):
        return cross_entropy(M.forward(params, cfg, batch["tokens"]), batch["labels"])

    return loss_fn


def _split_micro(batch, n_micro: int):
    """Each (B, ...) entry as (n_micro, B / n_micro, ...)."""
    out = {}
    for k, x in batch.items():
        b = x.shape[0]
        if b % n_micro:
            raise ValueError(f"batch {b} not divisible by microbatch {n_micro}")
        out[k] = x.reshape((n_micro, b // n_micro) + tuple(x.shape[1:]))
    return out


#: Layer kinds whose gradients have kernels in the port: the WKV training
#: forward and backward.  The RG-LRU scan, the token shift and flash
#: attention have no backward kernel in the reference to port yet.
TRAINABLE_KINDS = ("rwkv",)


def make_train_step(cfg, opt_cfg: adamw.AdamWConfig | None = None, *,
                    compress: bool = False, accum_dtype=torch.float32):
    """The train step for ``cfg``: ``cfg.microbatch`` microbatches, their
    grads summed in ``accum_dtype`` and divided by their number."""
    missing = sorted(set(cfg.pattern) - set(TRAINABLE_KINDS))
    if missing:
        raise NotImplementedError(
            f"training {cfg.name} is not ported to repro_torch yet: its layer "
            f"kinds {missing} have no backward here, and the reference has no "
            "backward kernel for elevator_scan_pallas or flash_attention_pallas "
            "to port")
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    loss_fn = make_loss_fn(cfg)
    n_micro = max(1, cfg.microbatch)

    def train_step(state: TrainState, batch) -> tuple[TrainState, dict]:
        params = state.params
        leaves = tree_leaves(params)
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
