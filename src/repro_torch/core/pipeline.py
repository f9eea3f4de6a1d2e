"""Pipeline parallelism as elevator forwarding over the stage axis
(counterpart of ``repro.core.pipeline``).

GPipe-style microbatch pipelining where the stage-to-stage activation
hand-off is a device shift (Δ=+1 over the stage axis), a device-space
elevator node.  Bubble slots are the elevator's boundary constant: stages
with no producer receive zeros, and their outputs never reach the result.
Single-controller, as :mod:`repro_torch.core.device_comm`: the stages are
a list, stage ``i``'s parameters live on stage ``i``'s device.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core import device_comm
from repro_torch.tree import tree_leaves

__all__ = ["pipeline_apply"]


def pipeline_apply(stage_fn: Callable, stage_params, x_micro: torch.Tensor):
    """Run ``stage_fn`` as a ``len(stage_params)``-deep pipeline over
    microbatches.

    Args:
      stage_fn: ``(params, x) -> y``, one pipeline stage (a block of layers).
      stage_params: one parameter tree per stage, each on its stage's
        device (the device of its first leaf).
      x_micro: ``(num_micro, micro_batch, ...)`` microbatched input; stage
        0 injects it.

    Returns the ``(num_micro, micro_batch, ...)`` outputs of the final
    stage, on its device.

    Schedule: ``num_micro + num_stages - 1`` ticks.  At tick ``t`` stage
    ``s`` processes microbatch ``t - s`` (or a bubble), and the activation
    hand-off is one hop per tick: point-to-point, no global barrier, the
    paper's producer/consumer firing rule.
    """
    devices = [tree_leaves(p)[0].device for p in stage_params]
    n_stages, n_micro = len(stage_params), x_micro.shape[0]
    bubble = torch.zeros(x_micro.shape[1:], dtype=x_micro.dtype, device=devices[0])
    incoming = [bubble.to(d) for d in devices]
    outputs = []
    for t in range(n_micro + n_stages - 1):
        # Stage 0 injects microbatch t (a bubble of zeros once the stream ends).
        incoming[0] = x_micro[t].to(devices[0]) if t < n_micro else bubble
        ys = [stage_fn(p, x) for p, x in zip(stage_params, incoming)]
        if t >= n_stages - 1:
            outputs.append(ys[-1])              # the final stage commits
        # Elevator hand-off to the next stage (stage 0 gets the fill).
        incoming = device_comm.device_shift(ys, 1, fill=0.0)
    return torch.stack(outputs)
