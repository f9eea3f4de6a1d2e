"""Elevator node semantics (paper §3, §4.1, §4.3), in PyTorch.

Counterpart of ``repro.core.elevator``.  The elevator node is the hardware
primitive behind ``fromThreadOrConst``: for every thread ``TID`` it delivers
the token produced by thread ``TID - delta``; when the producer falls
outside the thread block or outside the current *transmission window*, the
preconfigured constant ``C`` is delivered instead (paper Fig. 4).

The "thread axis" is a tensor axis: a positive ``delta`` is a shift toward
higher indices with ``const`` injected at the window boundary.  The value is
chosen by ``torch.where`` on the whole tensor, never by multiplying with a
mask, so a constant of ``inf`` (pathfinder) stays ``inf`` and does not turn
into NaN.  Every function here moves values only: results equal the
reference's bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

__all__ = [
    "from_thread_or_const",
    "from_thread_or_const_nd",
    "tag_value",
    "CascadePlan",
    "plan_cascade",
    "cascaded_from_thread_or_const",
    "TOKEN_BUFFER_SIZE",
]

# Paper Table 2 / §4.3: each elevator node carries a 16-entry token buffer.
TOKEN_BUFFER_SIZE = 16


def tag_value(x: torch.Tensor, name: str | None = None) -> torch.Tensor:
    """``tagValue<var>()``: mark the exported version of a variable.  Eager
    PyTorch has no traced versions to name, so this is the identity (kept
    for API fidelity with the paper and the reference)."""
    return x


def _valid(n: int, delta: int, window: int | None, device) -> torch.Tensor:
    """(n,) bool: thread ``tid`` has a producer ``tid - delta`` inside the
    block and inside its transmission window."""
    tid = torch.arange(n, device=device)
    src = tid - delta
    ok = (src >= 0) & (src < n)
    if window is not None:
        ok &= torch.div(tid, window, rounding_mode="floor") == torch.div(
            src, window, rounding_mode="floor")
    return ok


def from_thread_or_const(
    x: torch.Tensor,
    delta: int,
    const,
    *,
    window: int | None = None,
    axis: int = 0,
) -> torch.Tensor:
    """``fromThreadOrConst<var, delta, const[, window]>()`` over one axis.

    out[tid] = x[tid - delta]  if ``tid - delta`` lies in the same
    transmission window (and inside the thread block), else ``const``.
    ``delta`` may be negative (receive from a *higher* TID); ``window``
    partitions the thread axis into consecutive groups of that size, and
    communication never crosses a group boundary (paper §3.2).
    """
    if delta == 0:
        return x
    n = x.shape[axis]
    shifted = torch.roll(x, delta, dims=axis)
    shape = [1] * x.ndim
    shape[axis] = n
    valid = _valid(n, delta, window, x.device).reshape(shape)
    const_t = torch.as_tensor(const, dtype=x.dtype, device=x.device)
    return torch.where(valid, shifted, const_t)


def from_thread_or_const_nd(
    x: torch.Tensor,
    deltas: Sequence[int],
    const,
    *,
    axes: Sequence[int] | None = None,
    windows: Sequence[int | None] | None = None,
) -> torch.Tensor:
    """Multi-dimensional ``fromThreadOrConst`` (2D/3D TID spaces, Table 1).

    ``deltas[i]`` applies along ``axes[i]``.  A token is valid only if the
    source coordinate is in-bounds (and in-window) along *every* axis.
    """
    if axes is None:
        axes = tuple(range(len(deltas)))
    if windows is None:
        windows = (None,) * len(deltas)
    if len(axes) != len(deltas) or len(windows) != len(deltas):
        raise ValueError("deltas/axes/windows length mismatch")

    shifted = x
    valid = torch.ones([1] * x.ndim, dtype=torch.bool, device=x.device)
    for delta, axis, window in zip(deltas, axes, windows):
        if delta == 0:
            continue
        n = x.shape[axis]
        shifted = torch.roll(shifted, delta, dims=axis)
        shape = [1] * x.ndim
        shape[axis] = n
        valid = valid & _valid(n, delta, window, x.device).reshape(shape)
    const_t = torch.as_tensor(const, dtype=x.dtype, device=x.device)
    return torch.where(valid, shifted, const_t)


@dataclasses.dataclass(frozen=True)
class CascadePlan:
    """Compile-time cascade of elevator nodes for a large ΔTID (paper §4.3).

    ``node_deltas`` chains token buffers: Δ=18 with a 16-entry buffer maps
    to two cascaded nodes with Δ=16 and Δ=2 (paper Fig. 10a).  When the
    chain would exceed ``max_nodes``, the value spills to memory (the
    paper's Live Value Cache fallback).
    """

    delta: int
    node_deltas: tuple[int, ...]
    spilled: bool

    @property
    def num_nodes(self) -> int:
        return len(self.node_deltas)


def plan_cascade(
    delta: int,
    *,
    token_buffer: int = TOKEN_BUFFER_SIZE,
    max_nodes: int = 16,
) -> CascadePlan:
    """Plan the elevator cascade for ``delta`` (paper §4.3):
    num_nodes = ceil(|Δ| / token_buffer); spill if it exceeds ``max_nodes``."""
    mag = abs(delta)
    if mag == 0:
        return CascadePlan(delta, (), False)
    sign = 1 if delta > 0 else -1
    n_full, rem = divmod(mag, token_buffer)
    deltas = [token_buffer * sign] * n_full + ([rem * sign] if rem else [])
    if len(deltas) > max_nodes:
        return CascadePlan(delta, (), True)
    return CascadePlan(delta, tuple(deltas), False)


def cascaded_from_thread_or_const(
    x: torch.Tensor,
    delta: int,
    const,
    *,
    window: int | None = None,
    axis: int = 0,
    token_buffer: int = TOKEN_BUFFER_SIZE,
    max_nodes: int = 16,
) -> tuple[torch.Tensor, CascadePlan]:
    """Apply ``from_thread_or_const`` through an explicit cascade.

    Functionally identical to a single shift by ``delta``; structurally it
    mirrors the hardware chaining so the cost model can count nodes and
    spills.  Values shift hop by hop, then the boundary/window mask of the
    *total* delta applies once (a token dying at any hop dies overall).  A
    spilled plan takes the direct shift, the semantic equivalent of staging
    through the Live Value Cache.
    """
    plan = plan_cascade(delta, token_buffer=token_buffer, max_nodes=max_nodes)
    if plan.spilled or not plan.node_deltas:
        return from_thread_or_const(x, delta, const, window=window, axis=axis), plan
    n = x.shape[axis]
    shifted = x
    for d in plan.node_deltas:
        shifted = torch.roll(shifted, d, dims=axis)
    shape = [1] * x.ndim
    shape[axis] = n
    valid = _valid(n, delta, window, x.device).reshape(shape)
    const_t = torch.as_tensor(const, dtype=x.dtype, device=x.device)
    return torch.where(valid, shifted, const_t), plan
