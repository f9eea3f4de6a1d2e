"""Enhanced load/store (eLDST) semantics: ``fromThreadOrMem`` (paper §3.3,
§4.2), in PyTorch.

Counterpart of ``repro.core.eldst``.  ``fromThreadOrMem<delta[, window]>(addr,
predicate)``: a thread whose ``predicate`` is true issues the memory load;
every other thread receives the value *forwarded* from thread ``TID - delta``:

    out[t] = mem[t]            if pred[t]
           = out[t - delta]    otherwise (within the transmission window)
           = const             if no producer exists in the window

Each value is thus loaded once and reused ``window / delta`` times (paper
§4.2).  The recurrence splits into ``delta`` independent fill-forward chains
(positions with equal ``tid mod delta`` inside a window).  The reference
solves each chain with an associative scan of "take the last predicated
value"; here it is index arithmetic: a running maximum (``cummax``) of the
positions where ``pred`` holds, then a gather, with ``const`` before the
first.  No arithmetic touches a value, so the result equals the
reference's bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["from_thread_or_mem", "ForwardStats", "forward_stats"]


@dataclasses.dataclass(frozen=True)
class ForwardStats:
    """Memory-traffic accounting for one eLDST site (drives Fig. 11/12 analogs)."""

    loads_issued: int          # predicated loads that reached memory
    loads_forwarded: int       # values served by inter-thread forwarding
    loads_naive: int           # loads the von-Neumann version would issue

    @property
    def traffic_reduction(self) -> float:
        return self.loads_naive / max(self.loads_issued, 1)


def _fill_forward(values: torch.Tensor, pred: torch.Tensor, const) -> torch.Tensor:
    """Along dim 1: out[j] = values[j] if pred[j] else out[j-1]; const
    before the first pred.  values: (g, j, delta, *rest); pred: (g, j, delta)."""
    pos = torch.arange(pred.shape[1], device=pred.device).reshape(1, -1, 1)
    last = torch.where(pred, pos, -1).cummax(dim=1).values
    index = last.clamp_min(0)
    index = index.reshape(index.shape + (1,) * (values.ndim - 3)).expand(values.shape)
    taken = values.gather(1, index)
    seen = (last >= 0).reshape(last.shape + (1,) * (values.ndim - 3))
    return torch.where(seen, taken, torch.as_tensor(const, dtype=values.dtype,
                                                     device=values.device))


def from_thread_or_mem(
    mem_values: torch.Tensor,
    pred: torch.Tensor,
    delta: int,
    *,
    window: int | None = None,
    const=0,
    axis: int = 0,
) -> torch.Tensor:
    """Evaluate the eLDST forwarding recurrence along ``axis``.

    ``mem_values[t]`` is the value thread ``t`` *would* load; only positions
    with ``pred[t]`` charge the memory system (:func:`forward_stats`
    accounts for the rest).  ``pred`` has the shape of the thread axis.
    """
    if delta <= 0:
        raise ValueError("fromThreadOrMem forwards from lower TIDs; delta must be > 0")
    x = torch.movedim(mem_values, axis, 0)
    n = x.shape[0]
    pred = torch.as_tensor(pred, dtype=torch.bool, device=x.device)
    if tuple(pred.shape) != (n,):
        raise ValueError(f"pred must have shape ({n},), got {tuple(pred.shape)}")
    win = window if window is not None else n
    rest = tuple(x.shape[1:])

    # Pad the thread axis into whole windows, and each window into whole
    # (chain step, residue) tiles; padded slots have pred=False and are
    # dropped on exit.
    total = n + (-n) % win
    g = total // win
    win_pad = (-win) % delta
    wtot = win + win_pad
    j = wtot // delta

    def pad_rows(arr, rows, dim):
        # F.pad lists (before, after) pairs from the last dim backwards.
        pads = [0, 0] * (arr.ndim - 1 - dim) + [0, rows]
        return F.pad(arr, pads) if rows else arr

    xp = pad_rows(x, total - n, 0).reshape((g, win) + rest)
    pp = pad_rows(pred, total - n, 0).reshape(g, win)
    xp = pad_rows(xp, win_pad, 1).reshape((g, j, delta) + rest)
    pp = pad_rows(pp, win_pad, 1).reshape(g, j, delta)

    out = _fill_forward(xp, pp, const)

    out = out.reshape((g, wtot) + rest)[:, :win]
    out = out.reshape((total,) + rest)[:n]
    return torch.movedim(out, 0, axis)


def forward_stats(pred, delta: int, *, window: int | None = None) -> ForwardStats:
    """Static accounting for an eLDST site (pred evaluated on the host)."""
    p = np.asarray(pred.cpu() if isinstance(pred, torch.Tensor) else pred)
    n = p.shape[0]
    loads = int(p.sum())
    return ForwardStats(
        loads_issued=loads,
        loads_forwarded=int(n - loads),
        loads_naive=int(n),
    )
