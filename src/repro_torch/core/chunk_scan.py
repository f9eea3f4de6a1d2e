"""Windowed linear-recurrence scans built from elevator carries, in PyTorch.

Counterpart of ``repro.core.chunk_scan`` on one device.  The paper's
prefix-sum example (Fig. 6) is the degenerate case of

    h[t] = a[t] * h[t-1] + b[t]          (a ≡ 1, b = loaded value)

with the inter-thread edge ``fromThreadOrConst<sum, Δ=1, C=0>``.

* :func:`linear_scan`: Hillis–Steele doubling on the composition law
  (log2(T) rounds; each round composes every element with the one ``d``
  before it, an elevator shift by ``d``).  The reference runs
  ``lax.associative_scan``, which combines in another order, so results
  agree to rounding, not bit for bit.
* :func:`chunked_linear_scan`: dense within-chunk doubling scans plus an
  across-chunk carry chain (a Python loop over the chunk summaries where
  the reference has a ``lax.scan``): the cascade of elevator nodes with
  Δ=1 over chunk space.

Both run ONE composition law, the :class:`SegmentMonoid`:

    (a1, b1) ∘then∘ (a2, b2) = (a2·a1, a2★b1 + b2)

where ``★`` is the monoid's action of a decay on a state:
:data:`ELEMENTWISE` (``*``; RG-LRU and the prefix sum) and
:data:`DIAG_STATE` (a (..., Dh) decay on the rows of a (..., Dh, Dh)
state; the WKV segment summary).

``device_linear_scan_carry`` (the same composition across a mesh axis) and
the other device-space elevators of ``repro.core.device_comm`` come with
the port's multi-GPU slice.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

__all__ = [
    "SegmentMonoid",
    "ELEMENTWISE",
    "DIAG_STATE",
    "linear_scan",
    "chunked_linear_scan",
]


@dataclasses.dataclass(frozen=True)
class SegmentMonoid:
    """Associative composition of ``(decay, state)`` segment summaries.

    ``scale(a, b)`` is the action of a decay on a state-shaped value.
    Decays always compose elementwise (``a2 * a1``); only the action on the
    state varies between recurrences.  The identity element is ``(1, 0)``.
    """

    scale: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

    def compose(self, first, second):
        """Summary of ``first``-then-``second`` (first applied first)."""
        a1, b1 = first
        a2, b2 = second
        return a2 * a1, self.scale(a2, b1) + b2

    def apply(self, segment, h):
        """Run a summarized segment from state ``h``: ``a★h + b``."""
        a, b = segment
        return self.scale(a, h) + b


ELEMENTWISE = SegmentMonoid(scale=lambda a, b: a * b)
DIAG_STATE = SegmentMonoid(scale=lambda a, b: a[..., :, None] * b)


def _doubling_scan(monoid: SegmentMonoid, a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan along dim 0 by Hillis–Steele doubling: after the round
    of stride ``d`` each element holds the composition of the ``2d`` steps
    ending at it.  Returns ``(a_cum, b_cum)``."""
    n = a.shape[0]
    d = 1
    while d < n:
        ca, cb = monoid.compose((a[:-d], b[:-d]), (a[d:], b[d:]))
        a = torch.cat([a[:d], ca])
        b = torch.cat([b[:d], cb])
        d *= 2
    return a, b


def linear_scan(a, b, *, axis: int = 0, h0=None) -> torch.Tensor:
    """h[t] = a[t]*h[t-1] + b[t] with h[-1] = h0 (default 0).  Log-depth.

    ``a`` and ``b`` may be tensors or numpy arrays; ``h0`` folds into step
    0 (``h[0] = a[0]*h0 + b[0]``) for either.
    """
    a = torch.as_tensor(a)
    b = torch.as_tensor(b)
    a = torch.movedim(a, axis, 0)
    b = torch.movedim(b, axis, 0)
    if h0 is not None:
        h0 = torch.as_tensor(h0, dtype=b.dtype, device=b.device)
        b = torch.cat([(a[:1] * h0 + b[:1]).to(b.dtype), b[1:]])
    _, h = _doubling_scan(ELEMENTWISE, a, b)
    return torch.movedim(h, 0, axis)


def chunked_linear_scan(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    chunk: int,
    axis: int = 0,
    h0=None,
    monoid: SegmentMonoid = ELEMENTWISE,
) -> torch.Tensor:
    """Two-level scan: intra-chunk doubling scans + inter-chunk carries.

    The within-chunk scan is the dataflow graph body; the across-chunk carry
    is the elevator edge (Δ=1 over chunk index, C = h0).  With
    ``monoid=DIAG_STATE`` the state ``b`` carries extra trailing dimensions
    (a (Dh, Dh) matrix per step decayed by a (Dh,) vector ``a``).
    """
    a = torch.movedim(torch.as_tensor(a), axis, 0)
    b = torch.movedim(torch.as_tensor(b), axis, 0)
    t = a.shape[0]
    if t % chunk:
        raise ValueError(f"sequence length {t} not divisible by chunk {chunk}")
    n_chunks = t // chunk
    rest_a = tuple(a.shape[1:])
    rest_b = tuple(b.shape[1:])
    # (chunk, n_chunks, ...): the scan runs along dim 0, over every chunk at once.
    ac = a.reshape((n_chunks, chunk) + rest_a).transpose(0, 1)
    bc = b.reshape((n_chunks, chunk) + rest_b).transpose(0, 1)
    acum, bcum = _doubling_scan(monoid, ac, bc)

    # Across-chunk carry chain: carry k enters chunk k.
    carry = (torch.zeros(rest_b, dtype=b.dtype, device=b.device) if h0 is None
             else torch.as_tensor(h0, dtype=b.dtype, device=b.device).expand(rest_b))
    carries = []
    for k in range(n_chunks):
        carries.append(carry)
        carry = monoid.apply((acum[-1, k], bcum[-1, k]), carry)
    carries = torch.stack(carries)

    h = monoid.apply((acum, bcum), carries[None])
    h = h.transpose(0, 1).reshape((t,) + rest_b)
    return torch.movedim(h, 0, axis)
