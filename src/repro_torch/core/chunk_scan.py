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

* :func:`device_linear_scan_carry`: the same composition across a mesh
  axis.  Each shard contributes its segment summary ``(A, B)``; a
  log-depth Hillis–Steele chain of device shifts
  (:func:`repro_torch.core.device_comm.device_shift`, device-space
  elevator nodes) delivers the entering carry to every shard.
  Point-to-point, no gather.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core import device_comm

__all__ = [
    "SegmentMonoid",
    "ELEMENTWISE",
    "DIAG_STATE",
    "linear_scan",
    "chunked_linear_scan",
    "device_linear_scan_carry",
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


def device_linear_scan_carry(a_seg, b_seg, *, monoid: SegmentMonoid = ELEMENTWISE,
                             reverse: bool = False):
    """Entering carry per shard for a sequence sharded over a mesh axis.

    ``a_seg``/``b_seg`` are the shards' segment summaries (product of
    decays, accumulated input), one tensor per shard in axis order.
    Returns ``(carry_a, carry_b)`` lists such that the state entering shard
    ``i`` is ``monoid.scale(carry_a[i], h0) + carry_b[i]``: the composition
    of all predecessor segments.  log2(n) hops (Hillis–Steele), each a
    device shift with the identity segment (1, 0) as the boundary
    constant, then one more shift by one.

    ``reverse=True`` runs the sweep from the last shard toward shard 0:
    the carry entering shard ``i`` is then the composition of all
    successor segments (applied last-to-first), the device-space reverse
    elevator of an adjoint carry.
    """
    acc_a, acc_b = list(a_seg), list(b_seg)
    n = len(acc_a)
    sgn = -1 if reverse else 1
    d = 1
    while d < n:
        shifted_a = device_comm.device_shift(acc_a, sgn * d, fill=1.0)
        shifted_b = device_comm.device_shift(acc_b, sgn * d, fill=0.0)
        # Predecessor block applied first, current block second.
        pairs = [monoid.compose((sa, sb), (a, b))
                 for sa, sb, a, b in zip(shifted_a, shifted_b, acc_a, acc_b)]
        acc_a, acc_b = [p[0] for p in pairs], [p[1] for p in pairs]
        d *= 2
    # acc holds the inclusive composition; the entering carry is the
    # predecessor's inclusive value, one more elevator shift.
    return (device_comm.device_shift(acc_a, sgn, fill=1.0),
            device_comm.device_shift(acc_b, sgn, fill=0.0))
