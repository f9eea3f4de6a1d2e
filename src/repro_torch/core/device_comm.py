"""Device-space elevator nodes: the paper's fabric edges between the shards
of a mesh axis (counterpart of ``repro.core.device_comm``).

A CGRA elevator node moves a token from thread ``TID`` to ``TID + delta``
and injects a constant at the boundary.  Across a mesh the same pattern is
a point-to-point hand-off between neighbouring shards, with no global
barrier and no gather.  The reference runs it inside ``shard_map`` as a
``ppermute`` over a named axis; the port runs single-controller, as the
reference's own CPU tests do: every function here takes the list of
per-shard tensors along one mesh axis (shard 0 first, each on its shard's
device, see :mod:`repro_torch.launch.mesh`) and returns such a list.

A hop is a ``.to(dest)`` of one shard's tensor: a no-op where the two
shards share a device (n shards on one card), a peer copy between cards.
:func:`device_shift` and :func:`ring_pass` are the only places a value
crosses shards, and :func:`all_to_all` the one place every shard sends to
every other (the expert-parallel MoE's exchange).  All are differentiable:
the backward of a hop is the opposite hop (the transpose of a ppermute),
so autograd through a sweep runs the device-space reverse elevator, as
``jax.grad`` does in the reference, and the backward of an exchange is the
inverse exchange.  :func:`record_hops` logs every hop and exchange,
forward and backward, with the elements that leave each shard: what the
collective-budget check (:mod:`repro_torch.analysis.collectives`) reads.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

__all__ = [
    "Hop",
    "record_hops",
    "axis_size",
    "all_to_all",
    "device_shift",
    "halo_exchange",
    "ring_pass",
    "seq_carry_scan",
]


@dataclasses.dataclass(frozen=True)
class Hop:
    """One collective over a mesh axis.

    ``kind="permute"`` (a ppermute): shard i received shard ``src[i]``'s
    value (``None``: the fill), and ``elements`` is what each sender moved.
    ``kind="all_to_all"``: every shard sent a piece to every other, ``src``
    is ``range(n)`` (shard i's own piece stays put), and ``elements`` is
    what leaves each shard: (n - 1) / n of its send.  ``itemsize``: the
    bytes of one element (the hop's dtype)."""

    elements: int
    src: tuple[int | None, ...]
    kind: str = "permute"
    itemsize: int = dataclasses.field(default=4, compare=False)

    @property
    def bytes(self) -> int:
        """What each sender moved, in bytes."""
        return self.elements * self.itemsize

    @property
    def reverse(self) -> bool:
        """True when a permute's values run from high to low shard index."""
        return self.kind == "permute" and any(
            s is not None and s > i for i, s in enumerate(self.src))


# The recorders are process-wide, not per thread: the backward of CUDA
# tensors runs on autograd's own thread, and its hops are logged too.
_RECORDERS: list[list[Hop]] = []
_RECORDERS_LOCK = threading.Lock()


@contextlib.contextmanager
def record_hops():
    """Log every hop made while the context is open (forward and
    backward): yields the list the :class:`Hop` records are appended to."""
    log: list[Hop] = []
    with _RECORDERS_LOCK:
        _RECORDERS.append(log)
    try:
        yield log
    finally:
        with _RECORDERS_LOCK:
            _RECORDERS.remove(log)


def _record(hop: Hop):
    with _RECORDERS_LOCK:
        for log in _RECORDERS:
            log.append(hop)


def axis_size(mesh, axis_name: str) -> int:
    """Number of shards along ``axis_name``."""
    return mesh.shape[axis_name]


def _move(xs, src, fill):
    return [xs[s].to(x.device) if s is not None else torch.full_like(x, fill)
            for x, s in zip(xs, src)]


class _Permute(torch.autograd.Function):
    """``out[i] = xs[src[i]]`` moved to shard i's device, or ``fill``; the
    backward sends each cotangent back to its source shard."""

    @staticmethod
    def forward(ctx, src, fill, *xs):
        ctx.src = src
        return tuple(_move(xs, src, fill))

    @staticmethod
    def backward(ctx, *grads):
        inv = [None] * len(ctx.src)
        for i, s in enumerate(ctx.src):
            if s is not None:
                inv[s] = i
        return (None, None, *_permute(list(grads), tuple(inv), 0.0))


def _permute(xs, src, fill):
    shapes = {tuple(x.shape) for x in xs}
    if len(shapes) != 1:
        raise ValueError(f"shards of one hop must share a shape, got {sorted(shapes)}")
    _record(Hop(xs[0].numel(), src, itemsize=xs[0].element_size()))
    return list(_Permute.apply(src, fill, *xs))


def _exchange(xs, split_dim, concat_dim):
    n = len(xs)
    pieces = [x.chunk(n, dim=split_dim) for x in xs]
    return [torch.cat([pieces[i][j].to(x.device) for i in range(n)], dim=concat_dim)
            for j, x in enumerate(xs)]


class _AllToAll(torch.autograd.Function):
    """The tiled exchange; the backward is the inverse exchange (split and
    concat dims swapped).  The context holds the dims: the backward of
    CUDA tensors runs on autograd's own thread."""

    @staticmethod
    def forward(ctx, split_dim, concat_dim, *xs):
        ctx.dims = (split_dim, concat_dim)
        return tuple(_exchange(xs, split_dim, concat_dim))

    @staticmethod
    def backward(ctx, *grads):
        split_dim, concat_dim = ctx.dims
        return (None, None, *all_to_all(list(grads), concat_dim, split_dim))


def all_to_all(xs, split_dim: int, concat_dim: int):
    """Tiled all-to-all over the shards of one mesh axis (the reference's
    ``jax.lax.all_to_all(..., tiled=True)``): shard j receives, from every
    sender i, the j-th of the ``n`` equal chunks of ``xs[i]`` along
    ``split_dim``, and concatenates them in sender order along
    ``concat_dim``, on its own device.  Each piece is a ``.to(dest)``; the
    one a shard keeps crosses nothing, so (n - 1) / n of each send leaves
    its shard.  Differentiable; logged as one :class:`Hop` of kind
    ``"all_to_all"``, forward and backward."""
    xs = list(xs)
    n = len(xs)
    shapes = {tuple(x.shape) for x in xs}
    if len(shapes) != 1:
        raise ValueError(f"shards of one exchange must share a shape, got {sorted(shapes)}")
    if xs[0].shape[split_dim] % n:
        raise ValueError(f"dim {split_dim} of {tuple(xs[0].shape)} does not split "
                         f"into {n} pieces")
    _record(Hop(xs[0].numel() // n * (n - 1), tuple(range(n)), "all_to_all",
                xs[0].element_size()))
    return list(_AllToAll.apply(split_dim, concat_dim, *xs))


def device_shift(xs, delta: int = 1, fill=0.0):
    """Elevator shift across shards: shard ``i`` receives shard ``i -
    delta``'s value, moved to its device.  Boundary shards (no producer)
    receive ``fill``, the elevator constant C.  One hop, O(|x|) elements
    from each sending shard."""
    xs = list(xs)
    if delta == 0:
        return xs
    n = len(xs)
    src = tuple(i - delta if 0 <= i - delta < n else None for i in range(n))
    return _permute(xs, src, fill)


def ring_pass(xs, delta: int = 1):
    """Cyclic variant: shard ``i`` receives shard ``(i - delta) mod n``.
    Ring-style forwarding: a value loaded once visits every shard (the
    eLDST pattern)."""
    xs = list(xs)
    n = len(xs)
    return _permute(xs, tuple((i - delta) % n for i in range(n)), 0.0)


def halo_exchange(xs, *, left: int = 0, right: int = 0, seq_axis: int = 0,
                  fill=0.0):
    """Forward boundary tokens between neighbouring sequence shards.

    Each shard's chunk comes back extended with ``left`` trailing tokens
    of the previous shard and ``right`` leading tokens of the next one,
    one hop per side, never a gather of the sequence.  Edge shards
    receive ``fill`` in the missing halo."""
    xs = list(xs)
    parts = []
    if left:
        tails = [x.narrow(seq_axis, x.shape[seq_axis] - left, left) for x in xs]
        parts.append(device_shift(tails, 1, fill))
    parts.append(xs)
    if right:
        parts.append(device_shift([x.narrow(seq_axis, 0, right) for x in xs], -1, fill))
    if len(parts) == 1:
        return xs
    return [torch.cat(p, dim=seq_axis) for p in zip(*parts)]


def seq_carry_scan(chunk_fn, carry_init, xs, *, reverse: bool = False):
    """Sequential carry chain across sequence shards (elevator Δ=1 chain).

    ``chunk_fn(carry, x_local) -> (carry_out, y_local)`` runs on every
    shard; the carry shard ``i`` produces is forwarded to shard ``i+1``
    (``i-1`` with ``reverse=True``, the device-space reverse elevator).
    The first shard of the sweep starts from ``carry_init`` (a tensor, a
    number, or a tuple/list of them), the elevator constant.  Returns
    ``(carries, ys)``: each shard's produced carry and output.  The chain
    runs n-1 hops, each a :func:`device_shift` of every shard's latest
    carry, as the reference's ppermutes do; only the shard whose turn it
    is runs ``chunk_fn``."""
    xs = list(xs)
    n = len(xs)
    order = list(range(n - 1, -1, -1)) if reverse else list(range(n))
    delta = -1 if reverse else 1

    def init_on(x):
        return tree_map(lambda c: torch.as_tensor(c, device=x.device), carry_init)

    carries = [init_on(x) for x in xs]
    ys = [None] * n
    for k, i in enumerate(order):
        if k:
            leaves = [tree_leaves(c) for c in carries]
            moved = [device_shift([lv[j] for lv in leaves], delta)
                     for j in range(len(leaves[0]))]
            carry_in = tree_unflatten(carries[i], [m[i] for m in moved])
        else:
            carry_in = carries[i]
        carries[i], ys[i] = chunk_fn(carry_in, xs[i])
    return carries, ys
