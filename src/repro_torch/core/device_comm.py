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
:func:`device_shift` and :func:`ring_pass` are the point-to-point hops,
:func:`all_to_all` the exchange where every shard sends to every other
(the expert-parallel MoE's), and :func:`all_gather`, :func:`all_reduce`
and :func:`reduce_scatter` the collectives of the sharded dense layers
(:mod:`repro_torch.model.sharding`), and :func:`softmax_combine` the
merge of attention partials over a split key sequence (sharded decode).  All are differentiable, each
backward the forward's transpose: the opposite hop for a ppermute (so
autograd through a sweep runs the device-space reverse elevator, as
``jax.grad`` does in the reference), the inverse exchange for an
all-to-all, a reduce-scatter for an all-gather and the other way round,
and an all-reduce for an all-reduce.  :func:`record_hops` logs every hop,
forward and backward, with the elements each shard sends: what the
collective-budget check (:mod:`repro_torch.analysis.collectives`) and the
roofline's collective term read.

Each collective takes the ``n`` shards of one group along a mesh axis, or,
on a representative mesh (one shard standing for every card of a
production mesh on ``meta``), the one shard and the axis's extent ``n``:
then the output has the shape a real group's would and the hop logs the
bytes of ``n`` shards.  The data movement counts as live bytes but adds no
FLOPs or bytes to a cost trace (:func:`repro_torch.core.lowering.kernel_scope`):
a collective's cost is its hop.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading

import torch

from repro_torch.core.lowering import cell_of, kernel_scope
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

__all__ = [
    "Hop",
    "record_hops",
    "axis_size",
    "all_gather",
    "all_reduce",
    "reduce_scatter",
    "all_to_all",
    "softmax_combine",
    "device_shift",
    "halo_exchange",
    "ring_pass",
    "seq_carry_scan",
]


@dataclasses.dataclass(frozen=True)
class Hop:
    """One collective over a mesh axis: ``elements`` is what each shard
    sends, in the closed form of a ring over the axis's ``n`` shards, for a
    shard's input of ``E`` elements:

    * ``"permute"`` (a ppermute): shard i received shard ``src[i]``'s value
      (``None``: the fill); each sender moves ``E``;
    * ``"all_to_all"``: every shard sends a piece to every other and keeps
      its own: ``(n - 1) / n * E``;
    * ``"all_gather"``: each shard's ``E`` reaches the other ``n - 1``,
      forwarded round the ring: ``(n - 1) * E``;
    * ``"reduce_scatter"``: each shard ends with the sum of one ``1 / n``
      of the buffer: ``(n - 1) / n * E``;
    * ``"all_reduce"``: a reduce-scatter then an all-gather of the sums:
      ``2 (n - 1) / n * E``.

    ``src`` is ``range(n)`` for every kind but a permute.  ``axis``: the
    mesh axis (``None`` where the caller named none); ``itemsize``: the
    bytes of one element (the hop's dtype)."""

    elements: int
    src: tuple[int | None, ...]
    kind: str = "permute"
    itemsize: int = dataclasses.field(default=4, compare=False)
    axis: str | None = dataclasses.field(default=None, compare=False)

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


def _exchange(xs, split_dim, concat_dim, n):
    if len(xs) < n:                    # a representative shard: the shape only
        x = xs[0].narrow(split_dim, 0, xs[0].shape[split_dim] // n)
        return [torch.cat([x] * n, dim=concat_dim)]
    pieces = [x.chunk(n, dim=split_dim) for x in xs]
    return [_on(x, lambda j=j, x=x: torch.cat([pieces[i][j].to(x.device) for i in range(n)],
                                             dim=concat_dim))
            for j, x in enumerate(xs)]


def _on(x, make):
    """``make()``, the output that shard ``x``'s member receives, counted
    as that member's (:func:`repro_torch.core.lowering.cell_of`)."""
    with cell_of(x):
        return make()


def _group(xs, n):
    """``(list of shards, n)``: ``n`` defaults to the shards given; a
    representative call gives one shard and the axis's extent."""
    xs = list(xs)
    n = len(xs) if n is None else n
    if len(xs) not in (1, n):
        raise ValueError(f"{len(xs)} shards for a group of {n}")
    shapes = {tuple(x.shape) for x in xs}
    if len(shapes) != 1:
        raise ValueError(f"shards of one collective must share a shape, got {sorted(shapes)}")
    return xs, n


class _AllToAll(torch.autograd.Function):
    """The tiled exchange; the backward is the inverse exchange (split and
    concat dims swapped).  The context holds the dims: the backward of
    CUDA tensors runs on autograd's own thread."""

    @staticmethod
    def forward(ctx, split_dim, concat_dim, axis, n, *xs):
        ctx.dims = (split_dim, concat_dim, axis, n)
        with kernel_scope():
            return tuple(_exchange(xs, split_dim, concat_dim, n))

    @staticmethod
    def backward(ctx, *grads):
        split_dim, concat_dim, axis, n = ctx.dims
        return (None, None, None, None,
                *all_to_all(list(grads), concat_dim, split_dim, axis=axis, n=n))


def all_to_all(xs, split_dim: int, concat_dim: int, *, axis: str | None = None,
               n: int | None = None):
    """Tiled all-to-all over the shards of one mesh axis (the reference's
    ``jax.lax.all_to_all(..., tiled=True)``): shard j receives, from every
    sender i, the j-th of the ``n`` equal chunks of ``xs[i]`` along
    ``split_dim``, and concatenates them in sender order along
    ``concat_dim``, on its own device.  Each piece is a ``.to(dest)``; the
    one a shard keeps crosses nothing, so (n - 1) / n of each send leaves
    its shard.  Differentiable; logged as one :class:`Hop` of kind
    ``"all_to_all"``, forward and backward."""
    xs, n = _group(xs, n)
    if xs[0].shape[split_dim] % n:
        raise ValueError(f"dim {split_dim} of {tuple(xs[0].shape)} does not split "
                         f"into {n} pieces")
    _record(Hop(xs[0].numel() // n * (n - 1), tuple(range(n)), "all_to_all",
                xs[0].element_size(), axis))
    return list(_AllToAll.apply(split_dim, concat_dim, axis, n, *xs))


def _sum_in_order(xs, device):
    """``xs[0] + xs[1] + ...`` in shard order, on ``device``: every shard of
    an all-reduce adds the same values in the same order, so all hold the
    same bits."""
    out = xs[0].to(device)
    for x in xs[1:]:
        out = out + x.to(device)
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dim, axis, n, *xs):
        ctx.args = (dim, axis, n)
        with kernel_scope():
            if len(xs) < n:
                return (torch.cat([xs[0]] * n, dim=dim),)
            return tuple(_on(x, lambda x=x: torch.cat([y.to(x.device) for y in xs], dim=dim))
                         for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        dim, axis, n = ctx.args
        return (None, None, None, *reduce_scatter(list(grads), dim, axis=axis, n=n))


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dim, axis, n, *xs):
        ctx.args = (dim, axis, n)
        size = xs[0].shape[dim] // n
        with kernel_scope():
            if len(xs) < n:
                return (xs[0].narrow(dim, 0, size).clone(),)
            return tuple(_on(x, lambda j=j, x=x: _sum_in_order(
                [y.narrow(dim, j * size, size) for y in xs], x.device))
                for j, x in enumerate(xs))

    @staticmethod
    def backward(ctx, *grads):
        dim, axis, n = ctx.args
        return (None, None, None, *all_gather(list(grads), dim, axis=axis, n=n))


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, axis, n, *xs):
        ctx.args = (axis, n)
        with kernel_scope():
            if len(xs) < n:
                return (xs[0].clone(),)
            return tuple(_on(x, lambda x=x: _sum_in_order(xs, x.device)) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        axis, n = ctx.args
        return (None, None, *all_reduce(list(grads), axis=axis, n=n))


def all_gather(xs, dim: int, *, axis: str | None = None, n: int | None = None):
    """Each shard receives every shard's tensor, concatenated in shard
    order along ``dim`` on its own device (``jax.lax.all_gather(...,
    tiled=True)``).  Its backward is a :func:`reduce_scatter`."""
    xs, n = _group(xs, n)
    if n == 1:
        return xs
    _record(Hop(xs[0].numel() * (n - 1), tuple(range(n)), "all_gather",
                xs[0].element_size(), axis))
    return list(_AllGather.apply(dim, axis, n, *xs))


def reduce_scatter(xs, dim: int, *, axis: str | None = None, n: int | None = None):
    """Shard j receives the sum over shards, in shard order, of the j-th of
    the ``n`` equal chunks of each tensor along ``dim``
    (``jax.lax.psum_scatter(..., tiled=True)``).  Its backward is an
    :func:`all_gather`."""
    xs, n = _group(xs, n)
    if n == 1:
        return xs
    if xs[0].shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(xs[0].shape)} does not split into {n} pieces")
    _record(Hop(xs[0].numel() // n * (n - 1), tuple(range(n)), "reduce_scatter",
                xs[0].element_size(), axis))
    return list(_ReduceScatter.apply(dim, axis, n, *xs))


def all_reduce(xs, *, axis: str | None = None, n: int | None = None, op: str = "sum"):
    """Every shard receives the sum of the shards' tensors, added in shard
    order (``jax.lax.psum``; differentiable, its backward a psum of the
    cotangents), or with ``op="max"`` their largest (``pmax``; not
    differentiable: the loss takes it detached)."""
    xs, n = _group(xs, n)
    if n == 1:
        return xs
    _record(Hop(xs[0].numel() * 2 * (n - 1) // n, tuple(range(n)), "all_reduce",
                xs[0].element_size(), axis))
    if op == "max":
        with torch.no_grad(), kernel_scope():
            if len(xs) < n:
                return [xs[0].clone()]
            out = [_on(x, lambda x=x: functools.reduce(torch.maximum,
                                                       [y.to(x.device) for y in xs]))
                   for x in xs]
        return out
    if op != "sum":
        raise ValueError(f"unknown all-reduce op {op!r}")
    return list(_AllReduce.apply(axis, n, *xs))


def softmax_combine(parts, *, axis: str | None = None, n: int | None = None):
    """Merge the softmax partials of the shards of one mesh axis, each over
    its own keys: a part (..., 2 + D) f32 packs each row's maximum ``m``,
    denominator ``l`` and numerators ``o`` (D), taken against ``m``.  Two
    hops: an all-reduce max of the maxima (``M``), then one all-reduce sum
    of each shard's ``[l, o] * exp(m - M)``.  Every shard receives ``[M, L,
    O]``, the partial of all the axis's keys (the same bits on each).  Not
    differentiable (decode).  Logged as two :class:`Hop` of kind
    ``"all_reduce"``: 2 (n - 1) / n of the rows, and of (D + 1) x the
    rows."""
    big = all_reduce([p[..., :1] for p in parts], axis=axis, n=n, op="max")
    with torch.no_grad():
        scaled = [_on(p, lambda p=p, mx=mx: p[..., 1:] * torch.exp(p[..., :1] - mx))
                  for p, mx in zip(parts, big)]
        tot = all_reduce(scaled, axis=axis, n=n)
        return [_on(mx, lambda mx=mx, t=t: torch.cat([mx, t], dim=-1))
                for mx, t in zip(big, tot)]


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
