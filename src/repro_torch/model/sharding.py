"""Logical-axis sharding rules and partition specs (counterpart of
``repro.model.sharding``).

Every parameter, state and activation dimension carries a *logical* name;
a rules table maps logical names to mesh axes per execution mode (train /
prefill / decode).  The serve engine installs a (mesh, rules) context for
long prompts; the RWKV block reads it (:func:`seq_shard_info`) and takes
the sequence-parallel WKV path when ``seq`` maps to a mesh axis of more
than one shard, and the expert-parallel MoE
(:mod:`repro_torch.model.moe_a2a`) splits its tokens by it.  Outside a
context nothing changes.

Ported: :func:`make_rules` (the reference's table, pure Python),
:func:`sharding_context`, :func:`axes_size`, :func:`seq_shard_info`,
:func:`remat_context`, which a recomputed period runs under, the spec
half of the reference's sharding: :class:`PartitionSpec` (``P``),
:func:`to_pspec` and :func:`spec_mk`, the ``mk`` constructor that turns
the parameter init functions into spec trees (``model.param_pspecs``),
and its placement half: :class:`NamedSharding`, :func:`device_put`,
:func:`constrain` and :func:`gather_for_use`.

**The dense layers run sharded** where the reference's GSPMD partitions
them: the train step and the prefill / scoring forward of the
decoder-only archs, under ``make_rules(mesh, "train" | "prefill")`` on a
(data, model) mesh.  A :class:`Sharded` tensor is the port's
``jax.Array`` with a ``NamedSharding``: an object array shaped like the
mesh holding each shard's local tensor on its shard's device (replicated
dims repeated, each shard its own tensor), and the mesh axes over which
the shards hold partial sums.  The single controller runs every shard's
program in turn; where GSPMD inserts a collective, the port makes it
explicitly (:mod:`repro_torch.core.device_comm`), each a logged hop:

* :func:`constrain` puts a tensor into the layout its logical axes give,
  axis by axis: a split costs nothing, a dim leaving an axis is an
  all-gather, a dim moving to another is an all-to-all, and partial sums
  become a reduce-scatter (to a sharded dim) or an all-reduce (to a
  replicated value);
* :func:`gather_for_use` strips the data (FSDP) axes off a weight: an
  all-gather of its shards before use;
* :func:`dense` is ``x @ w`` against a weight whose contracted dim may be
  sharded: ``x`` is first laid out so that its last dim carries the
  weight's contracted axes (and no other dim the weight's axes), each
  shard multiplies its pieces, and the product holds partial sums over
  the contracted axes, which the caller's :func:`constrain` reduces.  With
  ``fsdp_gather_weights=False`` the contracted ``embed`` dim stays sharded
  over data, so the activations move instead of the weights: an
  all-to-all of ``x`` (each data shard keeps its slice of ``d_model`` for
  every row) and a reduce-scatter of the product back onto the batch;
  row-parallel products gather their input rows over data and return
  their ``d_model`` slices by an all-to-all.

Gradients follow the transposes: the cotangent of a replicated value is
held as partial sums on its replicas (the all-reduce of a replicated
leaf's grads is the data-parallel all-reduce, ``train/step.py``).

**Decode** runs sharded too, under ``decode`` (batch over data, the KV
sequence over model) and ``decode_long`` (batch whole, the KV sequence
over every axis): the decode state is split by its specs
(:func:`repro_torch.model.model.shard_decode_state`), each shard writes
a window's K/V rows into the cache slots it owns and attends over them,
and the shards' softmax partials meet in :func:`combine_partials`, an
all-reduce of the row maxima and one of the rescaled numerators and
denominators over the KV sequence's axes (flash-decoding).  Recurrent
states stay in their spec layout between calls.  The encoder-decoder arch
runs sharded under all three modes.  Only ``prefill_seq`` keeps the dense
layers whole on the input's device (the seq path).

A mesh on ``meta`` may be *representative*
(:func:`repro_torch.launch.mesh.representative`): one shard runs one
card's program and each collective is sized from its axis's extent; a
dim that its axes do not divide is padded there, as XLA pads.  A dim
split over two mesh axes (``("pod", "data")``, or ``decode_long``'s KV
sequence over ``("data", "model")``) is placed, read back and combined
over on any mesh; gathering its outer axis off it
(:func:`reshard`) is sized on a representative mesh only, where shapes
and bytes are all that is read, and raises ``NotImplementedError``
elsewhere.

One rule differs: under ``prefill_seq`` the reference maps ``seq`` to the
``model`` axis, so a mesh without one (``make_seq_mesh``'s 1-D ``seq``
mesh) is left unsharded.  Here such a mesh maps ``seq`` to its own
``seq`` axis, so that one card can run the protocol over a mesh of
repeated devices.  A mesh with a ``model`` axis gets the reference's
rules.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any

import numpy as np
import torch

from repro_torch.core import device_comm as comm
from repro_torch.core.lowering import cell_scope, claim
from repro_torch.tree import tree_leaves, tree_unflatten

__all__ = ["make_rules", "sharding_context", "axes_size", "seq_shard_info",
           "remat_context", "PartitionSpec", "P", "to_pspec", "spec_mk",
           "NamedSharding", "Sharded", "device_put", "device_put_tree", "to_global",
           "constrain", "gather_for_use", "dense", "smap", "reshard", "active_mesh",
           "is_sharded", "rule_axes", "shard_index", "offset", "transpose", "all_reduce_max",
           "replicas", "along", "cell_scope", "combine_partials", "copy_into"]


class PartitionSpec(tuple):
    """Which mesh axes each dimension of a tensor is split over: one entry a
    dimension, a mesh axis name, a tuple of names, or ``None``
    (replicated); trailing dimensions left out are replicated.  A tuple, so
    it compares equal to the reference's ``jax.sharding.PartitionSpec``
    turned into a tuple, and prints as the reference's does.  A leaf of
    :mod:`repro_torch.tree`."""

    __slots__ = ()
    _tree_leaf = True

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        inner = ", ".join(map(repr, self))
        return f"PartitionSpec({inner}{',' if len(self) == 1 else ''})"


P = PartitionSpec


def make_rules(mesh, mode: str) -> dict:
    """Sharding rules for a mesh with ("pod",)? + ("data", "model") axes
    (or a 1-D ``seq`` mesh)."""
    axes = mesh.axis_names
    data_axes = tuple(a for a in ("pod", "data") if a in axes)
    data = data_axes if len(data_axes) > 1 else (data_axes[0] if data_axes else None)
    model = "model" if "model" in axes else None

    rules = {
        # parameters
        "vocab": model,
        "embed": data,        # FSDP/ZeRO-3: weights' d_model axis over data
        "heads_out": model,   # flattened n_heads*head_dim projection dim
        "kv_out": model,
        "ff": model,
        "experts": model,     # EP
        "rnn": model,
        "layers": None,
        "taps": None,
        "stats": None,
        # activations
        "batch": data,
        "seq": None,
        "act_embed": None,
        "act_ff": model,
        "act_heads": model,
        "kv_seq": None,
        "expert_cap": None,
    }
    if mode == "decode":
        rules["kv_seq"] = model
    elif mode == "decode_long":
        both = tuple(a for a in (data if isinstance(data, tuple) else (data,))
                     if a) + ((model,) if model else ())
        rules["batch"] = None
        rules["kv_seq"] = both if len(both) > 1 else (both[0] if both else None)
        rules["seq"] = None
    elif mode == "prefill":
        rules["seq"] = None
    elif mode == "prefill_seq":
        # Long-context prefill: the sequence goes over the model axis (or
        # a 1-D mesh's own seq axis).  Recurrent blocks detect this rule
        # (seq_shard_info) and take the sequence-parallel WKV path: only
        # the O(Dh²) (decay, state) segment summary crosses the seq axis
        # (kernels/wkv/seqpar), never the token activations.
        rules["seq"] = model if model else ("seq" if "seq" in axes else None)
        rules["act_ff"] = None
        rules["act_heads"] = None
    return rules


class _Ctx(threading.local):
    mesh = None
    rules: dict | None = None


_CTX = _Ctx()


@contextlib.contextmanager
def sharding_context(mesh, rules: dict):
    prev = (_CTX.mesh, _CTX.rules)
    _CTX.mesh, _CTX.rules = mesh, rules
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = prev


def remat_context():
    """``(forward context, recompute context)`` for
    ``torch.utils.checkpoint``'s ``context_fn``: the recompute of a period
    runs under the rules its forward ran under.  (The backward of CUDA
    tensors runs on autograd's own thread, which does not see this
    thread's context; the reference traces its period once, under one
    context.)"""
    mesh, rules = _CTX.mesh, _CTX.rules
    if mesh is None or rules is None:
        return contextlib.nullcontext(), contextlib.nullcontext()
    return contextlib.nullcontext(), sharding_context(mesh, rules)


def axes_size(mesh, axes) -> int:
    """Total mesh extent of a rules entry (axis name, tuple of names, or
    None/empty → 1)."""
    if not axes:
        return 1
    axes = axes if isinstance(axes, tuple) else (axes,)
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def seq_shard_info():
    """(mesh, seq_axes, batch_axes) when the active rules map ``seq`` to a
    mesh axis (sequence-parallel mode, e.g. ``prefill_seq``); None
    otherwise.  Recurrent blocks consult this to dispatch the
    segment-summary sequence-parallel path."""
    if _CTX.mesh is None or _CTX.rules is None:
        return None
    seq = _CTX.rules.get("seq")
    if not seq:
        return None
    return _CTX.mesh, seq, _CTX.rules.get("batch")


def to_pspec(axes: tuple, rules: dict) -> PartitionSpec:
    """The spec of a tensor whose dimensions carry the logical ``axes``
    under ``rules``.  A spec maps each mesh axis to at most one dimension:
    where a mode aliases two logical axes onto one mesh axis (``prefill_seq``
    maps ``seq`` to the model axis, which ``vocab`` also names), the
    earlier dimension keeps it and the later ones are replicated.  Trailing
    ``None``s are trimmed."""
    parts = []
    used: set = set()
    for ax in axes:
        r = rules.get(ax) if ax is not None else None
        vals = r if isinstance(r, tuple) else (r,)
        if any(v in used for v in vals if v is not None):
            r = None
        else:
            used.update(v for v in vals if v is not None)
        parts.append(r)
    while parts and parts[-1] is None:
        parts.pop()
    return P(*parts)


def spec_mk(rules: dict):
    """The ``mk(name, shape, axes, init, scale)`` constructor that returns
    each parameter's :class:`PartitionSpec`: the parameter init functions run
    through it give the spec tree, from the same code path as the
    parameters, so specs cannot drift from shapes."""

    def mk(name, shape, axes, init="normal", scale=None):
        return to_pspec(axes, rules)

    return mk


# --------------------------------------------------------------------------
# Sharded tensors
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class NamedSharding:
    """Where a tensor lives: a mesh and a :class:`PartitionSpec` (the
    reference's ``jax.sharding.NamedSharding``)."""

    mesh: Any
    spec: PartitionSpec


def _dims(spec, ndim: int, mesh) -> tuple[tuple[str, ...], ...]:
    """A spec as one tuple of mesh axes a dim, axes of extent 1 dropped."""
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} for a tensor of {ndim} dims")
    out = []
    for i in range(ndim):
        r = spec[i] if i < len(spec) else None
        axes = () if r is None else (r if isinstance(r, tuple) else (r,))
        out.append(tuple(a for a in axes if mesh.shape[a] > 1))
    return tuple(out)


def _spec(dims) -> PartitionSpec:
    parts = [None if not d else (d[0] if len(d) == 1 else d) for d in dims]
    while parts and parts[-1] is None:
        parts.pop()
    return P(*parts)


def _extent(mesh, axes) -> int:
    return int(np.prod([mesh.shape[a] for a in axes])) if axes else 1


class Sharded:
    """A global tensor of ``shape`` split over ``mesh`` as ``dims`` say
    (one tuple of mesh axes a dim): ``shards`` is an object array shaped
    like ``mesh.devices`` holding each shard's local tensor on its device;
    ``partial``: the mesh axes over which the shards hold partial sums.
    ``+`` and ``*`` of two tensors of one layout act shard by shard."""

    __slots__ = ("mesh", "dims", "shards", "shape", "partial")

    def __init__(self, mesh, dims, shards, shape, partial=()):
        self.mesh, self.dims, self.shards = mesh, tuple(dims), shards
        self.shape, self.partial = tuple(shape), tuple(partial)

    @property
    def spec(self) -> PartitionSpec:
        return _spec(self.dims)

    @property
    def sharding(self) -> NamedSharding:
        return NamedSharding(self.mesh, self.spec)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.shards.flat[0].dtype

    def cells(self):
        return list(np.ndindex(self.shards.shape))

    def local_shape(self) -> tuple[int, ...]:
        return tuple(self.shards.flat[0].shape)

    def __repr__(self) -> str:
        p = f", partial={self.partial}" if self.partial else ""
        return f"Sharded({list(self.shape)}, {self.spec}{p})"

    def _binary(self, other, op):
        if other.dims != self.dims or other.partial or self.partial:
            raise ValueError(f"{op.__name__} of {self} and {other}: lay them out alike")
        return smap(op, self, other, dims=self.dims)

    def __add__(self, other):
        return self._binary(other, torch.add)

    def __mul__(self, other):
        return self._binary(other, torch.mul)

    def __getitem__(self, i: int) -> "Sharded":
        """Slice ``i`` of an unsharded leading dim (a stacked layer axis):
        each shard's view of it."""
        if not isinstance(i, int) or self.dims[0]:
            raise ValueError(f"index {i!r} of {self}: an int on an unsharded leading dim")
        arr = np.empty(self.shards.shape, dtype=object)
        for c in self.cells():
            arr[c] = self.shards[c][i]
        return Sharded(self.mesh, self.dims[1:], arr, self.shape[1:], self.partial)

    def unbind(self, dim: int = 0):
        """The slices of an unsharded leading dim (a stacked layer axis)."""
        if dim != 0 or self.dims[0]:
            raise ValueError(f"unbind of a sharded leading dim: {self}")
        n = self.shape[0]
        parts = [np.empty(self.shards.shape, dtype=object) for _ in range(n)]
        for c in self.cells():
            for i, t in enumerate(self.shards[c].unbind(0)):
                parts[i][c] = t
        return [Sharded(self.mesh, self.dims[1:], p, self.shape[1:], self.partial)
                for p in parts]


def is_sharded(x) -> bool:
    return isinstance(x, Sharded)


def active_mesh():
    """The mesh of the active context when the dense layers run sharded
    there: the rules of a train, prefill, decode or decode_long mode on a
    mesh of more than one shard; else None.  Under ``prefill_seq``
    (``seq`` mapped) the dense layers stay whole: their sharding there is
    ROADMAP Queue 1, item 7c."""
    mesh, rules = _CTX.mesh, _CTX.rules
    if mesh is None or rules is None or rules.get("seq"):
        return None
    return mesh if mesh.size > 1 else None


def rule_axes(name) -> tuple[str, ...]:
    """The mesh axes the active rules give logical axis ``name``."""
    r = _CTX.rules.get(name) if name is not None and _CTX.rules else None
    return () if r is None else (r if isinstance(r, tuple) else (r,))


def shard_index(mesh, cell, axes) -> int:
    """Shard ``cell``'s position along ``axes`` (row-major over them): which
    piece of a dim split over ``axes`` it holds."""
    i = 0
    for a in axes:
        k = mesh.axis_names.index(a)
        i = i * mesh.shape[a] + cell[k]
    return i


def _local_size(mesh, size: int, axes) -> int:
    n = _extent(mesh, axes)
    if size % n:
        if not mesh.is_representative:
            raise ValueError(f"a dim of {size} does not split over {axes} ({n} shards)")
        return -(-size // n)                   # padded, as XLA pads
    return size // n


def _piece(x: torch.Tensor, mesh, cell, dims) -> torch.Tensor:
    """Shard ``cell``'s piece of a global tensor (a view)."""
    for d, axes in enumerate(dims):
        if axes:
            m = _local_size(mesh, x.shape[d], axes)
            x = x.narrow(d, min(shard_index(mesh, cell, axes) * m, x.shape[d] - m), m)
    return x


def device_put(x: torch.Tensor, sharding: NamedSharding, *,
               requires_grad: bool | None = None) -> Sharded:
    """``x`` split into ``sharding``'s layout: each shard a copy of its
    piece on its device (the reference's ``jax.device_put``).
    ``requires_grad``: make each shard a leaf that does (or does not)."""
    mesh = sharding.mesh
    dims = _dims(sharding.spec, x.ndim, mesh)
    out = np.empty(mesh.devices.shape, dtype=object)
    for c in np.ndindex(mesh.devices.shape):
        with cell_scope(c):
            t = _piece(x.detach() if requires_grad is not None else x, mesh, c, dims)
            t = t.to(mesh.devices[c], copy=True)
            if requires_grad is not None:
                t.requires_grad_(requires_grad)
        out[c] = t
    return Sharded(mesh, dims, out, x.shape)


def device_put_tree(tree, specs, mesh, *, requires_grad: bool | None = None):
    """Every tensor leaf of ``tree`` through :func:`device_put` with the
    :class:`PartitionSpec` at the same place of ``specs``."""
    leaves = [device_put(x, NamedSharding(mesh, s), requires_grad=requires_grad)
              if isinstance(x, torch.Tensor) else x
              for x, s in zip(tree_leaves(tree), tree_leaves(specs), strict=True)]
    return tree_unflatten(tree, leaves)


def to_global(x) -> torch.Tensor:
    """A :class:`Sharded` tensor back as one tensor on its first shard's
    device, its pieces concatenated; replicas read once and partial sums
    added in shard order.  A plain tensor passes through."""
    if not isinstance(x, Sharded):
        return x
    if x.mesh.is_representative:
        raise ValueError("a representative mesh holds one card's shard only")
    if x.partial:
        x = reshard(x, x.dims)
    device = x.shards.flat[0].device
    mesh = x.mesh
    used = {a for d in x.dims for a in d}
    rep = [mesh.axis_names.index(a) for a in mesh.axis_names if a not in used]
    out = torch.empty(x.shape, dtype=x.dtype, device=device)
    for c in x.cells():
        if any(c[k] for k in rep):
            continue                      # a replica: its first copy is read
        view = out
        for d, axes in enumerate(x.dims):
            if axes:
                m = x.shape[d] // _extent(mesh, axes)
                view = view.narrow(d, shard_index(mesh, c, axes) * m, m)
        view.copy_(x.shards[c])
    return out


def smap(fn, *args, dims=None, n_out: int | None = None, cell=False):
    """``fn`` run on every shard's local tensors (each :class:`Sharded`
    argument replaced by its shard's; others passed as they are; with
    ``cell``, the shard's index into the mesh first).  The output(s), a
    tensor or a tuple of ``n_out``, come back as :class:`Sharded` in
    layout ``dims`` (one tuple of axes a dim, or a list of those for
    ``n_out``; default the first :class:`Sharded` argument of the
    output's rank), their global shapes read off the local ones.  With no
    :class:`Sharded` argument it is ``fn(*args)`` (``fn(None, *args)`` with
    ``cell``): one code path serves the plain layers and the sharded
    ones."""
    first = next((a for a in args if isinstance(a, Sharded)), None)
    if first is None:
        return fn(None, *args) if cell else fn(*args)
    mesh = first.mesh
    outs = None
    for c in np.ndindex(first.shards.shape):
        with cell_scope(c):
            locs = [a.shards[c] if isinstance(a, Sharded) else a for a in args]
            for a in args:
                if isinstance(a, Sharded):
                    claim(a.shards[c], c)
            r = fn(c, *locs) if cell else fn(*locs)
        rs = r if n_out is not None else (r,)
        if outs is None:
            outs = [np.empty(first.shards.shape, dtype=object) for _ in rs]
        for o, t in zip(outs, rs):
            o[c] = t
    all_dims = dims if n_out is not None else [dims]
    if all_dims is None:
        all_dims = [None] * len(outs)
    res = []
    for o, dd in zip(outs, all_dims):
        if dd is None:                   # the layout of an argument of the output's rank
            dd = next((a.dims for a in args if isinstance(a, Sharded)
                       and a.ndim == o.flat[0].ndim), None)
            if dd is None:
                raise ValueError("smap: name the output's layout (dims=)")
        dd = tuple(tuple(d) for d in dd)
        loc = o.flat[0].shape
        shape = tuple(n * _extent(mesh, dd[i]) if i < len(dd) else n
                      for i, n in enumerate(loc))
        dd = dd + ((),) * (len(loc) - len(dd))
        res.append(Sharded(mesh, dd, o, shape))
    return tuple(res) if n_out is not None else res[0]


def offset(x: Sharded, dim: int, cell) -> int:
    """Where shard ``cell``'s piece of dim ``dim`` starts in the global
    tensor (0 for a plain tensor, ``cell=None``)."""
    if cell is None or not x.dims[dim]:
        return 0
    m = x.shards.flat[0].shape[dim]
    return shard_index(x.mesh, cell, x.dims[dim]) * m


def transpose(x):
    """A 2-d tensor's transpose, shard by shard."""
    return smap(lambda t: t.T, x, dims=None if not isinstance(x, Sharded) else x.dims[::-1])


def _over(x: Sharded, axis: str, fn) -> np.ndarray:
    """Run ``fn(group, n)`` on each group of shards along ``axis`` (the
    shards that differ only in their index on it, in order); the shards it
    returns take the group's places."""
    mesh = x.mesh
    k = mesh.axis_names.index(axis)
    n = mesh.shape[axis]
    arr = x.shards
    out = np.empty(arr.shape, dtype=object)
    rest = arr.shape[:k] + arr.shape[k + 1:]
    for r in np.ndindex(rest):
        cells = [r[:k] + (i,) + r[k:] for i in range(arr.shape[k])]
        for c in cells:
            claim(arr[c], c)
        got = fn([arr[c] for c in cells], n)
        for c, t in zip(cells, got):
            out[c] = t
    return out


def _dims_with(dims, d, axes):
    return tuple(axes if i == d else a for i, a in enumerate(dims))


def reshard(x: Sharded, dims) -> Sharded:
    """``x`` in layout ``dims`` (one tuple of mesh axes a dim), through the
    collectives the change needs, one axis at a time: partial sums to a
    replicated value are an all-reduce, a dim leaving an axis an
    all-gather, a dim moving from one dim to another an all-to-all, a new
    split a local slice (no bytes), and partial sums to a sharded dim a
    reduce-scatter."""
    mesh = x.mesh
    dims = tuple(tuple(a for a in d if mesh.shape[a] > 1) for d in dims)
    dims = dims + ((),) * (x.ndim - len(dims))
    where = {a: i for i, d in enumerate(dims) for a in d}
    cur = x

    def step(arr, new_dims, partial):
        return Sharded(mesh, new_dims, arr, x.shape, partial)

    # 1. partial sums that end replicated: all-reduce.
    for a in [a for a in cur.partial if a not in where]:
        arr = _over(cur, a, lambda g, n: comm.all_reduce(g, axis=a, n=n))
        cur = step(arr, cur.dims, tuple(p for p in cur.partial if p != a))
    # 2. dims leaving an axis: all-gather (innermost axis of a dim first).
    for d in range(x.ndim):
        for a in reversed(cur.dims[d]):
            if where.get(a) == d:
                continue
            if where.get(a) is not None and cur.dims[d][-1] == a and len(cur.dims[d]) == 1 \
                    and not cur.dims[where[a]]:
                continue                         # moves by an all-to-all below
            if cur.dims[d][-1] != a and not mesh.is_representative:
                raise NotImplementedError(f"gather of {a} from inside {cur.dims[d]}")
            arr = _over(cur, a, lambda g, n, d=d: comm.all_gather(g, d, axis=a, n=n))
            cur = step(arr, _dims_with(cur.dims, d, tuple(b for b in cur.dims[d] if b != a)),
                       cur.partial)
    # 3. an axis moving to another dim: all-to-all.
    for d in range(x.ndim):
        for a in list(cur.dims[d]):
            j = where.get(a)
            if j is None or j == d:
                continue
            arr = _over(cur, a, lambda g, n, d=d, j=j: comm.all_to_all(g, j, d, axis=a, n=n))
            nd = _dims_with(cur.dims, d, tuple(b for b in cur.dims[d] if b != a))
            cur = step(arr, _dims_with(nd, j, nd[j] + (a,)), cur.partial)
    # 4. new splits: each shard keeps its piece.
    for j, want in enumerate(dims):
        for a in want:
            if a in cur.dims[j] or a in cur.partial:
                continue
            new_dims = _dims_with(cur.dims, j, cur.dims[j] + (a,))
            out = np.empty(cur.shards.shape, dtype=object)
            for c in cur.cells():
                t = cur.shards[c]
                m = _local_size(mesh, t.shape[j], (a,))
                i = shard_index(mesh, c, (a,))
                with cell_scope(c):
                    out[c] = t.narrow(j, min(i * m, t.shape[j] - m), m)
            cur = step(out, new_dims, cur.partial)
    # 5. partial sums onto a sharded dim: reduce-scatter, outer axis first.
    for a in [a for d in dims for a in d if a in cur.partial]:
        j = where[a]
        if cur.dims[j] != dims[j][:len(cur.dims[j])] and not mesh.is_representative:
            raise NotImplementedError(f"reduce-scatter of {a} onto dim {j} split over "
                                      f"{cur.dims[j]}")
        arr = _over(cur, a, lambda g, n, j=j: comm.reduce_scatter(g, j, axis=a, n=n))
        cur = step(arr, _dims_with(cur.dims, j, cur.dims[j] + (a,)),
                   tuple(p for p in cur.partial if p != a))
    if mesh.is_representative:           # shapes and bytes only: the axes' order is moot
        if [sorted(d) for d in cur.dims] != [sorted(d) for d in dims]:
            raise NotImplementedError(f"reshard {x.dims} -> {dims} ended at {cur.dims}")
        return Sharded(mesh, dims, cur.shards, x.shape, cur.partial)
    if cur.dims != dims:
        raise NotImplementedError(f"reshard {x.dims} -> {dims} ended at {cur.dims}")
    return cur


def along(w, x):
    """A per-channel weight ``w`` laid out as ``x``'s last dim (its other
    dims whole), to meet the activation it acts on shard by shard; a plain
    ``w`` or ``x`` is returned as it is."""
    if not isinstance(w, Sharded) or not isinstance(x, Sharded):
        return w
    return reshard(w, ((),) * (w.ndim - 1) + x.dims[-1:])


def all_reduce_max(x: Sharded, axes) -> Sharded:
    """Each shard's ``x`` replaced by the largest over the shards along
    ``axes`` (``pmax``; no gradient)."""
    for a in axes:
        x = Sharded(x.mesh, x.dims,
                    _over(x, a, lambda g, n, a=a: comm.all_reduce(g, axis=a, n=n, op="max")),
                    x.shape)
    return x


def combine_partials(m, l, o, axes):
    """The softmax over keys split across ``axes``, from each shard's
    partial over its own keys: each row's maximum ``m`` and denominator
    ``l`` (..., 1) and its numerators ``o`` (..., D), f32, taken against
    that maximum (flash-decoding).  On a mesh the three are packed (..., 2
    + D) and merged one axis at a time
    (:func:`repro_torch.core.device_comm.softmax_combine`: an all-reduce
    max, then one all-reduce sum), after which every shard holds the whole
    softmax's partial.  Returns the numerators over the denominator, (...,
    D), laid out as ``o`` (a row that saw no key: 0); plain tensors, and
    axes of extent 1, are only normalised."""
    axes = [a for a in axes if is_sharded(o) and o.mesh.shape[a] > 1]
    if axes:
        parts = smap(lambda *z: torch.cat(z, dim=-1), m, l, o)
        for a in axes:
            arr = _over(parts, a, lambda g, n, a=a: comm.softmax_combine(g, axis=a, n=n))
            parts = Sharded(parts.mesh, parts.dims, arr, parts.shape)
        l, o = smap(lambda p: (p[..., 1:2], p[..., 2:]), parts, n_out=2)
    return smap(lambda l, o: o / l.clamp_min(1e-30), l, o)


def copy_into(dst, src):
    """Write ``src`` into ``dst`` in place, shard by shard (``src`` laid
    out as ``dst`` first); plain tensors by ``copy_``."""
    if not isinstance(dst, Sharded):
        dst.copy_(src)
        return
    if src.dims != dst.dims or src.partial:
        src = reshard(src, dst.dims)
    for c in dst.cells():
        with cell_scope(c):
            dst.shards[c].copy_(src.shards[c])


def replicas(x: Sharded) -> int:
    """How many shards hold each piece of ``x``: the extent of the mesh
    axes its layout does not use."""
    used = {a for d in x.dims for a in d}
    return int(np.prod([n for a, n in x.mesh.shape.items() if a not in used]))


def constrain(x, *axes):
    """``x`` in the layout its logical ``axes`` give under the active
    rules (the reference's ``with_sharding_constraint``), through the
    collectives :func:`reshard` makes.  A plain tensor, or any tensor
    outside a context, is returned as it is."""
    if not isinstance(x, Sharded) or _CTX.rules is None:
        return x
    return reshard(x, _dims(to_pspec(axes, _CTX.rules), x.ndim, x.mesh))


def gather_for_use(w, axes: tuple, enabled: bool = True):
    """ZeRO-3 weight gathering: ``w`` with its data (FSDP) axes stripped
    from its spec, so its shards are all-gathered before use; the model
    axis (TP / EP) is kept.  Off (``enabled=False``), outside a context or
    on a plain tensor it returns ``w``: the product then contracts against
    the sharded dim (:func:`dense`)."""
    if not enabled or not isinstance(w, Sharded) or _CTX.rules is None:
        return w
    data = {a for a in ("pod", "data") if a in w.mesh.axis_names}
    dims = tuple(tuple(a for a in d if a not in data) for d in w.dims)
    return reshard(w, dims)


def dense(x, w):
    """``x @ w`` for ``x`` (..., K) and ``w`` (K, N).  On plain tensors the
    product; on :class:`Sharded` ones, ``x`` is laid out so that its last
    dim carries ``w``'s K axes and no other dim carries an axis of ``w``
    (an all-to-all or all-gather where it must), every shard multiplies its
    pieces, and the result (..., N), its last dim on ``w``'s N axes, holds
    partial sums over the K axes."""
    if not isinstance(x, Sharded):
        return x @ w
    k_axes, n_axes = w.dims[0], w.dims[-1]
    used = set(k_axes) | set(n_axes)
    target = tuple(tuple(a for a in d if a not in used) for d in x.dims[:-1]) + (k_axes,)
    x = reshard(x, target)
    out = smap(torch.matmul, x, w, dims=target[:-1] + (n_axes,))
    out.partial = tuple(k_axes)
    return out
