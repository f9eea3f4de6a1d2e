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
:func:`remat_context`, which a recomputed period runs under, and the spec
half of the reference's sharding: :class:`PartitionSpec` (``P``),
:func:`to_pspec` and :func:`spec_mk`, the ``mk`` constructor that turns
the parameter init functions into spec trees (``model.param_pspecs``).  The
specs are data: the dry run reads each card's share of the state from
them.  ``constrain`` and ``gather_for_use`` (GSPMD placement hints for the
dense layers) wait for a sharded tensor type: here the rest of a block
runs unsharded on the device of its input.

One rule differs: under ``prefill_seq`` the reference maps ``seq`` to the
``model`` axis, so a mesh without one (``make_seq_mesh``'s 1-D ``seq``
mesh) is left unsharded.  Here such a mesh maps ``seq`` to its own
``seq`` axis, so that one card can run the protocol over a mesh of
repeated devices.  A mesh with a ``model`` axis gets the reference's
rules.
"""

from __future__ import annotations

import contextlib
import threading

__all__ = ["make_rules", "sharding_context", "axes_size", "seq_shard_info",
           "remat_context", "PartitionSpec", "P", "to_pspec", "spec_mk"]


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
