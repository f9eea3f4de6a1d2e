"""Trees of tensors: nested dicts, lists, tuples and NamedTuples with
tensor leaves (the port's stand-in for JAX pytrees).  A node class that is
not a tuple joins by naming its tensor children in ``_fields`` and
rebuilding itself with ``_replace`` (its other attributes are static, as
a JAX pytree's aux data): :class:`repro_torch.model.attention.PagedKVCache`.
A tuple class marked ``_tree_leaf`` is a leaf:
:class:`repro_torch.model.sharding.PartitionSpec`.

The order of leaves follows JAX's: dict keys sorted, sequences and
NamedTuple fields in order, ``None`` an empty subtree.  Paths join the
keys, indices and field names with ``/``, as the reference's checkpoint
keys do, so a flattened port tree lines up with a flattened JAX tree.
"""

from __future__ import annotations

from typing import Any, Callable


def _is_node(x) -> bool:
    """A NamedTuple, or a node with ``_fields`` and ``_replace``."""
    return hasattr(x, "_fields") and hasattr(x, "_replace")


def _is_leaf(x) -> bool:
    """A leaf that is a tuple: a class marked ``_tree_leaf`` (the port's
    ``PartitionSpec``)."""
    return getattr(type(x), "_tree_leaf", False)


def _rebuild(node, children):
    return node._replace(**dict(zip(node._fields, children)))


def tree_paths(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """``[(path, leaf), ...]`` in leaf order."""
    if tree is None:
        return []
    join = (lambda k: f"{prefix}/{k}") if prefix else str
    if _is_leaf(tree):
        return [(prefix, tree)]
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in tree_paths(tree[k], join(k))]
    if _is_node(tree):
        return [pl for f in tree._fields for pl in tree_paths(getattr(tree, f), join(f))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, x in enumerate(tree) for pl in tree_paths(x, join(i))]
    return [(prefix, tree)]


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_paths(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure), in leaf order; keeps the
    structure."""
    if tree is None:
        return None
    if _is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    if _is_node(tree):
        return _rebuild(tree, [tree_map(fn, getattr(tree, f), *(getattr(r, f) for r in rest))
                               for f in tree._fields])
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, x, *(r[i] for r in rest))
                          for i, x in enumerate(tree))
    return fn(tree, *rest)


def tree_unflatten(template, leaves):
    """A tree shaped like ``template`` holding ``leaves`` in leaf order."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out
