"""Conversion between the reference's trees (as numpy) and the port's.

The reference's params and decode state are JAX pytrees; a caller turns
them into numpy first (``jax.tree.map(np.asarray, tree)``), so this module
needs neither JAX nor the reference package:

* :func:`params_from_jax` keeps the ``{"scanned", "remainder"}`` layout and
  every key, turning each array into a tensor;
* :func:`state_from_jax` turns a decode-state tree of ``RecState``-like
  nodes (anything with ``.h`` and ``.conv``) and ``KVCache``-like nodes
  (``.k``, ``.v`` and ``.length``) into the port's
  :class:`~repro_torch.model.recurrent.RecState` and
  :class:`~repro_torch.model.attention.KVCache` tree;
* :func:`state_to_jax_numpy` goes back: the same tree with numpy leaves,
  whose leaves the caller can unflatten into the reference's tree;
* :func:`train_state_from_jax` / :func:`train_state_to_numpy` do the same
  for a train state (params, AdamW step and moments, and the
  error-feedback residual), so training can move between the frameworks
  mid-run.  The reference's ``TrainState``/``AdamWState``/
  ``ErrorFeedbackState`` have the same fields as the port's.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.model.attention import KVCache
from repro_torch.model.recurrent import RecState
from repro_torch.optim.adamw import AdamWState
from repro_torch.optim.compression import ErrorFeedbackState
from repro_torch.train.step import TrainState
from repro_torch.tree import tree_leaves, tree_map


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # numpy has no bf16 of its own: move the raw bits.
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A copy, never a view: the port updates its decode and train states
    in place, and an array that shares a CPU tensor's memory (JAX may wrap
    a numpy array without copying) would change under its reader."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().copy().view(ml_dtypes.bfloat16)
    return t.numpy().copy()


def params_from_jax(tree, *, device="cpu"):
    """Reference params (numpy leaves) -> the port's param dict."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device=device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, device=device) for v in tree]
    if tree is None:
        return None
    return _tensor(tree, device)


def _node_type(n):
    if hasattr(n, "h") and hasattr(n, "conv"):
        return RecState
    if hasattr(n, "page_table"):
        raise NotImplementedError("PagedKVCache is not ported to repro_torch yet")
    if hasattr(n, "k") and hasattr(n, "v") and hasattr(n, "length"):
        return KVCache
    raise TypeError(f"unknown decode-state node {type(n).__name__}")


def _map_state(tree, fn):
    def node(n):
        typ = _node_type(n)
        return typ(*(fn(getattr(n, f)) for f in typ._fields))

    return {
        "scanned": None if tree["scanned"] is None
        else [node(n) for n in tree["scanned"]],
        "remainder": [node(n) for n in tree["remainder"]],
    }


def state_from_jax(tree, *, device="cpu"):
    """Reference decode state (``RecState`` / ``KVCache`` nodes with numpy
    leaves) -> the port's decode state."""
    return _map_state(tree, lambda a: _tensor(a, device))


def state_to_jax_numpy(state):
    """The port's decode state -> the same tree with numpy leaves, whose
    leaves (in JAX's order) unflatten into the reference's state."""
    return _map_state(state, _numpy)


def train_state_from_jax(state, *, device="cpu"):
    """A reference train state (``.params``, ``.opt.step/.mu/.nu``,
    ``.ef`` None or with ``.residual``; numpy leaves) -> the port's
    :class:`~repro_torch.train.step.TrainState`, params requiring grad."""
    params = params_from_jax(state.params, device=device)
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    opt = AdamWState(
        step=_tensor(np.asarray(state.opt.step, np.int32), device),
        mu=params_from_jax(state.opt.mu, device=device),
        nu=params_from_jax(state.opt.nu, device=device),
    )
    ef = None if state.ef is None else ErrorFeedbackState(
        residual=params_from_jax(state.ef.residual, device=device))
    return TrainState(params=params, opt=opt, ef=ef)


def train_state_to_numpy(state):
    """The port's train state -> the same NamedTuples with numpy leaves;
    the caller rebuilds the reference's tree from their fields."""
    return tree_map(_numpy, state)

