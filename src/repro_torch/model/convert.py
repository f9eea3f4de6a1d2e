"""Conversion between the reference's trees (as numpy) and the port's.

The reference's params and decode state are JAX pytrees; a caller turns
them into numpy first (``jax.tree.map(np.asarray, tree)``), so this module
needs neither JAX nor the reference package:

* :func:`params_from_jax` keeps the ``{"scanned", "remainder"}`` layout and
  every key, turning each array into a tensor;
* :func:`state_from_jax` turns a decode-state tree of ``RecState``-like
  nodes (anything with ``.h`` and ``.conv``) into the port's
  :class:`~repro_torch.model.recurrent.RecState` tree;
* :func:`state_to_jax_numpy` goes back: the same tree with numpy leaves,
  whose leaves the caller can unflatten into the reference's tree.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.model.recurrent import RecState


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # numpy has no bf16 of its own: move the raw bits.
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_from_jax(tree, *, device="cpu"):
    """Reference params (numpy leaves) -> the port's param dict."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device=device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, device=device) for v in tree]
    if tree is None:
        return None
    return _tensor(tree, device)


def state_from_jax(tree, *, device="cpu"):
    """Reference decode state (``RecState`` nodes with numpy leaves) ->
    the port's decode state."""
    def node(n):
        return RecState(h=_tensor(n.h, device), conv=_tensor(n.conv, device))

    return {
        "scanned": None if tree["scanned"] is None
        else [node(n) for n in tree["scanned"]],
        "remainder": [node(n) for n in tree["remainder"]],
    }


def state_to_jax_numpy(state):
    """The port's decode state -> the same tree with numpy leaves."""
    def node(n):
        return RecState(h=_numpy(n.h), conv=_numpy(n.conv))

    return {
        "scanned": None if state["scanned"] is None
        else [node(n) for n in state["scanned"]],
        "remainder": [node(n) for n in state["remainder"]],
    }
