"""Atomic checkpoints of torch trees (counterpart of
``repro.checkpoint.checkpoint``), with the reference's layout::

    <dir>/step_<N>/manifest.json   {step, keys, shapes, dtypes, mesh_shape}
    <dir>/step_<N>/arrays.npz      the flattened tree ('/'-joined paths)
    <dir>/LATEST                   atomically replaced pointer file

* **atomicity**: a save writes ``step_<N>.tmp`` and renames it after an
  fsync of the manifest; ``LATEST`` is replaced by rename too, so a crash
  mid-save never corrupts the restore point;
* **async**: :class:`AsyncSaver` copies the tree to host memory at once and
  writes it in a background thread; a failed or stalled write is raised
  from the next ``save_async`` or ``wait``;
* **bf16**: numpy has no bfloat16, so a bf16 tensor is stored as its raw
  16 bits (uint16) with ``"bfloat16"`` in the manifest's dtypes, and
  restored bit for bit: a lossless encoding.

Keys follow :func:`repro_torch.tree.tree_paths` (sorted dict keys,
NamedTuple field names), the reference's own key scheme.

A :class:`~repro_torch.model.sharding.Sharded` leaf is saved whole (its
shards assembled, as the reference saves a sharded ``jax.Array``), and
:func:`restore` with ``shardings=`` places each leaf straight into its
layout on a mesh that may differ from the one it was saved from (the
reference's elastic restore).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any

import numpy as np
import torch

from repro_torch.ft.watchdog import make_lock
from repro_torch.model.sharding import device_put, is_sharded, to_global
from repro_torch.tree import tree_leaves, tree_map, tree_paths, tree_unflatten


def _whole(t) -> torch.Tensor:
    return torch.as_tensor(to_global(t) if is_sharded(t) else t)


def _to_numpy(t) -> tuple[np.ndarray, str]:
    """(array to store, dtype name for the manifest)."""
    t = _whole(t).detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), str(t.numpy().dtype)


def _from_numpy(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _host_copy(tree):
    return tree_map(lambda t: _whole(t).detach().to("cpu", copy=True), tree)


def save(directory: str | os.PathLike, step: int, tree: Any, *, mesh_shape=None):
    """Synchronous atomic save of a tree of tensors."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    tmp = directory / f"step_{step}.tmp"
    final = directory / f"step_{step}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()

    flat, dtypes = {}, {}
    for key, leaf in tree_paths(tree):
        flat[key], dtypes[key] = _to_numpy(leaf)
    np.savez(tmp / "arrays.npz", **flat)
    manifest = {
        "step": step,
        "keys": sorted(flat),
        "shapes": {k: list(v.shape) for k, v in flat.items()},
        "dtypes": dtypes,
        "mesh_shape": list(mesh_shape) if mesh_shape else None,
    }
    with open(tmp / "manifest.json", "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)

    latest_tmp = directory / "LATEST.tmp"
    latest_tmp.write_text(str(step))
    os.replace(latest_tmp, directory / "LATEST")
    return final


class AsyncSaverError(RuntimeError):
    """A background checkpoint write failed (surfaced on the next
    :meth:`AsyncSaver.save_async` / :meth:`AsyncSaver.wait`)."""


class AsyncSaver:
    """Background-thread checkpoint writer, one write in flight at a time.

    A failed background write is re-raised (as :class:`AsyncSaverError`)
    from the next ``save_async`` or ``wait``.  :meth:`wait` joins the
    writer with a timeout and raises if it is still running; the abandoned
    writer is fenced off by a generation counter, so its late result is
    discarded (``stale_discarded``) instead of being blamed on a later
    write.
    """

    def __init__(self, timeout_s: float = 600.0):
        self.timeout_s = timeout_s
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self._gen = 0
        self._lock = make_lock()
        self.stale_discarded = 0
        self.stalls = 0

    def _write(self, directory, step, host_tree, mesh_shape, gen):
        try:
            save(directory, step, host_tree, mesh_shape=mesh_shape)
            err = None
        except BaseException as e:  # noqa: BLE001 — re-raised at next drain
            err = e
        with self._lock:
            if gen != self._gen:        # fenced: a timed-out wait() moved on
                self.stale_discarded += 1
                return
            if err is not None:
                self._error = err

    def save_async(self, directory: str | os.PathLike, step: int, tree: Any, *,
                   mesh_shape: tuple | None = None):
        self.wait()
        # Snapshot to host memory now (the caller may update the tree in
        # place on the next step); write in the background.
        host_tree = _host_copy(tree)
        with self._lock:
            self._gen += 1
            gen = self._gen
        self._thread = threading.Thread(
            target=self._write,
            args=(directory, step, host_tree, mesh_shape, gen),
            daemon=True,
        )
        self._thread.start()

    def wait(self, timeout_s: float | None = None):
        t = self._thread
        if t is not None:
            limit = self.timeout_s if timeout_s is None else timeout_s
            t.join(limit)
            if t.is_alive():
                with self._lock:
                    self._gen += 1
                    self.stalls += 1
                self._thread = None
                raise AsyncSaverError(
                    f"background checkpoint write still running after "
                    f"{limit}s — stalled writer abandoned (its late "
                    "result will be discarded)")
            self._thread = None
        with self._lock:
            err, self._error = self._error, None
        if err is not None:
            raise AsyncSaverError("background checkpoint save failed") from err


def latest_step(directory) -> int | None:
    latest = Path(directory) / "LATEST"
    if not latest.exists():
        return None
    return int(latest.read_text().strip())


class _Box:
    """A tree leaf holding one leaf of ``shardings`` (which may be None)."""

    def __init__(self, value):
        self.value = value


def restore(directory, template: Any, *, step: int | None = None,
            shardings: Any = None):
    """Restore into the structure of ``template``: each leaf takes the
    template leaf's dtype and ``requires_grad`` (values ignored), and its
    device.  ``shardings``: a matching tree of
    :class:`~repro_torch.model.sharding.NamedSharding` (a ``None`` leaf
    keeps the template's placement) for elastic re-placement on a possibly
    different mesh: each leaf is split straight into its new layout
    (:func:`~repro_torch.model.sharding.device_put`).  Returns ``(tree,
    step)``."""
    directory = Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    path = directory / f"step_{step}"
    dtypes = json.loads((path / "manifest.json").read_text())["dtypes"]
    with np.load(path / "arrays.npz") as data:
        flat = {k: data[k] for k in data.files}
    boxes = tree_leaves(tree_map(lambda leaf, sd=None: _Box(sd), template,
                                 *(() if shardings is None else (shardings,))))
    leaves = []
    for (key, leaf), box in zip(tree_paths(template), boxes, strict=True):
        if key not in flat:
            raise KeyError(f"checkpoint missing {key}")
        t = _from_numpy(flat[key], dtypes[key])
        want = leaf.shards.flat[0] if is_sharded(leaf) else torch.as_tensor(leaf)
        if box.value is not None:
            leaves.append(device_put(t.to(want.dtype), box.value,
                                     requires_grad=want.requires_grad))
        elif is_sharded(leaf):
            leaves.append(device_put(t.to(want.dtype), leaf.sharding,
                                     requires_grad=want.requires_grad))
        else:
            leaves.append(t.to(device=want.device, dtype=want.dtype)
                          .requires_grad_(want.requires_grad))
    return tree_unflatten(template, leaves), step
