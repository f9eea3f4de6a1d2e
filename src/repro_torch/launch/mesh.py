"""Device meshes for one process: an n-d grid of ``torch.device``s with
named axes (counterpart of ``repro.launch.mesh``).

The reference runs its mesh protocols single-controller: one process
drives every shard of a ``jax.sharding.Mesh``, and its tests use 8 fake
host devices on one CPU.  The port's :class:`Mesh` is the same thing in
PyTorch: one process holds the grid, a shard's tensors live on its
device, and a hop between shards is a ``.to(dest)``
(:mod:`repro_torch.core.device_comm`).  A device may repeat: ``n`` seq
shards on one card, or ``n`` "cpu" shards in the tests; a hop is then a
no-op.  A list of devices spreads the shards over several cards, where a
hop is a peer copy.

``device=None`` means the card (and raises without one); ``"cpu"`` is
for the tests.  :func:`make_production_mesh` is the H100 counterpart of
the reference's TPU pods, on the ``meta`` device: the dry run reads each
card's share of the state from it, and traces one card's program of a
sharded step on its representative form, and building it touches no
card.  A *representative* mesh (``extent`` set) holds one shard that
stands for every card: the sharded layers
(:mod:`repro_torch.model.sharding`) run that one shard's program, and
each collective is sized from its axis's extent, so tracing a 256-card
step costs what tracing one card's costs.

The roofline constants are the H100 SXM's in place of the TPU's, the
link rates (:data:`LINK_BW`) per mesh axis: a collective over ``model``
runs over NVLink inside one HGX node, one over ``data`` or ``pod`` over
the network.  The hops of a mesh of one card's shards (the seq path, a
mesh of repeated devices) cross no link: they name no axis of
:data:`LINK_BW` and the collective term stays 0.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.h100 import (  # noqa: F401 — re-exported
    HBM_BW,
    HBM_BYTES,
    LINK_BW,
    PEAK_FLOPS,
    PEAK_FLOPS_BF16,
    PEAK_FLOPS_F32,
)
from repro_torch.kernels.common import resolve_device

__all__ = ["Mesh", "make_seq_mesh", "make_debug_mesh", "make_production_mesh",
           "representative", "PRODUCTION_SHAPE", "PEAK_FLOPS_BF16", "PEAK_FLOPS_F32",
           "PEAK_FLOPS", "HBM_BW", "HBM_BYTES", "LINK_BW"]


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """``devices``: an object array of ``torch.device``s, one per shard,
    shaped like the mesh; ``axis_names``: one name per array axis.
    ``extent``: set on a representative mesh (:func:`representative`),
    whose ``devices`` hold one shard standing for a mesh of this shape."""

    devices: np.ndarray
    axis_names: tuple[str, ...]
    extent: tuple[int, ...] | None = None

    def __post_init__(self):
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(
                f"{self.devices.ndim}-d device grid for axes {self.axis_names}")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated axis name in {self.axis_names}")

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> number of shards along it (as ``jax.sharding.Mesh``)."""
        return dict(zip(self.axis_names, self.extent or self.devices.shape))

    @property
    def is_representative(self) -> bool:
        return self.extent is not None

    @property
    def size(self) -> int:
        """The cards the mesh stands for."""
        return int(np.prod(list(self.shape.values())))

    def device_grid(self, seq_axis: str, batch_axes=None) -> list[list[torch.device]]:
        """The devices of ``seq_axis`` for every batch group: a list of
        rows, one per index of ``batch_axes`` (``None``, a name or a tuple
        of names, row-major), each the devices along ``seq_axis`` in
        order.  Axes named by neither are replicas: index 0 is taken."""
        if not batch_axes:
            batch_axes = ()
        elif isinstance(batch_axes, str):
            batch_axes = (batch_axes,)
        order = [self.axis_names.index(a) for a in (*batch_axes, seq_axis)]
        rest = [i for i in range(self.devices.ndim) if i not in order]
        grid = np.transpose(self.devices, order + rest)
        grid = grid[(slice(None),) * len(order) + (0,) * len(rest)]
        return [list(row) for row in grid.reshape(-1, grid.shape[-1])]


def _grid(shape: tuple[int, ...], device) -> np.ndarray:
    """An object array of ``shape``: every shard on ``device``, or, for a
    list of devices, shard i (row-major) on ``device[i % len(device)]``."""
    n = int(np.prod(shape))
    devs = list(device) if isinstance(device, (list, tuple)) else [device]
    if not devs:
        raise ValueError("an empty list of devices")
    devs = [resolve_device(d) for d in devs]
    flat = np.empty(n, dtype=object)
    for i in range(n):
        flat[i] = devs[i % len(devs)]
    return flat.reshape(shape)


def make_seq_mesh(n: int, axis: str = "seq", device=None) -> Mesh:
    """A 1-D mesh of ``n`` shards for sequence-parallel runs."""
    if n < 1:
        raise ValueError(f"a mesh needs at least one shard, got {n}")
    return Mesh(_grid((n,), device), (axis,))


def make_debug_mesh(data: int = 1, model: int = 1, device=None) -> Mesh:
    """A (data, model) mesh, the reference's test mesh."""
    if data < 1 or model < 1:
        raise ValueError(f"a mesh needs at least one shard per axis, got {(data, model)}")
    return Mesh(_grid((data, model), device), ("data", "model"))


#: The production meshes' shapes by axis: 256 cards as (data=32,
#: model=8), 512 as (pod=2, data=32, model=8).
PRODUCTION_SHAPE = {False: {"data": 32, "model": 8},
                    True: {"pod": 2, "data": 32, "model": 8}}


def representative(mesh: Mesh) -> Mesh:
    """``mesh`` as one representative shard on its first device: the
    sharded layers run one card's program and size every collective from
    the axis's extent (the dry run's production meshes)."""
    one = np.empty((1,) * mesh.devices.ndim, dtype=object)
    one.flat[0] = mesh.devices.flat[0]
    return Mesh(one, mesh.axis_names, tuple(mesh.shape.values()))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The H100 production mesh, the counterpart of the reference's TPU v5e
    pods ((data=16, model=16) and (pod=2, data=16, model=16)), with its axis
    names: 256 cards as (data=32, model=8), or 512 as (pod=2, data=32,
    model=8).

    The ``model`` axis carries tensor- and expert-parallel traffic in every
    layer, so it is 8 wide: one HGX H100 node, whose eight cards share an
    NVLink domain (NVLink 4 through NVSwitch, 900 GB/s a card in both
    directions together).  ``data`` (FSDP /
    ZeRO and the batch) crosses nodes over the network, once per step for
    the gradients, and ``pod`` is the slower link between two such
    clusters, which gradient compression targets.

    Every shard is on the ``meta`` device: the mesh carries the shape and
    axis names the spec trees are read against, and touches no card."""
    shape = PRODUCTION_SHAPE[multi_pod]
    return Mesh(_grid(tuple(shape.values()), "meta"), tuple(shape))
