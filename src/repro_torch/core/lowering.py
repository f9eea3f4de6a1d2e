"""Cost counting on the ``meta`` device (counterpart of
``repro.core.lowering``).

The reference lowers a step with XLA and reads ``cost_analysis()`` and
``memory_analysis()``; XLA visits a ``lax.scan`` body once, so its
``unrolled_cost_mode`` unrolls the scans of a reduced-depth model and
extrapolates.  Eager PyTorch has no rolled loop to unroll: a step traced
on ``meta`` tensors runs every layer, microbatch and prefill chunk as the
Python calls it, so :func:`cost_counting` sees the whole step once, at full
depth, with nothing allocated and nothing executed.

Inside :func:`cost_counting` a :class:`~torch.utils._python_dispatch.TorchDispatchMode`
tallies, for every aten op below autograd:

* its FLOPs, with ``torch.utils.flop_counter``'s formulas and the same
  decomposition rule as ``FlopCounterMode`` (so a run on the card under
  ``FlopCounterMode`` counts the same aten FLOPs), by class: ``"bf16"`` for
  bf16 and f16 products (the tensor cores), ``"f32"`` for the rest;
* its bytes: each distinct storage among its inputs and outputs once, at
  the largest extent the op touches of it (views move nothing).  This is the
  unfused upper bound, as the reference's CPU "bytes accessed" is;
* the live bytes by storage: a storage an op creates adds its bytes until
  its last tensor dies (views share one storage), and a storage that was
  alive before the trace leaves the count when it dies during it.  The
  peak is the counterpart of ``memory_analysis()``'s temp bytes: what the
  step needs beyond the state it was handed.

The kernels' meta branches (each ``*_meta`` twin of a CUDA wrapper) record
their launches with :func:`record_launch`: the wrapper's name (its launch
counter's), the plan its planner chose and its :class:`LaunchCost`.  Their
own output allocations count as live bytes but add no aten FLOPs or bytes
(:func:`kernel_scope`): the launch's cost is the kernel's.

Every dtype conversion (``aten._to_copy``, a ``copy_`` across dtypes) is
logged as a :class:`Conversion`, with whether it ran inside a kernel's
boundary: a meta twin's :func:`kernel_scope`, a plain version called as
the kernel's backend (:func:`plain_version`), or an autograd Function of a
``vjp.py``.  :mod:`repro_torch.analysis.dtype_flow` reads the log.

Outside a counting context :func:`record_launch` does nothing, so a meta
trace without one still runs.

A sharded step on a mesh (:mod:`repro_torch.model.sharding`) runs every
shard's program in one process.  The counter also keeps one card's share,
by shard (:attr:`CostCounter.cells`): an op run inside a
:func:`cell_scope` belongs to that shard, and an op outside one (the
backward, which autograd runs) to the shard of its first input that a
shard made; its storages, FLOPs and bytes go to the shard's tally, and
each shard's live bytes keep their own peak.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import sys
import threading
import weakref
from collections import defaultdict
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.core.h100 import HBM_BW, PEAK_FLOPS

__all__ = ["LaunchCost", "CostCounter", "CellTally", "Conversion", "cost_counting",
           "kernel_scope", "cell_scope", "cell_of", "claim", "plain_version", "record_launch",
           "flop_class"]

#: Flop classes: the tensor cores' bf16 rate, and f32 with TF32 off.
FLOP_CLASSES = ("bf16", "f32")


def flop_class(dtype: torch.dtype) -> str:
    """``"bf16"`` for bf16 and f16 operands (the tensor cores), else ``"f32"``."""
    return "bf16" if dtype in (torch.bfloat16, torch.float16) else "f32"


@dataclasses.dataclass(frozen=True)
class LaunchCost:
    """What one kernel launch costs: its FLOPs by class, the bytes its
    function must move (each input read once, each output written once: the
    "Bound" column's bytes) and ``scratch_bytes`` its launch moves beyond
    them (the matmul's split-K partial sums, written and read back)."""

    flops: tuple[tuple[str, float], ...]
    bytes: int
    scratch_bytes: int = 0

    @classmethod
    def of(cls, flops: float, flop_cls: str, nbytes: int, scratch: int = 0) -> "LaunchCost":
        return cls(((flop_cls, float(flops)),), int(nbytes), int(scratch))

    @property
    def hbm_bytes(self) -> int:
        return self.bytes + self.scratch_bytes

    def flops_by_class(self) -> dict[str, float]:
        out = dict.fromkeys(FLOP_CLASSES, 0.0)
        for c, f in self.flops:
            out[c] += f
        return out

    def bound_s(self) -> float:
        """The least time the card could take: the larger of the bytes over
        the HBM rate and the FLOPs over their class's peak."""
        ops = sum(f / PEAK_FLOPS[c] for c, f in self.flops)
        return max(self.bytes / HBM_BW, ops)

    def bound_by(self) -> str:
        ops = sum(f / PEAK_FLOPS[c] for c, f in self.flops)
        return "bytes" if self.bytes / HBM_BW >= ops else "operations"


@dataclasses.dataclass(frozen=True)
class Conversion:
    """One dtype conversion an op made: its source and destination dtypes,
    the source's shape, and whether it ran inside a kernel's boundary."""

    src: torch.dtype
    dst: torch.dtype
    shape: tuple[int, ...]
    interior: bool

    @property
    def elements(self) -> int:
        return math.prod(self.shape)


@dataclasses.dataclass
class KernelTally:
    launches: int = 0
    flops: dict = dataclasses.field(default_factory=lambda: dict.fromkeys(FLOP_CLASSES, 0.0))
    bytes: int = 0
    plans: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class CellTally:
    """One shard's (one card's) share of a trace: FLOPs by class, bytes,
    kernel launches, and the live bytes of the storages it made, with
    their peak."""

    flops: dict = dataclasses.field(default_factory=lambda: dict.fromkeys(FLOP_CLASSES, 0.0))
    bytes: int = 0
    launches: dict = dataclasses.field(default_factory=dict)
    live: int = 0
    peak_live: int = 0

    def as_dict(self) -> dict:
        return {"flops": sum(self.flops.values()), "flops_by_class": dict(self.flops),
                "bytes_accessed": self.bytes, "launches": dict(sorted(self.launches.items())),
                "peak_live_bytes": self.peak_live}


class CostCounter:
    """The tallies of one :func:`cost_counting` context (see the module
    docstring)."""

    def __init__(self):
        self.aten_flops = dict.fromkeys(FLOP_CLASSES, 0)
        self.aten_bytes = 0
        self.aten_ops = 0
        self.kernels: dict[str, KernelTally] = defaultdict(KernelTally)
        self.live = 0
        self.peak_live = 0
        self.conversions: list[Conversion] = []
        self._known: dict[int, int] = {}
        self._paused = 0
        self._plain = 0
        #: shard -> its :class:`CellTally` (sharded steps only).
        self.cells: dict = {}
        self._cell_of: dict[int, Any] = {}     # storage -> its shard (attribution)
        self._live_cell: dict[int, Any] = {}   # storage made in the trace -> its shard
        self._last_cell = None

    # -- kernels -------------------------------------------------------------
    def record(self, name: str, cost: LaunchCost, plan=None) -> None:
        cell = _CELL.cell if _CELL.cell is not None else self._last_cell
        if cell is not None:
            t = self._tally(cell)
            t.launches[name] = t.launches.get(name, 0) + 1
            for c, f in cost.flops:
                t.flops[c] += f
            t.bytes += cost.hbm_bytes
        k = self.kernels[name]
        k.launches += 1
        for c, f in cost.flops:
            k.flops[c] += f
        k.bytes += cost.hbm_bytes
        key = repr(plan)
        k.plans[key] = k.plans.get(key, 0) + 1

    def launches(self) -> dict[str, int]:
        return {n: k.launches for n, k in sorted(self.kernels.items()) if k.launches}

    # -- totals --------------------------------------------------------------
    def flops_by_class(self) -> dict[str, float]:
        out = {c: float(self.aten_flops[c]) for c in FLOP_CLASSES}
        for k in self.kernels.values():
            for c in FLOP_CLASSES:
                out[c] += k.flops[c]
        return out

    @property
    def total_flops(self) -> float:
        return sum(self.flops_by_class().values())

    @property
    def total_bytes(self) -> int:
        return self.aten_bytes + sum(k.bytes for k in self.kernels.values())

    def as_dict(self) -> dict:
        return {
            "flops": self.total_flops,
            "flops_by_class": self.flops_by_class(),
            "bytes_accessed": self.total_bytes,
            "aten_flops": {c: int(v) for c, v in self.aten_flops.items()},
            "aten_bytes": self.aten_bytes,
            "aten_ops": self.aten_ops,
            "kernel_flops": {n: dict(k.flops) for n, k in sorted(self.kernels.items())},
            "kernel_bytes": {n: k.bytes for n, k in sorted(self.kernels.items())},
            "peak_live_bytes": self.peak_live,
        }

    def _tally(self, cell) -> CellTally:
        t = self.cells.get(cell)
        if t is None:
            t = self.cells[cell] = CellTally()
        return t

    def per_card(self, cell=None) -> dict:
        """One shard's tally as a dict (default: the first shard's)."""
        if not self.cells:
            return {}
        return self._tally(min(self.cells) if cell is None else cell).as_dict()

    # -- live storages ---------------------------------------------------------
    def _free(self, key: int, nbytes: int) -> None:
        if self._known.pop(key, None) is not None:
            self.live -= nbytes
            self._cell_of.pop(key, None)
            cell = self._live_cell.pop(key, None)
            if cell is not None:
                self.cells[cell].live -= nbytes

    def _track(self, st, created: bool, cell=None) -> None:
        key = st._cdata
        if key in self._known:
            return
        nbytes = st.nbytes()
        self._known[key] = nbytes
        # A storage first seen as an input was alive before the trace: it
        # adds nothing now, and its bytes come back when it dies.
        if created:
            self.live += nbytes
            self.peak_live = max(self.peak_live, self.live)
            if cell is not None:
                self._cell_of[key] = self._live_cell[key] = cell
                t = self._tally(cell)
                t.live += nbytes
                t.peak_live = max(t.peak_live, t.live)
        weakref.finalize(st, self._free, key, nbytes)

    def _cell(self, ins):
        if _CELL.cell is not None:
            return _CELL.cell
        for x in ins:
            cell = self._cell_of.get(x.untyped_storage()._cdata)
            if cell is not None:
                return cell
        return None

    def _account(self, func, out, args, kwargs) -> None:
        ins = [x for x in tree_flatten((args, kwargs))[0] if isinstance(x, torch.Tensor)]
        outs = [x for x in tree_flatten(out)[0] if isinstance(x, torch.Tensor)]
        cell = self._cell(ins)
        if cell is not None:
            self._last_cell = cell
        for x in ins:
            self._track(x.untyped_storage(), created=False)
        for x in outs:
            self._track(x.untyped_storage(), created=True, cell=cell)
        conv = _CONVERSIONS.get(func)
        if conv is not None:
            src, dst = conv(args, out)
            if src.dtype != dst.dtype:
                self.conversions.append(Conversion(
                    src.dtype, dst.dtype, tuple(src.shape),
                    bool(self._paused or self._plain) or _in_autograd_function()))
        if self._paused:
            return
        self.aten_ops += 1
        tally = self._tally(cell) if cell is not None else None
        packet = func._overloadpacket
        if packet in flop_registry:
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
            cls = flop_class(outs[0].dtype) if outs else "f32"
            self.aten_flops[cls] += int(flops)
            if tally is not None:
                tally.flops[cls] += int(flops)
        if func.is_view or func in _NO_BYTES:
            return
        extent: dict[int, int] = {}
        for x in ins + outs:
            st = x.untyped_storage()
            n = min(x.numel() * x.element_size(), st.nbytes())
            extent[st._cdata] = max(extent.get(st._cdata, 0), n)
        self.aten_bytes += sum(extent.values())
        if tally is not None:
            tally.bytes += sum(extent.values())


_aten = torch.ops.aten
#: The ops that convert dtypes -> (args, out) -> (source, destination).
_CONVERSIONS = {
    _aten._to_copy.default: lambda args, out: (args[0], out),
    _aten.copy_.default: lambda args, out: (args[1], args[0]),
}


def _in_autograd_function() -> bool:
    """Whether the op runs inside an autograd Function's forward or
    backward: a frame up the stack holds its ``ctx``."""
    frame = sys._getframe(2)
    while frame is not None:
        if isinstance(frame.f_locals.get("ctx"), torch.autograd.function.FunctionCtx):
            return True
        frame = frame.f_back
    return False


#: Ops that move no bytes: allocations that write nothing, and aliases.
_NO_BYTES = {
    _aten.empty.memory_format, _aten.empty_strided.default, _aten.empty_like.default,
    _aten.new_empty.default, _aten.new_empty_strided.default, _aten._unsafe_view.default,
    _aten.lift_fresh.default,
}
#: The ops ``FlopCounterMode`` hands back untouched (sizes and strides).
_SKIP = {
    _aten.sym_is_contiguous.default, _aten.is_contiguous.default,
    _aten.is_contiguous.memory_format, _aten.is_strides_like_format.default,
    _aten.is_non_overlapping_and_dense.default, _aten.size.default,
    _aten.sym_size.default, _aten.stride.default, _aten.sym_stride.default,
    _aten.storage_offset.default, _aten.sym_storage_offset.default,
    _aten.numel.default, _aten.sym_numel.default, _aten.dim.default,
    torch.ops.prim.layout.default,
}


class _CountingMode(TorchDispatchMode):
    def __init__(self, counter: CostCounter):
        super().__init__()
        self.counter = counter

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _SKIP:
            return NotImplemented
        # FlopCounterMode's rule: an op with a decomposition is counted
        # through it.
        if func is not torch.ops.prim.device.default:
            with self:
                r = func.decompose(*args, **kwargs)
                if r is not NotImplemented:
                    return r
        out = func(*args, **kwargs)
        self.counter._account(func, out, args, kwargs)
        return out


class _Stack(threading.local):
    def __init__(self):
        self.counters: list[CostCounter] = []


_STACK = _Stack()


@contextlib.contextmanager
def cost_counting():
    """Count what the code inside costs: yields a :class:`CostCounter`."""
    counter = CostCounter()
    _STACK.counters.append(counter)
    try:
        with _CountingMode(counter):
            yield counter
    finally:
        _STACK.counters.pop()


def _current() -> CostCounter | None:
    return _STACK.counters[-1] if _STACK.counters else None


class _Cell(threading.local):
    cell = None


_CELL = _Cell()


@contextlib.contextmanager
def cell_scope(cell):
    """The ops inside run for shard ``cell`` (an index into a mesh's
    devices) of a sharded step; see :class:`CostCounter.cells`."""
    prev = _CELL.cell
    _CELL.cell = cell
    try:
        yield
    finally:
        _CELL.cell = prev


def claim(t: torch.Tensor, cell) -> None:
    """Name ``cell`` the shard of ``t``, a tensor made before the trace (a
    parameter's shard), so the ops that read it count for that shard."""
    c = _current()
    if c is not None:
        c._cell_of.setdefault(t.untyped_storage()._cdata, cell)


@contextlib.contextmanager
def cell_of(t: torch.Tensor):
    """The ops inside run for the shard that made ``t`` (a collective's
    output for a group member is that member's): a :func:`cell_scope` of
    ``t``'s shard under a counting context, else nothing."""
    c = _current()
    cell = c._cell_of.get(t.untyped_storage()._cdata) if c is not None else None
    if cell is None:
        yield
        return
    with cell_scope(cell):
        yield


@contextlib.contextmanager
def kernel_scope():
    """Inside a kernel's meta branch: allocations count as live bytes,
    their aten ops add no FLOPs or bytes."""
    c = _current()
    if c is not None:
        c._paused += 1
    try:
        yield
    finally:
        if c is not None:
            c._paused -= 1


def plain_version(fn):
    """Mark ``fn`` a kernel's plain version: called as the kernel's
    backend, its aten ops count as any others, and its conversions lie
    inside the kernel's boundary (the f32 accumulation is the backend's
    own)."""

    @functools.wraps(fn)
    def plain(*args, **kwargs):
        c = _current()
        if c is not None:
            c._plain += 1
        try:
            return fn(*args, **kwargs)
        finally:
            if c is not None:
                c._plain -= 1

    return plain


def record_launch(name: str, cost: LaunchCost, plan=None) -> None:
    """Record one launch of kernel ``name`` (a wrapper's launch counter)."""
    c = _current()
    if c is not None:
        c.record(name, cost, plan)

