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

Outside a counting context :func:`record_launch` does nothing, so a meta
trace without one still runs.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.core.h100 import HBM_BW, PEAK_FLOPS

__all__ = ["LaunchCost", "CostCounter", "cost_counting", "kernel_scope", "record_launch",
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


@dataclasses.dataclass
class KernelTally:
    launches: int = 0
    flops: dict = dataclasses.field(default_factory=lambda: dict.fromkeys(FLOP_CLASSES, 0.0))
    bytes: int = 0
    plans: dict = dataclasses.field(default_factory=dict)


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
        self._known: dict[int, int] = {}
        self._paused = 0

    # -- kernels -------------------------------------------------------------
    def record(self, name: str, cost: LaunchCost, plan=None) -> None:
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

    # -- live storages ---------------------------------------------------------
    def _free(self, key: int, nbytes: int) -> None:
        if self._known.pop(key, None) is not None:
            self.live -= nbytes

    def _track(self, st, created: bool) -> None:
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
        weakref.finalize(st, self._free, key, nbytes)

    def _account(self, func, out, args, kwargs) -> None:
        ins = [x for x in tree_flatten((args, kwargs))[0] if isinstance(x, torch.Tensor)]
        outs = [x for x in tree_flatten(out)[0] if isinstance(x, torch.Tensor)]
        for x in ins:
            self._track(x.untyped_storage(), created=False)
        for x in outs:
            self._track(x.untyped_storage(), created=True)
        if self._paused:
            return
        self.aten_ops += 1
        packet = func._overloadpacket
        if packet in flop_registry:
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
            cls = flop_class(outs[0].dtype) if outs else "f32"
            self.aten_flops[cls] += int(flops)
        if func.is_view or func in _NO_BYTES:
            return
        extent: dict[int, int] = {}
        for x in ins + outs:
            st = x.untyped_storage()
            n = min(x.numel() * x.element_size(), st.nbytes())
            extent[st._cdata] = max(extent.get(st._cdata, 0), n)
        self.aten_bytes += sum(extent.values())


_aten = torch.ops.aten
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


def record_launch(name: str, cost: LaunchCost, plan=None) -> None:
    """Record one launch of kernel ``name`` (a wrapper's launch counter)."""
    c = _current()
    if c is not None:
        c.record(name, cost, plan)

