"""Von-Neumann baseline: shared-memory staging + barrier (paper Fig. 1b/2a).

Counterpart of ``repro.core.scratchpad``: the GPGPU pattern the paper
argues against.  Producers write intermediate values to a shared
scratchpad, a workgroup barrier orders the phases, and consumers read the
staged values back.  The benchmarks compare it with direct communication on
identical math.

**The barrier is a no-op here.**  The reference's ``barrier`` is
``jax.lax.optimization_barrier``: it stops XLA from fusing through the
staged value, so the "shared" variant of a kernel materializes its
intermediates where the "direct" one may be fused away.  Eager PyTorch fuses
nothing: every tensor an operation returns is already materialized in
device memory.  So :func:`barrier` returns its inputs unchanged, and adds no
copy: a copy would charge the shared variants memory traffic that the
reference does not charge.  On the card, the shared-against-direct wall
clock of the Rodinia suite is therefore eager against eager; the byte
counts of :mod:`repro_torch.core.cost_model` charge the staged buffer twice
(write + read), as the paper's energy accounting does.
"""

from __future__ import annotations

import torch

__all__ = ["stage_through_memory", "barrier", "SharedBuffer"]


def barrier(*arrays):
    """Workgroup barrier (the ``__syncthreads`` analog).  Eager PyTorch has
    already materialized every input, so the inputs come back unchanged:
    one tensor for one input, else a tuple."""
    return arrays[0] if len(arrays) == 1 else arrays


def stage_through_memory(x: torch.Tensor) -> torch.Tensor:
    """Write ``x`` to the scratchpad and read it back after a barrier."""
    return barrier(x)


class SharedBuffer:
    """A CUDA ``__shared__`` array emulation with phase tracking.

    Usage mirrors Fig. 1b: ``buf.write(values)`` then ``buf.sync()`` then
    ``buf.read(idx)``.  Reads before a sync raise, mirroring the data race
    the barrier exists to prevent.  Byte traffic is tracked for the cost
    model.
    """

    def __init__(self, values_shape, dtype=torch.float32):
        self._shape = tuple(values_shape)
        self._dtype = dtype
        self._buf = None
        self._synced = False
        self.bytes_written = 0
        self.bytes_read = 0

    def write(self, values: torch.Tensor):
        if tuple(values.shape) != self._shape:
            raise ValueError(f"shape {tuple(values.shape)} != buffer {self._shape}")
        self._buf = values.to(self._dtype)
        self._synced = False
        self.bytes_written += values.numel() * values.element_size()
        return self

    def sync(self):
        if self._buf is None:
            raise RuntimeError("sync before any write")
        self._buf = barrier(self._buf)
        self._synced = True
        return self

    def read(self, idx=None) -> torch.Tensor:
        if not self._synced:
            raise RuntimeError("shared-memory read before barrier (data race)")
        out = self._buf if idx is None else self._buf[idx]
        self.bytes_read += out.numel() * out.element_size()
        return out
