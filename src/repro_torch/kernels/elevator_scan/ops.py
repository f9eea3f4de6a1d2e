"""Public op: the decayed sequence scan with device dispatch (counterpart
of ``repro.kernels.elevator_scan.ops.elevator_scan``).

* CUDA tensors take the CUDA kernels; CPU tensors take the plain version;
  meta tensors take the kernels' meta twins (:mod:`repro_torch.core.lowering`).
* ``decode=True`` marks a stateful serving call: windows of at most
  :data:`~repro_torch.kernels.elevator_scan.decode.ELEVATOR_DECODE_WINDOW_MAX`
  tokens take the decode-window kernel; longer sweeps (the prompt prefill)
  take the chunked kernel.  ``decode=None`` infers ``T == 1``.
* ``h0=None`` means zeros; h comes back in x.dtype.
* Under autograd (grad enabled and a, x or h0 requiring grad) both paths
  run, on f32 inputs, through :class:`~repro_torch.kernels.elevator_scan.vjp.ElevatorScanFunction`:
  the same forward kernels and the backward kernel on the card, the plain
  versions on the CPU.

The reference's ``chunk`` argument sizes its Pallas tiles; the CUDA
kernels' tiles come from their plans (``kernel.py:plan_scan``,
``decode.py:plan_window``), so the port has none.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.common import by_device, on_kernel_device
from repro_torch.kernels.elevator_scan.decode import (
    ELEVATOR_DECODE_WINDOW_MAX,
    elevator_decode_window_cuda,
    elevator_decode_window_meta,
)
from repro_torch.kernels.elevator_scan.kernel import elevator_scan_cuda, elevator_scan_meta
from repro_torch.kernels.elevator_scan.ref import elevator_scan_ref
from repro_torch.kernels.elevator_scan.vjp import ElevatorScanFunction


def elevator_scan(a: torch.Tensor, x: torch.Tensor,
                  h0: torch.Tensor | None = None, *,
                  decode: bool | None = None) -> torch.Tensor:
    """h[b,t,d] = a[b,t,d] h[b,t-1,d] + x[b,t,d]; returns h in x.dtype."""
    if h0 is not None:
        h0 = h0.float()
    t = x.shape[1]
    if decode is None:
        decode = t == 1
    if torch.is_grad_enabled() and any(
            v is not None and v.requires_grad for v in (a, x, h0)):
        return ElevatorScanFunction.apply(a, x, h0, decode)
    if not on_kernel_device(x):
        return elevator_scan_ref(a, x, h0)
    if decode and t <= ELEVATOR_DECODE_WINDOW_MAX:
        if h0 is None:
            h0 = torch.zeros((x.shape[0], x.shape[2]), dtype=torch.float32,
                             device=x.device)
        window = by_device(x, elevator_decode_window_cuda, elevator_decode_window_meta)
        return window(a, x, h0)[0]
    return by_device(x, elevator_scan_cuda, elevator_scan_meta)(a, x, h0)
