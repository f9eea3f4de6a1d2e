"""Public op: the decayed sequence scan with device dispatch (counterpart
of ``repro.kernels.elevator_scan.ops.elevator_scan``).

* CUDA tensors take the CUDA kernels; CPU tensors take the plain version.
* ``decode=True`` marks a stateful serving call: windows of at most
  :data:`~repro_torch.kernels.elevator_scan.decode.ELEVATOR_DECODE_WINDOW_MAX`
  tokens take the decode-window kernel; longer sweeps (the prompt prefill)
  take the chunked kernel.  ``decode=None`` infers ``T == 1``.
* ``h0=None`` means zeros; h comes back in x.dtype.

The reference's ``chunk`` argument sizes its Pallas tiles; the CUDA
kernels' tiles come from their plans (``kernel.py:plan_scan``,
``decode.py:plan_window``), so the port has none.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.elevator_scan.decode import (
    ELEVATOR_DECODE_WINDOW_MAX,
    elevator_decode_window_cuda,
)
from repro_torch.kernels.elevator_scan.kernel import elevator_scan_cuda
from repro_torch.kernels.elevator_scan.ref import elevator_scan_ref


def elevator_scan(a: torch.Tensor, x: torch.Tensor,
                  h0: torch.Tensor | None = None, *,
                  decode: bool | None = None) -> torch.Tensor:
    """h[b,t,d] = a[b,t,d] h[b,t-1,d] + x[b,t,d]; returns h in x.dtype."""
    if h0 is not None:
        h0 = h0.float()
    t = x.shape[1]
    if decode is None:
        decode = t == 1
    if not x.is_cuda:
        return elevator_scan_ref(a, x, h0)
    if decode and t <= ELEVATOR_DECODE_WINDOW_MAX:
        if h0 is None:
            h0 = torch.zeros((x.shape[0], x.shape[2]), dtype=torch.float32,
                             device=x.device)
        return elevator_decode_window_cuda(a, x, h0)[0]
    return elevator_scan_cuda(a, x, h0)
