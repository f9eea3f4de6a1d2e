"""Differentiable elevator scan: the forward kernels and the backward kernel
paired in one ``torch.autograd.Function`` (counterpart of the reference's
``elevator_decode_diff`` for the window, and of JAX's derivative of the
chunked scan, which the reference leaves to autodiff of its jnp path).

* **forward**: the chunked scan, or for a stateful window of at most
  :data:`~repro_torch.kernels.elevator_scan.decode.ELEVATOR_DECODE_WINDOW_MAX`
  tokens (``decode=True``) the decode-window kernel, on detached contiguous
  primals.  Saves a, h0 and the states h, the forward's own output: the
  model scans f32 inputs, and the Function takes only those (f64 too on
  the CPU, for gradcheck).
* **backward**: :func:`~repro_torch.kernels.elevator_scan.kernel.elevator_scan_bwd_cuda`,
  the closed-form reverse chain ``g[t] = dh[t] + a[t+1] g[t+1]``,
  ``da[t] = g[t] h[t-1]``, ``dx = g``, ``dh0 = a[0] g[0]``.

CPU tensors run the same structure through the plain versions; on CUDA
tensors the kernels launch or raise; meta tensors take the kernels' meta
twins.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.common import by_device
from repro_torch.kernels.elevator_scan.decode import (
    ELEVATOR_DECODE_WINDOW_MAX,
    elevator_decode_window_cuda,
    elevator_decode_window_meta,
)
from repro_torch.kernels.elevator_scan.kernel import (
    elevator_scan_bwd_cuda,
    elevator_scan_bwd_meta,
    elevator_scan_cuda,
    elevator_scan_meta,
)

__all__ = ["ElevatorScanFunction"]


def _scan(a, x, h0, window: bool):
    # The wrappers take CPU tensors through their plain versions.
    if not window:
        return by_device(x, elevator_scan_cuda, elevator_scan_meta)(a, x, h0)
    if h0 is None:
        h0 = torch.zeros((x.shape[0], x.shape[2]), dtype=torch.float32, device=x.device)
    return by_device(x, elevator_decode_window_cuda, elevator_decode_window_meta)(a, x, h0)[0]


class ElevatorScanFunction(torch.autograd.Function):
    """``ElevatorScanFunction.apply(a, x, h0, decode) -> h``: a, x (B, T, D)
    f32 (or f64 on the CPU), h0 (B, D) f32 or None; h in x.dtype.
    ``decode`` takes the window kernel for T <= 64, as
    :func:`~repro_torch.kernels.elevator_scan.ops.elevator_scan`."""

    @staticmethod
    def forward(ctx, a, x, h0, decode):
        if x.dtype not in (torch.float32, torch.float64) or a.dtype != x.dtype:
            raise ValueError(f"ElevatorScanFunction: a {a.dtype} and x {x.dtype} must be "
                             "float32 under grad (the model scans f32 inputs)")
        a, x = a.detach().contiguous(), x.detach().contiguous()
        h0 = None if h0 is None else h0.detach().contiguous()
        window = bool(decode) and x.shape[1] <= ELEVATOR_DECODE_WINDOW_MAX
        h = _scan(a, x, h0, window)
        ctx.save_for_backward(a, h0, h)
        return h

    @staticmethod
    def backward(ctx, dh):
        # h is this node's output: detached, as the kernel wrappers take no
        # autograd.
        a, h0, h = (None if t is None else t.detach() for t in ctx.saved_tensors)
        bwd = by_device(a, elevator_scan_bwd_cuda, elevator_scan_bwd_meta)
        da, dx, dh0 = bwd(a, h, dh.contiguous(), h0)
        return da, dx, dh0 if ctx.needs_input_grad[2] else None, None
