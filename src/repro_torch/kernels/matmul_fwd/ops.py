"""Public op: tiled matmul with operand-forwarding reuse accounting
(counterpart of ``repro.kernels.matmul_fwd.ops``).

CUDA tensors take the CUDA kernel; CPU tensors take the plain version;
meta tensors take the kernel's meta twin (:mod:`repro_torch.core.lowering`).
The reference's ``use_kernel`` knob is not kept: the tensor's device alone
decides, as in the port's other ops.
"""

from __future__ import annotations

import torch

from repro_torch.core.cost_model import Traffic
from repro_torch.kernels.common import by_device
from repro_torch.kernels.matmul_fwd.kernel import matmul_fwd_cuda, matmul_fwd_meta


def matmul_fwd(a: torch.Tensor, b: torch.Tensor, *, block_m=256, block_n=256,
               block_k=256) -> torch.Tensor:
    """C = A @ B in a.dtype, summed in f32, under the reference's block
    contract (see :func:`matmul_fwd_cuda`)."""
    fn = by_device(a, matmul_fwd_cuda, matmul_fwd_meta)
    return fn(a, b, block_m=block_m, block_n=block_n, block_k=block_k)


def tile_traffic(m, n, k, block_m, block_n, block_k, itemsize=2) -> Traffic:
    """HBM bytes for the tiled schedule (per §3.3's reuse law).

    Naive per-element: 2·M·N·K element loads.  Tiled: each output tile
    re-streams A and B panels once per K-block.
    """
    tiles = (m // block_m) * (n // block_n)
    per_tile = (k // block_k) * (block_m * block_k + block_k * block_n)
    return Traffic(
        dram_bytes=(tiles * per_tile + m * n) * itemsize,
        fabric_bytes=(2 * m * n * k - tiles * per_tile) * itemsize,
    )
