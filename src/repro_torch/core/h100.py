"""The NVIDIA H100 SXM5 (80 GB HBM3) figures that the kernels' planners,
their cost functions and the roofline terms use: the one place they live.
``repro_torch.kernels.common`` re-exports the SM and shared-memory figures,
``repro_torch.launch.mesh`` the peaks and the memory.

The rates are from NVIDIA's H100 Tensor Core GPU datasheet (SXM column):
the dense BF16 tensor-core rate (the 1979 TFLOP/s of the datasheet is with
sparsity), FP32 on the CUDA cores (the port keeps TF32 off, so f32 products
run here), and the HBM3 bandwidth.
"""

from __future__ import annotations

__all__ = ["H100_SMS", "SMEM_LIMIT", "SMEM_PER_SM", "SMEM_RESERVED", "PEAK_FLOPS_BF16",
           "PEAK_FLOPS_F32", "PEAK_FLOPS", "HBM_BW", "HBM_BYTES"]

#: The SMs of the card the planners plan for (H100 SXM).
H100_SMS = 132
#: Dynamic shared memory one block may opt in to on the H100 (227 KB), the
#: shared memory of an SM, and what the card reserves of it for each
#: resident block: 232448 + 1024 = 233472, so a block at the limit still
#: lands one block an SM.
SMEM_LIMIT = 232448
SMEM_PER_SM = 233472
SMEM_RESERVED = 1024

PEAK_FLOPS_BF16 = 989e12        # FLOP/s
PEAK_FLOPS_F32 = 67e12          # FLOP/s
#: Peak by flop class (``repro_torch.core.lowering.flop_class``).
PEAK_FLOPS = {"bf16": PEAK_FLOPS_BF16, "f32": PEAK_FLOPS_F32}
HBM_BW = 3.35e12                # B/s
#: The card's memory, 80 GiB (the "80GB" of its name).
HBM_BYTES = 80 * 2**30
