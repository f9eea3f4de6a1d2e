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
           "PEAK_FLOPS_F32", "PEAK_FLOPS", "HBM_BW", "HBM_BYTES", "NVLINK_BW", "NDR_IB_BW",
           "LINK_BW"]

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

#: What one card sends a second over a mesh axis's links, one direction
#: (a hop's bytes are what each card sends, ``device_comm.Hop``):
#: NVLink 4 gives an H100 SXM 900 GB/s in both directions together
#: (NVIDIA H100 Tensor Core GPU datasheet, "NVLink: 900GB/s"), so 450 GB/s
#: each way inside an HGX node through NVSwitch; across nodes each card has
#: one 400 Gb/s NDR InfiniBand adapter (NVIDIA DGX H100 datasheet: eight
#: ConnectX-7 400 Gb/s ports for eight cards), 50 GB/s each way.
NVLINK_BW = 450e9               # B/s, one direction
NDR_IB_BW = 400e9 / 8           # B/s, one direction
#: The production mesh's axes -> their link rate: ``model`` is one HGX
#: node's NVLink domain, ``data`` and ``pod`` cross the network.
LINK_BW = {"model": NVLINK_BW, "data": NDR_IB_BW, "pod": NDR_IB_BW}
