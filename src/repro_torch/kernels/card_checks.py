"""The card checks of the paper-demo kernels, shared by ``chip_smoke.py``
and ``tests/test_torch_cuda.py``: the shapes both run and the tolerances
both hold the kernels to against their plain versions."""

from __future__ import annotations

import torch

#: f32 matmul: max |got - plain| <= MATMUL_F32_RTOL * max |plain|.  The same
#: f32 products summed in another order than cuBLAS's; the card measures
#: 5.8e-7 at 256^3 and 0 at (512, 256) x (256, 384) and 4096^3, so 5e-6
#: leaves a margin of about 8.
MATMUL_F32_RTOL = 5e-6

#: (H, W, coeffs, boundary) of the stencil checks: the suite's grid with its
#: hotspot and SRAD coefficients, a boundary constant, an odd shape, 8192^2.
STENCIL_CASES = (
    (256, 512, (0.6, 0.1, 0.1, 0.1, 0.1), 0.0),
    (256, 512, (1.0, -0.25, -0.25, -0.25, -0.25), 0.0),
    (64, 128, (0.0, 1.0, 1.0, 1.0, 1.0), 5.0),
    (257, 383, (0.3, -0.7, 1.1, 0.25, -2.0), -1.5),
    (8192, 8192, (0.6, 0.1, 0.1, 0.1, 0.1), 0.0),
)

#: (M, K, N, block_m, block_n, block_k) of the matmul checks: the suite's
#: 256^3, one of the reference test's cases, 4096^3.
MATMUL_CASES = (
    (256, 256, 256, 256, 256, 256),
    (512, 256, 384, 256, 128, 128),
    (4096, 4096, 4096, 256, 256, 256),
)


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp of each element of ``x`` (2**(e - 8) for |x| in
    [2**(e-1), 2**e))."""
    _, e = torch.frexp(x.float())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def matmul_error(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float, float]:
    """(max abs error, the f32 tolerance, worst error / tolerance over the
    elements; the check passes at <= 1).  f32 is held to MATMUL_F32_RTOL of
    max|plain|; bf16 to one bf16 ulp of each plain element beyond that (the
    two f32 sums round to bf16 at most one ulp apart)."""
    err = (got.float() - want.float()).abs()
    f32_tol = MATMUL_F32_RTOL * float(want.float().abs().max())
    tol = f32_tol if got.dtype == torch.float32 else bf16_ulp(want) + f32_tol
    return float(err.max()), f32_tol, float((err / tol).max())
