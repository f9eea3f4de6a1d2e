"""The card checks of the paper-demo kernels and the WKV segment-summary
kernels, shared by ``chip_smoke.py`` and ``tests/test_torch_cuda.py``: the
shapes both run and the tolerances both hold the kernels to against their
plain versions."""

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


#: (B, T, chunk, full T, start) of the segment-summary checks: the kernels
#: read tokens start..start+T of (B, 32, full T, 64) tensors in place.  The
#: training path's B=4, T=256 at chunk 16 (contiguous); a shard of each call
#: of the main path on a seq mesh of 4: the prefill's (tokens 2048..3072 of
#: a 4096-token prompt at B=1), generate's (1536..2048 of 2048 at B=2) and
#: the loss gradient's (512..1024 of 2048 at B=1); an odd shard (T=100 at
#: chunk 10, tokens 100..200 of 300).  The training summary's s_hist feeds
#: the backward kernel at each case, on the same windows.
SUMMARY_CASES = (
    (4, 256, 16, 256, 0),
    (1, 1024, 16, 4096, 2048),
    (2, 512, 16, 2048, 1536),
    (1, 512, 16, 2048, 512),
    (2, 100, 10, 300, 100),
)

#: a_seg against wkv_segment_decay, per element: |got - plain| <=
#: A_SEG_ATOL + A_SEG_RTOL * |plain|.  The kernel multiplies one exp per
#: chunk (the Pallas order), the plain version takes one exp of the whole
#: sum.  For a result above the f32 normal range's floor the summed |log w|
#: is at most 87, so the two sums differ by at most 87 * 26 * 2**-24 in the
#: exponent and 64 products add 64 ulps: 1.4e-4 relative, stated as 2e-4.
#: Below the floor (2**-126) both underflow through the denormals, where
#: no relative precision is kept: the absolute floor.
A_SEG_RTOL = 2e-4
A_SEG_ATOL = 2.0 ** -126


def a_seg_ratio(got: torch.Tensor, want: torch.Tensor) -> float:
    """Worst |got - plain| / (A_SEG_ATOL + A_SEG_RTOL |plain|) over the
    elements of a_seg; the check passes at <= 1."""
    err = (got.double() - want.double()).abs()
    return float((err / (A_SEG_ATOL + A_SEG_RTOL * want.double().abs())).max())
