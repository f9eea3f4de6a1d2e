"""Operand-forwarding matmul: the CUDA kernel ``csrc/matmul_fwd.cu`` and
its plain version :func:`~repro_torch.kernels.matmul_fwd.ref.matmul_ref`.

Counterpart of ``repro.kernels.matmul_fwd.kernel.matmul_fwd_pallas``.  The
wrapper applies the reference's block contract: each block is first cut to
``min(block, dim)`` and must then divide its dimension, else ``ValueError``
with the reference's message.  The CUDA kernel picks its own tiles inside
that contract: :func:`plan` chooses the variant, the output tile and a split
of K from the shape and the card's SM count, and the source launches what it
is given (see the note at the top of the source): bf16 on the tensor cores
(wgmma fed by TMA where rows are 16-byte aligned), f32 on the CUDA cores with
no TF32.  A and B must share one dtype on the card; the plain version also
takes mixed dtypes (a deliberate difference from the reference, whose body
casts both to f32).

:func:`matmul_fwd_cuda` launches the kernel on CUDA tensors (counted in
``matmul_fwd_cuda.launches``) or raises; CPU tensors take the plain version.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.common import (
    DTYPE_CODE,
    KernelLaunch,
    check_kernel_tensors,
    launch_stream,
    load_library,
    register_launch_spec,
    sm_count,
)
from repro_torch.kernels.matmul_fwd.ref import matmul_ref

__all__ = ["VARIANTS", "MAX_SPLIT", "FILL", "plan", "launch_plan", "matmul_fwd_cuda",
           "matmul_ref", "smem_bytes", "matmul_launches"]

#: variant -> (its code in the C entry point, the K extent of one k-tile,
#: the fewest k-tiles a split leaves each K range, the output tiles it is
#: compiled for, largest first).
VARIANTS = {
    # f32 on the CUDA cores, 16-byte cp.async rows (K % 4 == 0, N % 4 == 0).
    "f32": (0, 32, 1, ((128, 128), (64, 128), (64, 64), (32, 64))),
    # f32 on the CUDA cores, one element per copy.
    "f32_elem": (1, 32, 1, ((128, 128), (64, 128), (64, 64), (32, 64))),
    # bf16 wgmma fed by TMA (K % 8 == 0, N % 8 == 0: 16-byte rows).
    "wgmma": (2, 64, 4, ((128, 256), (128, 64))),
    # bf16 mma.sync with element-wise tile loads (rows TMA cannot take).
    "mma_elem": (3, 32, 1, ((128, 128),)),
}
#: The most K ranges a product is cut into (each adds an M x N f32 plane
#: to the workspace the wrapper allocates).
MAX_SPLIT = 16
#: The share of the SMs the work items should reach.
FILL = 0.9


def plan(m: int, n: int, k: int, dtype: torch.dtype, sms: int, *,
         aligned: bool = True) -> tuple[str, int, int, int]:
    """(variant, tile_m, tile_n, split_k) for an (M, K) x (K, N) product on a
    card of ``sms`` SMs; a pure function of its arguments.  ``aligned``:
    both operands start on a 16-byte boundary.

    The variant follows the dtype and whether rows are 16-byte aligned.  The
    work items should reach :data:`FILL` of the SMs.  The tile is the
    largest of the variant's whose count alone reaches it, with no split: a
    split adds a pass over the output, which costs more than a tenth of the
    SMs left idle.  Failing that, the largest tile whose count times the
    largest split K allows reaches it (a divisor of the k-tiles, at most
    :data:`MAX_SPLIT`, that leaves each K range the variant's fewest
    k-tiles), with the smallest split that does.  Where none reaches it, the
    smallest tile and the largest split.  ``repro_torch.benchmarks.
    matmul_plans`` times every plan beside this choice."""
    if dtype == torch.bfloat16:
        variant = "wgmma" if aligned and k % 8 == 0 and n % 8 == 0 else "mma_elem"
    elif dtype == torch.float32:
        variant = "f32" if aligned and k % 4 == 0 and n % 4 == 0 else "f32_elem"
    else:
        raise ValueError(f"matmul plan: dtype {dtype} is neither float32 nor bfloat16")
    _, k_step, min_kt, tiles = VARIANTS[variant]
    k_tiles = -(-k // k_step)
    splits = [d for d in range(1, min(k_tiles, MAX_SPLIT) + 1)
              if k_tiles % d == 0 and (d == 1 or k_tiles // d >= min_kt)]
    target = math.ceil(FILL * sms)
    counts = [(-(-m // tile_m) * -(-n // tile_n), tile_m, tile_n) for tile_m, tile_n in tiles]
    for count, tile_m, tile_n in counts:
        if count >= target:
            return variant, tile_m, tile_n, 1
    for count, tile_m, tile_n in counts:
        if count * splits[-1] >= target:
            return variant, tile_m, tile_n, next(d for d in splits if count * d >= target)
    return variant, *tiles[-1], splits[-1]


def matmul_fwd_cuda(a: torch.Tensor, b: torch.Tensor, *, block_m: int = 256,
                    block_n: int = 256, block_k: int = 256) -> torch.Tensor:
    """C = A @ B.  A: (M, K), B: (K, N), one dtype (f32 or bf16) on the
    card.  Returns (M, N) in a.dtype, summed in f32.  CPU tensors take the
    plain version."""
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"inner dims mismatch: {k} vs {k2}")
    # The reference's block contract: each block, cut to min(block, dim),
    # divides its dim.
    block_m, block_n, block_k = min(block_m, m), min(block_n, n), min(block_k, k)
    if m % block_m or n % block_n or k % block_k:
        raise ValueError(
            f"shape ({m},{k})x({k},{n}) not divisible by blocks "
            f"({block_m},{block_n},{block_k})")
    if a.device.type == "cpu":
        return matmul_ref(a, b)
    _check_operands(a, b)
    out = launch_plan(a, b, *plan(m, n, k, a.dtype, sm_count(a.device),
                                  aligned=_aligned(a, b)))
    matmul_fwd_cuda.launches += 1
    return out


def _aligned(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0


def _check_operands(a: torch.Tensor, b: torch.Tensor) -> None:
    check_kernel_tensors("matmul_fwd_cuda", a=a, b=b)
    if a.dtype not in DTYPE_CODE or b.dtype != a.dtype:
        raise ValueError(f"matmul_fwd_cuda: a {a.dtype} and b {b.dtype} must be one "
                         "dtype, float32 or bfloat16 (the plain version takes mixed "
                         "dtypes)")


def launch_plan(a: torch.Tensor, b: torch.Tensor, variant: str, tile_m: int, tile_n: int,
                split: int) -> torch.Tensor:
    """Launch the kernel on CUDA tensors with a given plan (one that
    :func:`plan` could return for some SM count) and return C; counts no
    launch; the operands are as :func:`matmul_fwd_cuda` checks them.
    :func:`matmul_fwd_cuda` launches :func:`plan`'s choice;
    ``repro_torch.benchmarks.matmul_plans`` times the others."""
    (m, k), n = a.shape, b.shape[1]
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    # Split K: one f32 partial plane per K range, summed in order by the
    # source's second kernel.
    ws = torch.empty((split, m, n), dtype=torch.float32, device=a.device) if split > 1 else None
    fn = load_library("matmul_fwd").matmul_fwd
    err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(),
             None if ws is None else ws.data_ptr(), m, n, k, VARIANTS[variant][0],
             tile_m, tile_n, split, sm_count(a.device), launch_stream(a.device))
    if err:
        raise RuntimeError(f"matmul_fwd launch failed: error {err} (a cudaError_t, or "
                           "10000 + the CUresult of a tensor map)")
    return out


matmul_fwd_cuda.launches = 0


# --------------------------------------------------------------------------
# Shared memory and launch declarations (``repro_torch.analysis.resources``)
# --------------------------------------------------------------------------

#: The source's constants: the f32 kernels' ring (stages, k-tile, the A
#: rows' padding, threads), the wgmma kernel's (M and K extents of a tile,
#: threads), the element-wise bf16 kernel's tiles and threads, and the
#: split-K reduction's threads.
_F_STAGES, _F_BK, _F_APAD, _F_THREADS = 3, 32, 4, 256
_WG_BM, _WG_BK, _WG_THREADS = 128, 64, 384
_E_TILE, _E_BK, _E_THREADS = 128, 32, 256
_REDUCE_THREADS = 256
_LOCATION = "src/repro_torch/kernels/matmul_fwd/csrc/matmul_fwd.cu:"


def _wg_stages(tile_n: int) -> int:
    return 4 if tile_n == 256 else 5


def smem_bytes(variant: str, tile_m: int, tile_n: int) -> int:
    """Dynamic shared memory of one block of ``variant`` at a tile of
    ``tile_m`` x ``tile_n`` (as the source's launchers pass it): the f32
    kernels' ring of three stages of A rows (padded) and B rows
    (``F32Plan::SMEM``), the wgmma kernel's ring of A and B tiles with 1024
    bytes of alignment slack (``WgPlan::SMEM``), and none for the
    element-wise bf16 kernel, whose tiles are static.  The source's
    ``matmul_smem`` returns the same."""
    if (tile_m, tile_n) not in VARIANTS[variant][3]:
        raise ValueError(f"smem_bytes: {variant} is not compiled for a {tile_m} x {tile_n} tile")
    if variant in ("f32", "f32_elem"):
        return _F_STAGES * (tile_m * (_F_BK + _F_APAD) + _F_BK * tile_n) * 4
    if variant == "wgmma":
        return _wg_stages(tile_n) * (_WG_BM * _WG_BK * 2 + _WG_BK * tile_n * 2) + 1024
    return 0


def _static_smem(variant: str, tile_n: int) -> int:
    """The kernels' ``__shared__`` bytes: the wgmma ring's barriers, the
    element-wise kernel's padded A and B tiles."""
    if variant == "wgmma":
        return 2 * _wg_stages(tile_n) * 8
    if variant == "mma_elem":
        return (_E_TILE * (_E_BK + 8) + _E_BK * (_E_TILE + 8)) * 2
    return 0


def matmul_launches(shape: str, m: int, n: int, k: int, dtype: torch.dtype,
                    sms: int) -> list[KernelLaunch]:
    """The launches of one product in :func:`plan`'s plan: the product
    kernel (the wgmma kernel's persistent grid at most one block an SM), and
    with a split of K the reduction's."""
    variant, tm, tn, split = plan(m, n, k, dtype, sms)
    code, smem = VARIANTS[variant][0], smem_bytes(variant, tm, tn)
    tiles = (-(-n // tn), -(-m // tm), split)
    grid = (min(math.prod(tiles), sms), 1, 1) if variant == "wgmma" else tiles
    threads = {"wgmma": _WG_THREADS, "mma_elem": _E_THREADS}.get(variant, _F_THREADS)
    launcher = {"wgmma": "launch_wgmma", "mma_elem": "matmul_fwd"}.get(variant, "launch_f32")
    meta = (("m", m), ("n", n), ("k", k), ("split", split))
    out = [KernelLaunch(
        kernel="matmul_fwd_cuda", location=_LOCATION + launcher, shape=shape, grid=grid,
        threads=threads, dynamic_smem=smem, static_smem=_static_smem(variant, tn),
        library="matmul_fwd", occupancy=(0, code, tm, tn),
        queries=(("matmul_smem", (code, tm, tn), smem),), meta=meta)]
    if split > 1:
        blocks = min(-(-m * n // _REDUCE_THREADS), sms * 8)
        out.append(KernelLaunch(
            kernel="matmul_fwd_cuda", location=_LOCATION + "matmul_fwd", shape=shape,
            grid=(blocks, 1, 1), threads=_REDUCE_THREADS, dynamic_smem=0, static_smem=0,
            library="matmul_fwd", occupancy=(1, DTYPE_CODE[dtype]), meta=meta))
    return out


def _spec(cfg, sms):
    """The paper demo's products, whatever the arch: the Rodinia suite's
    matrixMul (256^3 f32) and the large ones phase 4 times."""
    f32, bf = torch.float32, torch.bfloat16
    out = []
    for dim, dtype, what in ((256, f32, "rodinia matrixMul"), (4096, bf, "large"),
                             (4096, f32, "large")):
        name = "f32" if dtype == f32 else "bf16"
        out += matmul_launches(f"{what} {dim}^3 {name}", dim, dim, dim, dtype, sms)
    return out


register_launch_spec("matmul_fwd_cuda", _spec, every_arch=True)
