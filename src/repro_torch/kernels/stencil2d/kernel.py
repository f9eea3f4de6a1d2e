"""5-point stencil: the CUDA kernel ``csrc/stencil2d.cu`` and its plain
version :func:`~repro_torch.kernels.stencil2d.ref.stencil2d_ref`.

Counterpart of ``repro.kernels.stencil2d.kernel.stencil2d_pallas``.  The
Pallas kernel walks blocks of ``block_h`` rows with the neighbouring
blocks' halo rows in VMEM; the CUDA kernel gives each warp a 32-column
strip, takes column neighbours by warp shuffles and walks rows in
registers, with its own row tile (see the note at the top of the source).
It takes any H and W and needs no ``block_h``; a ``block_h`` that is given
is checked as the reference checks it (``H % block_h == 0``), so a call
that the reference refuses is refused here too.

The rows a thread walks come from :func:`plan_stencil` (pure Python): the
most of :data:`ROW_TILES` whose grid still reaches the SMs.  Every plan
computes each output the same way, so the outputs are bit-equal across
plans.

:func:`stencil2d_cuda` launches the kernel on CUDA tensors (counted in
``stencil2d_cuda.launches``) or raises; CPU tensors take the plain version.
:func:`launch_plan` launches a given plan without counting it.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.lowering import LaunchCost, kernel_scope, record_launch
from repro_torch.kernels.common import (
    DTYPE_CODE,
    H100_SMS,
    KernelLaunch,
    check_kernel_tensors,
    launch_stream,
    load_library,
    register_launch_spec,
    sm_count,
)
from repro_torch.kernels.stencil2d.ref import stencil2d_ref

__all__ = ["ROW_TILES", "STRIP_COLS", "THREADS", "plan_stencil", "stencil_grid",
           "launch_plan", "stencil2d_cuda", "stencil2d_ref", "stencil_cost", "stencil2d_meta"]

#: The rows a thread may walk, most first (the source's instantiations).
ROW_TILES = (16, 8, 4, 2, 1)
#: Columns of a block (8 warps of 32-column strips) and its threads.
STRIP_COLS, THREADS = 256, 256
#: The share of the SMs a plan's blocks must reach.
FILL = 0.9
#: The grid's y at most.
_MAX_GRID_Y = 65535


def stencil_grid(h: int, w: int, rows: int) -> tuple[int, int, int]:
    """The grid of a launch at ``rows`` rows a thread: a block a 256-column
    stretch of ``rows`` rows."""
    return -(-w // STRIP_COLS), -(-h // rows), 1


def plan_stencil(h: int, w: int, dtype: torch.dtype, sms: int) -> int:
    """The rows a thread walks (one of :data:`ROW_TILES`) for an (h, w) grid
    of ``dtype`` on a card of ``sms`` SMs: the most whose blocks reach
    :data:`FILL` of the SMs, else the fewest.  More rows a thread share the
    two halo rows of its strip among more outputs; fewer rows give more
    blocks: at the suite's 256 x 512, 16 rows made 32 blocks on 132 SMs, 4
    rows make 128.  On the H100 (PERF.md, row 13) 4 rows ran 2.91-3.09 us
    there, 2 rows 2.98-3.14 and 16 rows 3.74-3.91.  At 8192 x 8192 every
    tile covers the SMs and 16 rows stay."""
    if dtype not in DTYPE_CODE:
        raise ValueError(f"plan_stencil: dtype {dtype} not supported (float32, bfloat16)")
    if min(h, w, sms) < 1:
        raise ValueError(f"plan_stencil: h={h} w={w} sms={sms} must be >= 1")
    fits = [r for r in ROW_TILES if stencil_grid(h, w, r)[1] <= _MAX_GRID_Y]
    if not fits:
        raise ValueError(f"plan_stencil: H={h} needs more than {_MAX_GRID_Y} row tiles")
    return next((r for r in fits if math.prod(stencil_grid(h, w, r)) >= FILL * sms), fits[-1])


def _check(name, x, coeffs, block_h):
    h, w = x.shape
    if block_h is not None and (block_h < 1 or h % block_h):
        raise ValueError(f"H={h} not divisible by block_h={block_h}")
    if tuple(coeffs.shape) != (5,):
        raise ValueError(f"{name}: coeffs shape {tuple(coeffs.shape)} must be (5,)")


def _launch(name, x, coeffs, boundary, rows=None):
    """Check the inputs and launch at ``rows`` rows a thread, or
    :func:`plan_stencil`'s choice."""
    h, w = x.shape
    if rows is not None and rows not in ROW_TILES:
        raise ValueError(f"{name}: rows={rows} not in {ROW_TILES}")
    c32 = coeffs.to(torch.float32).contiguous()
    check_kernel_tensors(name, x=x, coeffs=c32)
    if x.dtype not in DTYPE_CODE:
        raise ValueError(f"{name}: x {x.dtype} must be one of float32, bfloat16")
    if rows is None:
        rows = plan_stencil(h, w, x.dtype, sm_count(x.device))
    out = torch.empty_like(x)
    fn = load_library("stencil2d").stencil2d_fwd
    err = fn(x.data_ptr(), c32.data_ptr(), out.data_ptr(), h, w, float(boundary),
             DTYPE_CODE[x.dtype], rows, launch_stream(x.device))
    if err:
        raise RuntimeError(f"stencil2d_fwd launch failed: cudaError {err}")
    return out


def launch_plan(x: torch.Tensor, coeffs: torch.Tensor, *, rows: int,
                boundary: float = 0.0) -> torch.Tensor:
    """Launch the kernel on CUDA tensors at ``rows`` rows a thread (one of
    :data:`ROW_TILES`); counts no launch.  :func:`stencil2d_cuda` launches
    :func:`plan_stencil`'s choice; the card tests and ``chip_smoke.py``
    compare and time the others."""
    _check("launch_plan", x, coeffs, None)
    return _launch("launch_plan", x, coeffs, boundary, rows)


def stencil2d_cuda(x: torch.Tensor, coeffs: torch.Tensor, *, block_h: int | None = None,
                   boundary: float = 0.0) -> torch.Tensor:
    """x: (H, W) f32 or bf16 (H % block_h == 0 where ``block_h`` is
    given); coeffs: (5,) on x's device (cast to f32, as the reference casts
    them).  Returns (H, W) in x.dtype, computed in f32.  CPU tensors take
    the plain version."""
    _check("stencil2d_cuda", x, coeffs, block_h)
    if x.device.type == "cpu":
        return stencil2d_ref(x, coeffs, boundary)
    out = _launch("stencil2d_cuda", x, coeffs, boundary)
    stencil2d_cuda.launches += 1
    return out


stencil2d_cuda.launches = 0


def stencil_cost(h: int, w: int, dtype: torch.dtype) -> LaunchCost:
    """One launch, as PERF.md's row 13 bounds it: x read and out written in
    their dtype, the five f32 coefficients read; 9 f32 operations a point."""
    return LaunchCost.of(9 * h * w, "f32", 2 * h * w * dtype.itemsize + 5 * 4)


def stencil2d_meta(x: torch.Tensor, coeffs: torch.Tensor, *, block_h: int | None = None,
                   boundary: float = 0.0) -> torch.Tensor:
    """:func:`stencil2d_cuda` on meta tensors: the same checks and plan, an
    empty output, and the launch recorded."""
    _check("stencil2d_cuda", x, coeffs, block_h)
    h, w = x.shape
    c32 = coeffs.to(torch.float32).contiguous()
    check_kernel_tensors("stencil2d_cuda", device_type="meta", x=x, coeffs=c32)
    if x.dtype not in DTYPE_CODE:
        raise ValueError(f"stencil2d_cuda: x {x.dtype} must be one of float32, bfloat16")
    rows = plan_stencil(h, w, x.dtype, H100_SMS)
    with kernel_scope():
        out = torch.empty_like(x)
    record_launch("stencil2d_cuda", stencil_cost(h, w, x.dtype), plan=(("rows", rows),))
    return out


# --------------------------------------------------------------------------
# Launch declarations (``repro_torch.analysis.resources``)
# --------------------------------------------------------------------------

#: The grids the paper demo runs: the Rodinia suite's hotspot and SRAD grid,
#: and the large one phase 4 times.
DEMO_GRIDS = ((256, 512, "rodinia hotspot/SRAD"), (8192, 8192, "large"))


def _spec(cfg, sms):
    """The paper demo's stencils, whatever the arch (f32)."""
    f32 = torch.float32
    out = []
    for h, w, what in DEMO_GRIDS:
        rows = plan_stencil(h, w, f32, sms)
        out.append(KernelLaunch(
            kernel="stencil2d_cuda",
            location="src/repro_torch/kernels/stencil2d/csrc/stencil2d.cu:launch_rows",
            shape=f"{what} {h}x{w} f32", grid=stencil_grid(h, w, rows), threads=THREADS,
            dynamic_smem=0, static_smem=0, library="stencil2d",
            occupancy=(0, DTYPE_CODE[f32], rows), meta=(("h", h), ("w", w), ("rows", rows))))
    return out


register_launch_spec("stencil2d_cuda", _spec, every_arch=True)
