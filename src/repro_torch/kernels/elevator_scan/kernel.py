"""Chunked elevator scan: the CUDA kernel ``csrc/elevator_scan.cu``
(``elevator_scan_fwd``) and its plain version
:func:`~repro_torch.kernels.elevator_scan.ref.elevator_scan_ref`.

Counterpart of ``repro.kernels.elevator_scan.kernel.elevator_scan_pallas``:
``h[t] = a[t] h[t-1] + x[t]`` over (B, T, D) with an f32 carry seeded by
an optional h0 (B, D).  The Pallas kernel carries h across a sequential
grid axis of chunks in VMEM and solves each chunk by Hillis-Steele
doubling.  The CUDA kernel keeps the carry in a register: a block owns
``cols`` channels of one batch row, and one warp runs each channel's
recurrence as one serial chain down all T rows, in the plain version's
order, so the two are equal bit for bit.  Producer warps keep a ring of
``stages`` stages filled ahead of the chain: by TMA, or where no tensor map
takes the layout, by plain loads (see the note at the top of the source).
:func:`plan_scan` (pure Python, cached: the wrapper asks it on every call)
picks the channel tile, the ring's depth and the mode from the shape, the
dtype, the SM count and the inputs' alignment.

:func:`elevator_scan_cuda` launches on CUDA tensors (counted in
``elevator_scan_cuda.launches``) or raises; CPU tensors take the plain
version.  :func:`launch_plan` launches a given plan without counting it.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from repro_torch.kernels.common import (
    DTYPE_CODE,
    check_kernel_tensors,
    launch_stream,
    load_library,
    sm_count,
)
from repro_torch.kernels.elevator_scan.ref import elevator_scan_ref

__all__ = ["SCAN_ROW_BYTES", "LOADER_COLS", "SCAN_ROWS", "RING_BYTES", "MAX_STAGES",
           "SCAN_MODES", "ScanPlan", "plan_scan", "scan_plans", "uses_tma", "pointer_alignment",
           "launch_plan", "elevator_scan_cuda", "elevator_scan_ref", "check_scan_args"]

#: The bytes of one row that a block of the TMA ring reads (its channels
#: times the element size), widest first: 128 or 64 (32 or 16 f32 channels,
#: 64 or 32 bf16; a lane of the chain warp takes a 4-byte word), never under
#: a pair of 32-byte sectors.
SCAN_ROW_BYTES = (128, 64)
#: The channels of a block of the loader-warp variant (the source's
#: LOADER_COLS; a lane of the chain warp takes one): 16 ran faster than 32
#: at both of RecurrentGemma's shapes on the H100 (PERF.md, §6).
LOADER_COLS = 16
#: Plan modes -> the C entry point's ``mode``: the TMA ring, the ring
#: filled by loader warps (any layout).
SCAN_MODES = {"ring": 0, "loaders": 1}
#: Rows of one ring stage by mode (the source's RING_ROWS and LOADER_ROWS):
#: long TMA tiles; more chunks for the loader warps to take in turn.
SCAN_ROWS = {"ring": 128, "loaders": 64}
#: The ring's bytes a block aims for (a and x tiles of all its stages).
RING_BYTES = 64 * 1024
#: The ring's depth at most (the source's MAX_STAGES).
MAX_STAGES = 8


@dataclass(frozen=True)
class ScanPlan:
    """One launch of the scan kernel: ``cols`` channels a block, a ring of
    ``stages`` stages (of ``SCAN_ROWS[mode]`` rows), and the mode (a key of
    :data:`SCAN_MODES`)."""

    cols: int
    stages: int
    mode: str


def pointer_alignment(*tensors) -> int:
    """The largest power of two, at most 16, that divides every tensor's
    address."""
    align = 16
    for t in tensors:
        while t.data_ptr() % align:
            align //= 2
    return align


def uses_tma(d: int, dtype: torch.dtype, align: int = 16) -> bool:
    """Whether a (B, T, d) layout takes the TMA ring: a row of d elements
    a multiple of 16 bytes (a tensor map's stride) and 16-byte aligned
    addresses; else the loader-warp variant runs."""
    return (d * dtype.itemsize) % 16 == 0 and align >= 16


def _check_dtype(name, dtype):
    if dtype not in DTYPE_CODE:
        raise ValueError(f"{name}: dtype {dtype} not supported (float32, bfloat16)")
    return dtype.itemsize


def _stages(cols: int, mode: str, item: int, t: int) -> int:
    """The ring's depth: :data:`RING_BYTES` over a stage's a and x tiles,
    2 to :data:`MAX_STAGES`, and no more stages than T has chunks."""
    rows = SCAN_ROWS[mode]
    depth = max(2, min(MAX_STAGES, RING_BYTES // (2 * rows * cols * item)))
    return min(depth, -(-t // rows))


def _tiles(item: int) -> list[int]:
    """The TMA ring's channel tiles, widest first."""
    return [nb // item for nb in SCAN_ROW_BYTES]


@functools.lru_cache(maxsize=1024)
def plan_scan(b: int, t: int, d: int, dtype: torch.dtype, sms: int,
              align: int = 16) -> ScanPlan:
    """The plan the wrapper launches for (b, t, d) inputs of ``dtype`` on a
    card of ``sms`` SMs, their addresses aligned to ``align`` bytes.

    Where :func:`uses_tma`: the TMA ring and the widest
    channel tile whose blocks (b times the tiles across d) cover the SMs,
    else the narrowest.  A block runs T rows whatever its tile, so what the
    tile trades is the bytes each block keeps in flight against the SMs the
    grid reaches: at B=1, D=2560 16 f32 channels give 160 blocks, 32 give
    80.  Else the loader-warp variant, :data:`LOADER_COLS` channels a
    block.  ``chip_smoke.py``'s phase 4 times every plan of
    :func:`scan_plans` at RecurrentGemma's two shapes beside this one."""
    item = _check_dtype("plan_scan", dtype)
    if min(b, t, d, sms) < 1:
        raise ValueError(f"plan_scan: b={b} t={t} d={d} sms={sms} must be >= 1")
    if not uses_tma(d, dtype, align):
        return ScanPlan(LOADER_COLS, _stages(LOADER_COLS, "loaders", item, t), "loaders")
    tiles = _tiles(item)
    cols = next((c for c in tiles if b * -(-d // c) >= sms), tiles[-1])
    return ScanPlan(cols, _stages(cols, "ring", item, t), "ring")


def scan_plans(b: int, t: int, d: int, dtype: torch.dtype, align: int = 16) -> list[ScanPlan]:
    """Every plan the kernel can launch for these inputs: each channel tile
    of the TMA ring where the layout takes it, and the loader-warp variant
    (the card tests and ``chip_smoke.py`` check and time them all)."""
    item = _check_dtype("scan_plans", dtype)
    tiles = _tiles(item) if uses_tma(d, dtype, align) else []
    return ([ScanPlan(cols, _stages(cols, "ring", item, t), "ring") for cols in tiles]
            + [ScanPlan(LOADER_COLS, _stages(LOADER_COLS, "loaders", item, t), "loaders")])


def check_scan_args(name, a, x, h0):
    """a and x: (B, T, D) of one dtype (f32 or bf16); h0: None or (B, D)
    f32; all on one CUDA device, contiguous, without autograd."""
    check_kernel_tensors(name, a=a, x=x, h0=h0)
    if x.dtype not in DTYPE_CODE or a.dtype != x.dtype:
        raise ValueError(f"{name}: a {a.dtype} and x {x.dtype} must be one of "
                         "float32, bfloat16")
    if a.shape != x.shape or x.ndim != 3:
        raise ValueError(f"{name}: a {tuple(a.shape)} and x {tuple(x.shape)} "
                         "must be one (B, T, D) shape")
    b, _, d = x.shape
    if h0 is not None and (h0.dtype != torch.float32 or h0.shape != (b, d)):
        raise ValueError(f"{name}: h0 must be float32 of shape {(b, d)}, got "
                         f"{h0.dtype} {tuple(h0.shape)}")


def _launch(a, x, h0, plan: ScanPlan) -> torch.Tensor:
    b, t, d = x.shape
    out = torch.empty_like(x)
    err = load_library("elevator_scan").elevator_scan_fwd(
        a.data_ptr(), x.data_ptr(), None if h0 is None else h0.data_ptr(), out.data_ptr(),
        b, t, d, DTYPE_CODE[x.dtype], plan.cols, plan.stages, SCAN_MODES[plan.mode],
        launch_stream(x.device))
    if err:
        raise RuntimeError(f"elevator_scan_fwd launch failed ({plan}): error {err}")
    return out


def launch_plan(a: torch.Tensor, x: torch.Tensor, h0: torch.Tensor | None = None, *,
                plan: ScanPlan) -> torch.Tensor:
    """Launch the scan kernel on CUDA tensors with a given plan (one of
    :func:`scan_plans`); counts no launch.  The wrapper launches
    :func:`plan_scan`'s choice; the card tests and ``chip_smoke.py``
    compare and time the others."""
    check_scan_args("launch_plan", a, x, h0)
    b, t, d = x.shape
    if plan not in scan_plans(b, t, d, x.dtype, pointer_alignment(a, x)):
        raise ValueError(f"launch_plan: {plan} is not a plan of these inputs")
    return _launch(a, x, h0, plan)


def elevator_scan_cuda(a: torch.Tensor, x: torch.Tensor,
                       h0: torch.Tensor | None = None) -> torch.Tensor:
    """The chunked scan, any T >= 1.  a, x: (B, T, D) f32 or bf16; h0:
    (B, D) f32 or None (zeros).  Returns h (B, T, D) in x.dtype.  CPU
    tensors take the plain version."""
    if x.device.type == "cpu":
        return elevator_scan_ref(a, x, h0)
    check_scan_args("elevator_scan_cuda", a, x, h0)
    b, t, d = x.shape
    plan = plan_scan(b, t, d, x.dtype, sm_count(x.device), pointer_alignment(a, x))
    out = _launch(a, x, h0, plan)
    elevator_scan_cuda.launches += 1
    return out


elevator_scan_cuda.launches = 0
