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
:func:`elevator_scan_bwd_cuda` is the backward (``elevator_scan_bwd`` in the
same source, no Pallas counterpart): the same ring run from the last chunk
to the first, one reverse chain a channel, bit for bit its plain version
:func:`elevator_scan_bwd_ref`; :func:`plan_scan_bwd` picks its plan and
:func:`launch_bwd_plan` launches a given one without counting it.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from repro_torch.core.lowering import LaunchCost, kernel_scope, record_launch
from repro_torch.kernels.common import (
    DTYPE_CODE,
    H100_SMS,
    SERVE_BATCH,
    SERVE_PROMPT,
    KernelLaunch,
    check_kernel_tensors,
    launch_stream,
    load_library,
    pointer_alignment,
    register_launch_spec,
    scoring_shape,
    sm_count,
    train_microbatch,
)
from repro_torch.kernels.elevator_scan.ref import elevator_scan_bwd_ref, elevator_scan_ref

__all__ = ["SCAN_ROW_BYTES", "LOADER_COLS", "SCAN_ROWS", "RING_BYTES", "MAX_STAGES",
           "SCAN_MODES", "ScanPlan", "plan_scan", "scan_plans", "uses_tma", "pointer_alignment",
           "launch_plan", "elevator_scan_cuda", "elevator_scan_ref", "check_scan_args",
           "BWD_RING_BYTES", "BWD_FILL", "plan_scan_bwd", "scan_bwd_plans", "launch_bwd_plan",
           "elevator_scan_bwd_cuda", "elevator_scan_bwd_ref", "ring_stages", "scan_threads",
           "scan_smem_bytes", "scan_bwd_smem_bytes", "scan_cost", "scan_bwd_cost",
           "elevator_scan_meta", "elevator_scan_bwd_meta"]

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
#: The backward's ring bytes a block aims for (a, dh and h tiles of all its
#: stages): three tiles a stage, so more than the forward's to keep as
#: many rows in flight.
BWD_RING_BYTES = 96 * 1024
#: The loader-warp variant's producer warps (the source's LOADERS): its ring
#: is at least this deep.
_LOADERS = 3
#: The share of the SMs the backward's blocks should reach before a tile
#: narrows.  On the H100 the 32-channel tile with its two 48 KB stages was
#: the fastest plan at both of RecurrentGemma's training shapes, also where
#: its 80 blocks leave SMs idle: 79.6 µs at (1, 4096, 2560) against
#: 80.0-105.8 for 16 channels (two to four stages), 45.3 µs at (2, 1024,
#: 2560) against 51.5 (PERF.md, §6: rows B2, B2b).
BWD_FILL = 0.5


@dataclass(frozen=True)
class ScanPlan:
    """One launch of the scan kernel: ``cols`` channels a block, a ring of
    ``stages`` stages (of ``SCAN_ROWS[mode]`` rows), and the mode (a key of
    :data:`SCAN_MODES`)."""

    cols: int
    stages: int
    mode: str


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


def check_scan_args(name, a, x, h0, device_type="cuda"):
    """a and x: (B, T, D) of one dtype (f32 or bf16); h0: None or (B, D)
    f32; all on one CUDA device (the meta device for the meta twins),
    contiguous, without autograd."""
    check_kernel_tensors(name, device_type=device_type, a=a, x=x, h0=h0)
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


def _bwd_stages(cols: int, mode: str, t: int) -> int:
    """The backward ring's depth: :data:`BWD_RING_BYTES` over a stage's three
    f32 tiles, 2 to :data:`MAX_STAGES` (the loader-warp variant at least
    its three loader warps, as the source takes it), and no more stages
    than T has chunks."""
    rows = SCAN_ROWS[mode]
    depth = max(2, min(MAX_STAGES, BWD_RING_BYTES // (3 * rows * cols * 4)))
    if mode == "loaders":
        depth = max(depth, _LOADERS)
    return min(depth, -(-t // rows))


@functools.lru_cache(maxsize=1024)
def plan_scan_bwd(b: int, t: int, d: int, sms: int, align: int = 16) -> ScanPlan:
    """The plan :func:`elevator_scan_bwd_cuda` launches for f32 (b, t, d)
    inputs on a card of ``sms`` SMs, their addresses aligned to ``align``
    bytes: the TMA ring at the widest channel tile whose blocks reach
    :data:`BWD_FILL` of the SMs (32 channels at (1, 4096, 2560): 80 blocks;
    at (2, 1024, 2560): 160), else the loader-warp variant."""
    if min(b, t, d, sms) < 1:
        raise ValueError(f"plan_scan_bwd: b={b} t={t} d={d} sms={sms} must be >= 1")
    if not uses_tma(d, torch.float32, align):
        return ScanPlan(LOADER_COLS, _bwd_stages(LOADER_COLS, "loaders", t), "loaders")
    tiles = _tiles(4)
    cols = next((c for c in tiles if b * -(-d // c) >= BWD_FILL * sms), tiles[-1])
    return ScanPlan(cols, _bwd_stages(cols, "ring", t), "ring")


def scan_bwd_plans(b: int, t: int, d: int, align: int = 16) -> list[ScanPlan]:
    """Every plan the backward can launch for these f32 inputs: each channel
    tile of the TMA ring where the layout takes it, and the loader-warp
    variant."""
    tiles = _tiles(4) if uses_tma(d, torch.float32, align) else []
    return ([ScanPlan(cols, _bwd_stages(cols, "ring", t), "ring") for cols in tiles]
            + [ScanPlan(LOADER_COLS, _bwd_stages(LOADER_COLS, "loaders", t), "loaders")])


def _check_bwd_args(name, a, h, dh, h0, device_type="cuda"):
    check_scan_args(name, a, dh, h0, device_type)
    if a.dtype != torch.float32 or h.dtype != torch.float32 or h.shape != a.shape:
        raise ValueError(f"{name}: a, dh and h must be float32 of shape "
                         f"{tuple(a.shape)}, got {a.dtype}, {dh.dtype}, {h.dtype} "
                         f"{tuple(h.shape)}")
    check_kernel_tensors(name, device_type=device_type, a=a, h=h)


def _launch_bwd(a, h, dh, h0, plan: ScanPlan):
    b, t, d = a.shape
    da, dx = torch.empty_like(a), torch.empty_like(dh)
    dh0 = torch.empty((b, d), dtype=torch.float32, device=a.device)
    err = load_library("elevator_scan").elevator_scan_bwd(
        a.data_ptr(), h.data_ptr(), None if h0 is None else h0.data_ptr(), dh.data_ptr(),
        da.data_ptr(), dx.data_ptr(), dh0.data_ptr(), b, t, d, plan.cols, plan.stages,
        SCAN_MODES[plan.mode], launch_stream(a.device))
    if err:
        raise RuntimeError(f"elevator_scan_bwd launch failed ({plan}): error {err}")
    return da, dx, dh0


def elevator_scan_bwd_cuda(a: torch.Tensor, h: torch.Tensor, dh: torch.Tensor,
                           h0: torch.Tensor | None = None):
    """The scan's backward from the forward's states.  a, h, dh: (B, T, D)
    f32; h0: (B, D) f32 or None (zeros).  Returns (da, dx, dh0), all f32.
    CPU tensors take the plain version."""
    if a.device.type == "cpu":
        return elevator_scan_bwd_ref(a, h, dh, h0)
    _check_bwd_args("elevator_scan_bwd_cuda", a, h, dh, h0)
    b, t, d = a.shape
    plan = plan_scan_bwd(b, t, d, sm_count(a.device), pointer_alignment(a, h, dh))
    out = _launch_bwd(a, h, dh, h0, plan)
    elevator_scan_bwd_cuda.launches += 1
    return out


elevator_scan_bwd_cuda.launches = 0


def launch_bwd_plan(a: torch.Tensor, h: torch.Tensor, dh: torch.Tensor,
                    h0: torch.Tensor | None = None, *, plan: ScanPlan):
    """The backward on CUDA tensors with a given plan (one of
    :func:`scan_bwd_plans`); counts no launch."""
    _check_bwd_args("launch_bwd_plan", a, h, dh, h0)
    b, t, d = a.shape
    if plan not in scan_bwd_plans(b, t, d, pointer_alignment(a, h, dh)):
        raise ValueError(f"launch_bwd_plan: {plan} is not a plan of these inputs")
    return _launch_bwd(a, h, dh, h0, plan)


# --------------------------------------------------------------------------
# The meta branch (``core.lowering``)
# --------------------------------------------------------------------------

def scan_cost(b: int, t: int, d: int, dtype: torch.dtype, h0: bool = True) -> LaunchCost:
    """One launch of the chunked scan, as PERF.md's row 8 bounds it: a and x
    read and h written in their dtype, h0 read in f32 where given; 2 f32
    operations an element."""
    nbytes = 3 * b * t * d * dtype.itemsize + (b * d * 4 if h0 else 0)
    return LaunchCost.of(2 * b * t * d, "f32", nbytes)


def scan_bwd_cost(b: int, t: int, d: int, h0: bool = True) -> LaunchCost:
    """One launch of the scan's backward, as PERF.md's row B2 bounds it: a,
    h and dh read, da and dx written (all f32), h0 read where given and dh0
    written; 3 f32 operations an element."""
    nbytes = 5 * b * t * d * 4 + (b * d * 4 if h0 else 0) + b * d * 4
    return LaunchCost.of(3 * b * t * d, "f32", nbytes)


def elevator_scan_meta(a: torch.Tensor, x: torch.Tensor,
                       h0: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`elevator_scan_cuda` on meta tensors: the same checks and plan,
    an empty h, and the launch recorded."""
    check_scan_args("elevator_scan_cuda", a, x, h0, device_type="meta")
    b, t, d = x.shape
    plan = plan_scan(b, t, d, x.dtype, H100_SMS, pointer_alignment(a, x))
    with kernel_scope():
        out = torch.empty_like(x)
    record_launch("elevator_scan_cuda", scan_cost(b, t, d, x.dtype, h0 is not None), plan)
    return out


def elevator_scan_bwd_meta(a: torch.Tensor, h: torch.Tensor, dh: torch.Tensor,
                           h0: torch.Tensor | None = None):
    """:func:`elevator_scan_bwd_cuda` on meta tensors."""
    _check_bwd_args("elevator_scan_bwd_cuda", a, h, dh, h0, device_type="meta")
    b, t, d = a.shape
    plan = plan_scan_bwd(b, t, d, H100_SMS, pointer_alignment(a, h, dh))
    with kernel_scope():
        out = (torch.empty_like(a), torch.empty_like(dh),
               torch.empty((b, d), dtype=torch.float32, device="meta"))
    record_launch("elevator_scan_bwd_cuda", scan_bwd_cost(b, t, d, h0 is not None), plan)
    return out


# --------------------------------------------------------------------------
# Shared memory and launch declarations (``repro_torch.analysis.resources``)
# --------------------------------------------------------------------------

#: Shared bytes before a block's ring: its stages' barriers (the source's
#: HEADER).
_HEADER = 256


def ring_stages(plan: ScanPlan, t: int) -> int:
    """The ring's depth a launch of ``plan`` over ``t`` rows takes (the
    source's ``ring_stages``): no more stages than T has chunks, and the
    loader-warp variant at least its three loader warps' worth."""
    chunks = -(-t // SCAN_ROWS[plan.mode])
    ring = max(plan.stages, _LOADERS) if plan.mode == "loaders" else plan.stages
    return min(ring, chunks)


def scan_threads(plan: ScanPlan) -> int:
    """Threads of a block: the chain warp and one producer warp, or the
    loader warps."""
    return 32 * (1 + (_LOADERS if plan.mode == "loaders" else 1))


def scan_smem_bytes(plan: ScanPlan, t: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one block of the chunked scan (the source's
    ``scan_smem`` at the depth :func:`ring_stages` gives): the barriers, then
    the ring's a and x tiles of ``SCAN_ROWS[mode]`` rows by ``plan.cols``
    channels.  The source's ``elevator_scan_smem`` returns the same."""
    item = _check_dtype("scan_smem_bytes", dtype)
    return _HEADER + 2 * ring_stages(plan, t) * SCAN_ROWS[plan.mode] * plan.cols * item


def scan_bwd_smem_bytes(plan: ScanPlan, t: int) -> int:
    """Dynamic shared memory of one block of the backward (the source's
    ``scan_bwd_smem``): the barriers and three f32 tiles a stage (a, dh, h).
    The source's ``elevator_scan_bwd_smem`` returns the same."""
    return _HEADER + 3 * ring_stages(plan, t) * SCAN_ROWS[plan.mode] * plan.cols * 4


def scan_launch(kernel, shape, plan, b, t, d, dtype, bwd=False):
    """The launch of ``plan`` over (b, t, d): a block ``plan.cols`` channels
    of one batch row.  The occupancy query takes the backward's tile in
    channels, the forward's in channels too (the C maps them to lanes)."""
    mode = SCAN_MODES[plan.mode]
    if bwd:
        smem = scan_bwd_smem_bytes(plan, t)
        occ = (2, plan.cols, plan.stages, mode, t)
        query = ("elevator_scan_bwd_smem", (t, plan.cols, plan.stages, mode), smem)
    else:
        smem = scan_smem_bytes(plan, t, dtype)
        code = DTYPE_CODE[dtype]
        occ = (0, code, plan.cols, plan.stages, mode, t)
        query = ("elevator_scan_smem", (t, code, plan.cols, plan.stages, mode), smem)
    return KernelLaunch(
        kernel=kernel, location=("src/repro_torch/kernels/elevator_scan/csrc/elevator_scan.cu:"
                                 + ("launch_bwd_mode" if bwd else "launch_mode")),
        shape=shape, grid=(-(-d // plan.cols), b, 1), threads=scan_threads(plan),
        dynamic_smem=smem, library="elevator_scan", occupancy=occ, queries=(query,),
        meta=(("b", b), ("t", t), ("d", d), ("cols", plan.cols)))


def rglru_width(cfg):
    """The RG-LRU's width (its scans run in f32), or None without one."""
    return cfg.d_rnn if cfg.rglru else None


def _scan_spec(cfg, sms):
    """The chunked scan's launches: the serving prefill (longer than a
    decode window), scoring and a training microbatch."""
    d = rglru_width(cfg)
    if d is None:
        return []
    shapes = [("prefill", SERVE_BATCH, SERVE_PROMPT), ("scoring", *scoring_shape(cfg))]
    if train_microbatch(cfg):
        shapes.append(("train", *train_microbatch(cfg)))
    f32 = torch.float32
    return [scan_launch("elevator_scan_cuda", f"{path} B={b} T={t}",
                        plan_scan(b, t, d, f32, sms), b, t, d, f32) for path, b, t in shapes]


def _scan_bwd_spec(cfg, sms):
    d = rglru_width(cfg)
    if d is None or not train_microbatch(cfg):
        return []
    b, t = train_microbatch(cfg)
    return [scan_launch("elevator_scan_bwd_cuda", f"train B={b} T={t}",
                        plan_scan_bwd(b, t, d, sms), b, t, d, torch.float32, bwd=True)]


register_launch_spec("elevator_scan_cuda", _scan_spec)
register_launch_spec("elevator_scan_bwd_cuda", _scan_bwd_spec)
