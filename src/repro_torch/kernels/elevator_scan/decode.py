"""Elevator decode window: the CUDA kernel ``csrc/elevator_scan.cu``
(``elevator_decode_window_fwd``) and its plain version.

Counterpart of
``repro.kernels.elevator_scan.decode.elevator_decode_window_pallas``: the
recurrence over a window of K >= 1 decode tokens with h0 (B, D) read once
and the state carried in a register across the window.  Each step computes
``a * h`` rounded, then ``+ x`` rounded (no fused multiply-add), and the
f32 exit state comes back beside the outputs, so a window equals K chained
single launches bit for bit in f32 and bf16 alike, and equals the chunked
scan over the same tokens.  One wrapper serves both uses (the reference
has one Pallas entry for them): every generated token (K = 1) and every
admission of at most :data:`ELEVATOR_DECODE_WINDOW_MAX` tokens, counted in
``elevator_decode_window_cuda.launches``.

The kernel runs one chain a channel in one of two modes (see the note at
the top of the source): ``"tma"`` stages the block's whole window of a
and x by TMA before any chain starts (K <= 64, rows a multiple of 16
bytes); ``"regs"`` has each thread load ``vec`` consecutive channels of
up to 32 tokens into registers at once before its chain runs them (any K,
any layout; the single step, in 16-byte accesses).  :func:`plan_window`
(pure Python, cached: the wrapper asks it on every decode step) picks the
mode, ``vec`` and the block's threads from the shape, the window, the
dtype, the SM count and the inputs' alignment.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from repro_torch.kernels.common import (
    DECODE_WINDOWS,
    DTYPE_CODE,
    SERVE_BATCH,
    KernelLaunch,
    launch_stream,
    load_library,
    register_launch_spec,
    sm_count,
)
from repro_torch.kernels.elevator_scan.kernel import (
    check_scan_args,
    pointer_alignment,
    rglru_width,
)
from repro_torch.kernels.elevator_scan.ref import elevator_scan_ref_f32

# Stateful (decode) dispatches at or below this many tokens take the window
# kernel; longer ones take the chunked kernel (the reference's threshold).
ELEVATOR_DECODE_WINDOW_MAX = 64
#: Channels a thread of the register window takes, widest first (16, 8 or
#: 4 bytes of f32 an access).
WINDOW_VECS = (4, 2, 1)
#: Threads of a block of the register window, widest first.
WINDOW_THREADS = (256, 128, 64, 32)
#: Channels of a block of the staged (TMA) window, widest first.
WINDOW_TMA_COLS = (128, 64, 32)
#: Values of a and x one register-window thread holds at once (the
#: source's WIN_VALUES): 2 * vec * the tokens whose loads go out together.
WINDOW_VALUES = 64
#: Tokens whose loads a register-window thread issues at once, at most (the
#: source's WIN_KMAX); a longer window runs in pieces of this many.
WINDOW_KMAX = 32
#: The longest window the staged mode takes (the source's WIN_TMA_KMAX).
WINDOW_TMA_KMAX = 64
#: Plan modes -> the C entry point's ``mode``.
WINDOW_MODES = {"regs": 0, "tma": 1}

__all__ = ["ELEVATOR_DECODE_WINDOW_MAX", "WINDOW_VECS", "WINDOW_THREADS", "WINDOW_TMA_COLS",
           "WINDOW_MODES", "WindowPlan", "window_kmax", "window_uses_tma", "plan_window",
           "window_plans", "launch_plan", "elevator_decode_window_cuda",
           "elevator_decode_window_plain", "window_smem_bytes"]


@dataclass(frozen=True)
class WindowPlan:
    """One launch of the window kernel: the mode (a key of
    :data:`WINDOW_MODES`), ``vec`` channels a thread (1 when staged) and
    ``threads`` threads a block (one a channel when staged)."""

    mode: str
    vec: int
    threads: int


def window_kmax(k: int) -> int:
    """The tokens whose loads a register-window thread issues at once for a
    ``k``-token window: 1 for a single step, else k rounded up to 8, at
    most :data:`WINDOW_KMAX` (the source's rule)."""
    return 1 if k == 1 else min(WINDOW_KMAX, -(-k // 8) * 8)


def _item(dtype) -> int:
    if dtype not in DTYPE_CODE:
        raise ValueError(f"plan_window: dtype {dtype} not supported (float32, bfloat16)")
    return dtype.itemsize


def window_uses_tma(k: int, d: int, dtype: torch.dtype, align: int = 16) -> bool:
    """Whether the staged mode can take a ``k``-token window of rows of d
    elements: k <= :data:`WINDOW_TMA_KMAX`, a row a multiple of 16 bytes (a
    tensor map's stride) and 16-byte aligned addresses."""
    return k <= WINDOW_TMA_KMAX and (d * _item(dtype)) % 16 == 0 and align >= 16


def _vecs(k: int, d: int, dtype: torch.dtype, align: int) -> list[int]:
    """The channel counts a register-window thread can take: d a multiple of
    vec, the addresses aligned to a vec-float access (h0's; a and x need no
    more), and the window's values in :data:`WINDOW_VALUES` registers."""
    _item(dtype)
    return [v for v in WINDOW_VECS
            if d % v == 0 and align % (4 * v) == 0 and 2 * v * window_kmax(k) <= WINDOW_VALUES]


def _cover(b: int, per_row: int, sizes, sms: int) -> int:
    """The widest of ``sizes`` whose blocks (b times the blocks across a row
    of ``per_row`` items) cover the SMs, else the narrowest."""
    return next((n for n in sizes if b * -(-per_row // n) >= sms), sizes[-1])


@functools.lru_cache(maxsize=1024)
def plan_window(b: int, k: int, d: int, dtype: torch.dtype, sms: int,
                align: int = 16) -> WindowPlan:
    """The plan the wrapper launches for a ``k``-token window of (b, d)
    channels of ``dtype`` on a card of ``sms`` SMs, the addresses aligned to
    ``align`` bytes.  A single step loads in registers, the widest access a
    thread can take (16 bytes of f32); a longer window is staged by TMA
    where :func:`window_uses_tma`, else loaded in registers.  Then the
    widest block whose grid still covers the SMs, else the narrowest (at
    B=4, D=2560: k=1 4 channels a thread and 32 threads a block, 80
    blocks; k=64 staged in blocks of 64 channels, 160 blocks)."""
    if min(b, k, d, sms) < 1:
        raise ValueError(f"plan_window: b={b} k={k} d={d} sms={sms} must be >= 1")
    if k > 1 and window_uses_tma(k, d, dtype, align):
        return WindowPlan("tma", 1, _cover(b, d, WINDOW_TMA_COLS, sms))
    vec = _vecs(k, d, dtype, align)[0]
    return WindowPlan("regs", vec, _cover(b, d // vec, WINDOW_THREADS, sms))


def window_plans(b: int, k: int, d: int, dtype: torch.dtype, align: int = 16) -> list[WindowPlan]:
    """Every plan the kernel can launch for these inputs (the card tests
    and ``chip_smoke.py`` check and time them all)."""
    plans = []
    if window_uses_tma(k, d, dtype, align):
        plans += [WindowPlan("tma", 1, n) for n in WINDOW_TMA_COLS]
    return plans + [WindowPlan("regs", v, n) for v in _vecs(k, d, dtype, align)
                    for n in WINDOW_THREADS]


def elevator_decode_window_plain(a, x, h0):
    """Plain version: (h (B, K, D) in x.dtype, exit state (B, D) f32)."""
    h32 = elevator_scan_ref_f32(a, x, h0)
    return h32.to(x.dtype), h32[:, -1]


def _launch(a, x, h0, plan: WindowPlan):
    b, k, d = x.shape
    out = torch.empty_like(x)
    h_out = torch.empty_like(h0)
    err = load_library("elevator_scan").elevator_decode_window_fwd(
        a.data_ptr(), x.data_ptr(), h0.data_ptr(), out.data_ptr(), h_out.data_ptr(),
        b, k, d, DTYPE_CODE[x.dtype], plan.vec, plan.threads, WINDOW_MODES[plan.mode],
        launch_stream(x.device))
    if err:
        raise RuntimeError(f"elevator_decode_window_fwd launch failed ({plan}): error {err}")
    return out, h_out


def _check(name, a, x, h0):
    if h0 is None:
        raise ValueError(f"{name}: h0 is required")
    check_scan_args(name, a, x, h0)
    return pointer_alignment(a, x, h0)


def launch_plan(a: torch.Tensor, x: torch.Tensor, h0: torch.Tensor, *, plan: WindowPlan):
    """Launch the window kernel on CUDA tensors with a given plan (one of
    :func:`window_plans`); counts no launch.  The wrapper launches
    :func:`plan_window`'s choice; the card tests and ``chip_smoke.py``
    compare and time the others."""
    align = _check("launch_plan", a, x, h0)
    b, k, d = x.shape
    if plan not in window_plans(b, k, d, x.dtype, align):
        raise ValueError(f"launch_plan: {plan} is not a plan of these inputs")
    return _launch(a, x, h0, plan)


def elevator_decode_window_cuda(a: torch.Tensor, x: torch.Tensor,
                                h0: torch.Tensor):
    """K-token window, any K >= 1.  a, x: (B, K, D) f32 or bf16; h0: (B, D)
    f32.  Returns (h (B, K, D) in x.dtype, exit state (B, D) f32).  CPU
    tensors take the plain version."""
    if x.device.type == "cpu":
        return elevator_decode_window_plain(a, x, h0)
    align = _check("elevator_decode_window_cuda", a, x, h0)
    b, k, d = x.shape
    res = _launch(a, x, h0, plan_window(b, k, d, x.dtype, sm_count(x.device), align))
    elevator_decode_window_cuda.launches += 1
    return res


elevator_decode_window_cuda.launches = 0


# --------------------------------------------------------------------------
# Shared memory and launch declarations (``repro_torch.analysis.resources``)
# --------------------------------------------------------------------------


def window_smem_bytes(plan: WindowPlan, k: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one block of the window: for the staged mode
    the barrier and the a and x tiles (k rows of ``plan.threads`` channels,
    each on a 128-byte boundary: the source's ``window_smem``), none for the
    register mode.  The source's ``elevator_window_smem`` returns the
    same."""
    if plan.mode != "tma":
        return 0
    tile = -(-(k * plan.threads * _item(dtype)) // 128) * 128
    return 128 + 2 * tile


def window_launch(shape, plan, b, k, d, dtype):
    """The launch of ``plan`` for a k-token window of (b, d) channels."""
    code, mode = DTYPE_CODE[dtype], WINDOW_MODES[plan.mode]
    per_block = plan.threads * plan.vec
    smem = window_smem_bytes(plan, k, dtype)
    return KernelLaunch(
        kernel="elevator_decode_window_cuda",
        location=("src/repro_torch/kernels/elevator_scan/csrc/elevator_scan.cu:"
                  + ("launch_window_tma" if plan.mode == "tma" else "launch_window_k")),
        shape=shape, grid=(-(-d // per_block), b, 1), threads=plan.threads, dynamic_smem=smem,
        library="elevator_scan", occupancy=(1, code, k, plan.vec, plan.threads, mode),
        queries=(("elevator_window_smem", (k, code, plan.threads, mode), smem),),
        meta=(("b", b), ("k", k), ("d", d)))


def _window_spec(cfg, sms):
    """The window's launches: every decode window size at serving's batch
    (a single step and the admissions' windows)."""
    d = rglru_width(cfg)
    if d is None:
        return []
    f32, b = torch.float32, SERVE_BATCH
    return [window_launch(f"decode B={b} K={k}", plan_window(b, k, d, f32, sms),
                          b, k, d, f32) for k in DECODE_WINDOWS]


register_launch_spec("elevator_decode_window_cuda", _window_spec)
