"""Token shift (causal depthwise conv): the CUDA kernel
``csrc/token_shift.cu`` and its plain version
:func:`~repro_torch.kernels.token_shift.ref.token_shift_ref`.

Counterpart of ``repro.kernels.token_shift.kernel.token_shift_pallas``.
The Pallas kernel walks the sequence in chunks and carries the last
``taps - 1`` rows of each chunk in a VMEM token buffer; on the card that
carry is only a halo: each thread reads its 16-byte slot of its own rows
and of the ``taps - 1`` rows above them, all at once, so no block waits on
another (the source's note says how many rows a thread takes, and how a D
that is not a multiple of the slot is read).  Unlike the Pallas wrapper
(chunk = min(256, T) must divide T) the kernel takes any T >= 1: the
stateful calls of the model pass T = taps - 1 + window.

:func:`token_shift_cuda` launches the kernel on CUDA tensors (counted in
``token_shift_cuda.launches``) or raises; CPU tensors take the plain
version.  :func:`token_shift_bwd_cuda` is the backward (``token_shift_bwd``
in the same source, no Pallas counterpart), one launch: dx by the taps run
anti-causally, dw summed in the same launch in a fixed order (lanes, then
the blocks of a thread-block cluster in rank order).  Its launch shape
comes from the pure-Python planner :func:`plan_shift_bwd`;
:func:`launch_bwd_plan` launches any plan of :func:`shift_bwd_plans`
without counting it.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from repro_torch.kernels.common import (
    DECODE_WINDOWS,
    DTYPE_CODE,
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
from repro_torch.kernels.token_shift.ref import token_shift_bwd_ref, token_shift_ref

__all__ = ["MAX_TAPS", "BWD_THREADS", "BWD_MAX_COLS", "BWD_MAX_CLUSTER", "BWD_STAGES",
           "BWD_GROUPS", "BWD_IN_FLIGHT", "ShiftBwdPlan", "slot_channels",
           "bwd_sub", "bwd_smem_bytes", "plan_shift_bwd", "shift_bwd_plans", "launch_bwd_plan",
           "token_shift_cuda", "token_shift_ref", "token_shift_bwd_cuda",
           "token_shift_bwd_ref", "FWD_THREADS", "FWD_FILL", "fwd_rows"]

#: Largest tap count the kernel takes (the reference's token-buffer budget).
MAX_TAPS = 8
#: The backward's constants, as the source has them: threads of a block at
#: most, slot columns of a block at most (8: 128 bytes of a row), blocks of
#: a cluster at most (the portable size), sub-tiles of a thread's ring.
BWD_THREADS = 128
BWD_MAX_COLS = 8
BWD_MAX_CLUSTER = 8
BWD_STAGES = 3
#: Row lanes of a block, most first (at 8 columns: 128, 64 or 32 threads).
BWD_GROUPS = (16, 8, 4)
#: The bytes the planner wants the rings of a launch to hold in flight:
#: the card's 3.35 TB/s over a DRAM round trip of about a microsecond,
#: with a margin.  On the H100 at (1, 4096, 2560) bf16 (PERF.md, section 6,
#: PR 27; ``benchmarks/train_bwd.py``), 32 lanes a stripe (5.2 MB in
#: flight) ran 29.1-29.6 us in every split of clusters and lanes, 64 lanes
#: 30.6-30.7, 16 lanes (2.6 MB) 40.0-40.5.
BWD_IN_FLIGHT = 3 << 20


def _check(name, x, w):
    b, t, d = x.shape
    taps = w.shape[0]
    if x.dtype not in DTYPE_CODE or w.dtype != x.dtype:
        raise ValueError(f"{name}: x {x.dtype} and w {w.dtype} must be one "
                         "of float32, bfloat16")
    if w.shape != (taps, d) or not 2 <= taps <= MAX_TAPS:
        raise ValueError(f"{name}: w shape {tuple(w.shape)} must be "
                         f"(taps, {d}) with 2 <= taps <= {MAX_TAPS}")


def token_shift_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """out[b, t, d] = sum_k w[k, d] x[b, t-k, d].  x: (B, T, D) f32 or bf16;
    w: (taps, D) of x's dtype, 2 <= taps <= 8.  Returns (B, T, D) in
    x.dtype, summed in f32.  CPU tensors take the plain version."""
    if x.device.type == "cpu":
        return token_shift_ref(x, w)
    b, t, d = x.shape
    taps = w.shape[0]
    check_kernel_tensors("token_shift_cuda", x=x, w=w)
    _check("token_shift_cuda", x, w)
    out = torch.empty_like(x)
    fn = load_library("token_shift").token_shift_fwd
    err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), b, t, d, taps,
             DTYPE_CODE[x.dtype], launch_stream(x.device))
    if err:
        raise RuntimeError(f"token_shift_fwd launch failed: cudaError {err}")
    token_shift_cuda.launches += 1
    return out


token_shift_cuda.launches = 0


@dataclass(frozen=True)
class ShiftBwdPlan:
    """One launch of the backward: ``cols`` 16-byte slot columns by
    ``groups`` row lanes a block, a cluster of ``cluster`` blocks covering
    every row of its channels, units of ``rows`` rows of one batch row, and
    the ring filled by 16-byte copies (``vec``) or by scalar loads."""

    cols: int
    groups: int
    cluster: int
    rows: int
    vec: bool


def slot_channels(dtype: torch.dtype) -> int:
    """Channels of a 16-byte slot: 4 f32 or 8 bf16."""
    if dtype not in DTYPE_CODE:
        raise ValueError(f"token shift: dtype {dtype} not supported (float32, bfloat16)")
    return 16 // dtype.itemsize


def bwd_sub(taps: int, dtype: torch.dtype) -> int:
    """Rows of a sub-tile (the source's ``bwd_sub``): 8, fewer past 4 taps,
    whose f32 weights, partials and windows take the registers."""
    return 8 if taps <= 4 else 2 if slot_channels(dtype) == 4 else 1


def bwd_smem_bytes(plan: ShiftBwdPlan, taps: int, dtype: torch.dtype) -> int:
    """The backward's dynamic shared memory a block (the source's
    ``bwd_smem_bytes``): the threads' rings (16 bytes of dout and of x a
    row, :data:`BWD_STAGES` sub-tiles), or the lanes' f32 dw partials and
    the block's sum that reuse them, whichever is larger."""
    red = (plan.groups + 1) * taps * plan.cols * slot_channels(dtype) * 4
    return max(red, BWD_STAGES * bwd_sub(taps, dtype) * 32 * plan.cols * plan.groups)


def _check_shape(name, b, t, d, taps):
    if min(b, t, d) < 1 or not 2 <= taps <= MAX_TAPS:
        raise ValueError(f"{name}: b={b} t={t} d={d} must be >= 1 and taps={taps} in "
                         f"2..{MAX_TAPS}")


def _vec(d, dtype, align) -> bool:
    """Whether the 16-byte slots tile D and the inputs are 16-byte aligned
    (else the ring is filled by scalar loads)."""
    return d % slot_channels(dtype) == 0 and align >= 16


def _plan(b, t, d, dtype, align, groups, cluster) -> ShiftBwdPlan:
    """The plan of ``groups`` lanes and a cluster of ``cluster``: as many
    slot columns as D has, up to 8; units of the fewest rows whose count
    the cluster's lanes cover."""
    cols = min(BWD_MAX_COLS, -(-d // slot_channels(dtype)))
    per = max(1, cluster * groups // b)
    return ShiftBwdPlan(cols, groups, cluster, -(-t // per), _vec(d, dtype, align))


def shift_bwd_plans(b: int, t: int, d: int, taps: int, dtype: torch.dtype,
                    align: int = 16) -> list[ShiftBwdPlan]:
    """Every plan the backward can launch for (b, t, d) inputs of
    ``dtype`` whose addresses are aligned to ``align`` bytes: each cluster
    size by each lane count, in the layout's variant."""
    _check_shape("shift_bwd_plans", b, t, d, taps)
    return [_plan(b, t, d, dtype, align, g, c) for c in (8, 4, 2, 1) for g in BWD_GROUPS]


@functools.lru_cache(maxsize=1024)
def plan_shift_bwd(b: int, t: int, d: int, taps: int, dtype: torch.dtype, sms: int,
                   align: int = 16) -> ShiftBwdPlan:
    """The plan :func:`token_shift_bwd_cuda` launches on a card of ``sms``
    SMs.  Lanes a channel stripe: the fewest (a power of two, 4 to 128)
    whose in-flight sub-tiles hold :data:`BWD_IN_FLIGHT` bytes, and no more
    than B * T; then the smallest cluster whose blocks cover the SMs (else
    the largest that leaves 4 lanes a block).  At (1, 4096, 2560) and (2,
    1024, 2560) bf16 on 132 SMs: 40 stripes of 64 channels, 32 lanes, as
    clusters of 4 blocks of 8 lanes (160 blocks of 64 threads), units of
    128 and 64 rows; the 16-byte copies wherever the layout takes them."""
    _check_shape("plan_shift_bwd", b, t, d, taps)
    if sms < 1:
        raise ValueError(f"plan_shift_bwd: sms={sms} must be >= 1")
    cols = min(BWD_MAX_COLS, -(-d // slot_channels(dtype)))
    stripes = -(-d // (slot_channels(dtype) * cols))
    flight = (BWD_STAGES - 1) * bwd_sub(taps, dtype) * 32 * cols * stripes
    lanes = BWD_GROUPS[-1]
    while lanes < BWD_MAX_CLUSTER * BWD_GROUPS[0] and lanes * flight < BWD_IN_FLIGHT:
        lanes *= 2
    while lanes > BWD_GROUPS[-1] and lanes > b * t:
        lanes //= 2
    sizes = [c for c in (1, 2, 4, 8) if BWD_GROUPS[-1] <= lanes // c <= BWD_GROUPS[0]]
    cluster = next((c for c in sizes if stripes * c >= sms), sizes[-1])
    return _plan(b, t, d, dtype, align, lanes // cluster, cluster)


def _check_bwd(name, x, w, dout):
    check_kernel_tensors(name, x=x, w=w, dout=dout)
    _check(name, x, w)
    if dout.shape != x.shape or dout.dtype != x.dtype:
        raise ValueError(f"{name}: dout {dout.dtype} {tuple(dout.shape)} must "
                         f"match x {x.dtype} {tuple(x.shape)}")


def _launch_bwd(x, w, dout, plan: ShiftBwdPlan):
    b, t, d = x.shape
    dx, dw = torch.empty_like(x), torch.empty_like(w)
    err = load_library("token_shift").token_shift_bwd(
        x.data_ptr(), w.data_ptr(), dout.data_ptr(), dx.data_ptr(), dw.data_ptr(), b, t, d,
        w.shape[0], DTYPE_CODE[x.dtype], plan.cols, plan.groups, plan.cluster, plan.rows,
        int(plan.vec), launch_stream(x.device))
    if err:
        raise RuntimeError(f"token_shift_bwd launch failed ({plan}): cudaError {err}")
    return dx, dw


def token_shift_bwd_cuda(x: torch.Tensor, w: torch.Tensor, dout: torch.Tensor):
    """The backward of :func:`token_shift_cuda`: x, dout (B, T, D) and w
    (taps, D) of one dtype.  Returns (dx in x.dtype, dw in w.dtype), summed
    in f32; one launch of :func:`plan_shift_bwd`'s plan, counted in
    ``token_shift_bwd_cuda.launches``.  CPU tensors take the plain
    version."""
    if x.device.type == "cpu":
        return token_shift_bwd_ref(x, w, dout)
    _check_bwd("token_shift_bwd_cuda", x, w, dout)
    b, t, d = x.shape
    plan = plan_shift_bwd(b, t, d, w.shape[0], x.dtype, sm_count(x.device),
                          pointer_alignment(x, w, dout))
    out = _launch_bwd(x, w, dout, plan)
    token_shift_bwd_cuda.launches += 1
    return out


token_shift_bwd_cuda.launches = 0


def launch_bwd_plan(x: torch.Tensor, w: torch.Tensor, dout: torch.Tensor, *,
                    plan: ShiftBwdPlan):
    """The backward on CUDA tensors with a given plan (one of
    :func:`shift_bwd_plans`); counts no launch."""
    _check_bwd("launch_bwd_plan", x, w, dout)
    b, t, d = x.shape
    if plan not in shift_bwd_plans(b, t, d, w.shape[0], x.dtype,
                                   pointer_alignment(x, w, dout)):
        raise ValueError(f"launch_bwd_plan: {plan} is not a plan of these inputs")
    return _launch_bwd(x, w, dout, plan)


# --------------------------------------------------------------------------
# Launch declarations (``repro_torch.analysis.resources``)
# --------------------------------------------------------------------------

#: The forward's block (one 16-byte slot a thread) and the blocks an SM a
#: plan of more rows a thread must keep (the source's NT and FILL).
FWD_THREADS, FWD_FILL = 64, 8


def fwd_rows(b: int, t: int, d: int, dtype: torch.dtype, sms: int) -> int:
    """The rows a thread of the forward takes (the source picks them at each
    launch, ``fwd_rows``): the most, 8 or 4, that still gives every SM
    :data:`FWD_FILL` blocks, else 1.  The source's ``token_shift_fwd_rows``
    answers the same."""
    slots = b * -(-d // (slot_channels(dtype) * FWD_THREADS))
    for rows in (8, 4):
        if slots * -(-t // rows) >= FWD_FILL * sms:
            return rows
    return 1


def _fwd_launch(shape, b, t, d, taps, dtype, sms):
    rows, code = fwd_rows(b, t, d, dtype, sms), DTYPE_CODE[dtype]
    vec = int(_vec(d, dtype, 16))
    return KernelLaunch(
        kernel="token_shift_cuda",
        location="src/repro_torch/kernels/token_shift/csrc/token_shift.cu:launch_rows",
        shape=shape, grid=(-(-d // (slot_channels(dtype) * FWD_THREADS)), -(-t // rows), b),
        threads=FWD_THREADS, dynamic_smem=0, library="token_shift",
        occupancy=(0, taps, code, rows, vec),
        queries=(("token_shift_fwd_rows", (b, t, d, code, sms), rows),),
        meta=(("b", b), ("t", t), ("d", d), ("rows", rows)))


def _conv(cfg):
    """(width, taps, dtype) of the RG-LRU block's temporal conv, or None."""
    return (cfg.d_rnn, cfg.conv_width, getattr(torch, cfg.dtype)) if cfg.rglru else None


def _fwd_spec(cfg, sms):
    """The forward's launches: a stateful call shifts the conv's taps - 1
    rows of state in front of its window (the serving prefill, each decode
    window); scoring and training shift bare sequences."""
    conv = _conv(cfg)
    if conv is None:
        return []
    d, taps, dtype = conv
    tail = taps - 1
    shapes = [("prefill", SERVE_BATCH, tail + SERVE_PROMPT)]
    shapes += [(f"decode K={k}", SERVE_BATCH, tail + k) for k in DECODE_WINDOWS]
    shapes.append(("scoring", *scoring_shape(cfg)))
    if train_microbatch(cfg):
        shapes.append(("train", *train_microbatch(cfg)))
    return [_fwd_launch(f"{path} B={b} T={t}", b, t, d, taps, dtype, sms)
            for path, b, t in shapes]


def _bwd_spec(cfg, sms):
    conv = _conv(cfg)
    if conv is None or not train_microbatch(cfg):
        return []
    d, taps, dtype = conv
    b, t = train_microbatch(cfg)
    plan = plan_shift_bwd(b, t, d, taps, dtype, sms)
    code, smem = DTYPE_CODE[dtype], bwd_smem_bytes(plan, taps, dtype)
    slots = -(-d // slot_channels(dtype))
    return [KernelLaunch(
        kernel="token_shift_bwd_cuda",
        location="src/repro_torch/kernels/token_shift/csrc/token_shift.cu:launch_bwd_taps",
        shape=f"train B={b} T={t}",
        grid=(-(-slots // plan.cols), plan.cluster, 1),
        threads=plan.cols * plan.groups, cluster=(1, plan.cluster, 1), dynamic_smem=smem,
        library="token_shift", occupancy=(1, taps, code, plan.groups, plan.cols, int(plan.vec)),
        queries=(("token_shift_bwd_smem", (plan.groups, taps, plan.cols, code), smem),),
        meta=(("b", b), ("t", t), ("d", d)))]


register_launch_spec("token_shift_cuda", _fwd_spec)
register_launch_spec("token_shift_bwd_cuda", _bwd_spec)
