"""Flash attention: the CUDA kernel ``csrc/flash_attention.cu`` and its
plain version :func:`~repro_torch.kernels.local_attention.ref.attention_ref`.

Counterpart of ``repro.kernels.local_attention.kernel.flash_attention_pallas``,
in every variant it has: causal, full, causal sliding-window, non-causal
window, GQA (kv head = q head // group), the decode offset S - T, T and S of
any length, and 0 for a query that sees no key.  bf16 inputs run on the
tensor cores; f32 inputs on a CUDA-core path with f32 products (see the
note at the top of the source).  With ``lse=True`` (training) the forward
also returns each row's log-sum-exp, which
:func:`flash_attention_bwd_cuda` (``csrc/flash_attention_bwd.cu``, a
backward with no Pallas counterpart) reads to recompute the softmax.

:func:`flash_attention_cuda` and :func:`flash_attention_bwd_cuda` launch on
CUDA tensors (counted in their ``launches``) or raise; CPU tensors take the
plain versions (:func:`attention_ref`, :func:`attention_ref_lse`,
:func:`attention_bwd_ref`).

The bf16 backward's tiles, ring depths and GQA cluster come from
:func:`plan_flash_bwd` (pure Python, cached: the wrapper asks it on every
call), which the C entry point launches as given; :func:`bwd_smem_bytes`
mirrors the source's ``flash_bwd_smem``.  :func:`launch_bwd_plan` launches a
given plan without counting it (the card tests and ``chip_smoke.py``
check every plan of :func:`flash_bwd_plans`).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.lowering import (
    LaunchCost,
    flop_class,
    kernel_scope,
    record_launch,
)
from repro_torch.kernels.common import (
    DTYPE_CODE,
    H100_SMS,
    SMEM_LIMIT,
    KernelLaunch,
    check_kernel_tensors,
    launch_stream,
    load_library,
    register_launch_spec,
    scoring_shape,
    sm_count,
    train_microbatch,
)
from repro_torch.kernels.local_attention.ref import (
    attention_bwd_ref,
    attention_ref,
    attention_ref_lse,
)

__all__ = ["HEAD_DIMS", "F32_HEAD_DIMS", "BWD_KV_TILE", "BWD_Q_TILE", "BWD_DQ_ROWS",
           "BWD_DQ_KEYS", "BWD_MAX_STAGES", "MAX_CLUSTER", "BWD_WAVES", "SMEM_LIMIT",
           "FlashBwdPlan", "bwd_smem_bytes", "fwd_smem_bytes", "plan_flash_bwd", "flash_bwd_plans",
           "flash_attention_cuda", "flash_attention_bwd_cuda", "launch_bwd_plan",
           "attention_ref", "attention_ref_lse", "attention_bwd_ref", "visible_pairs",
           "flash_cost", "flash_bwd_cost", "flash_attention_meta", "flash_attention_bwd_meta"]

#: Head widths the kernels are compiled for, in bf16 and in f32 (96: the
#: qwen2-100m training example's width).
HEAD_DIMS = (32, 64, 128, 256)
F32_HEAD_DIMS = HEAD_DIMS + (96,)

#: The bf16 backward's compiled tiles (``csrc/flash_attention_bwd.cu``,
#: ``BwdTiles``): keys of a dK/dV block by head width (64 at 256, where the
#: two consumer warpgroups split dK and dV by columns; else 128, 64 keys a
#: warpgroup), queries of its ring stages, queries of a dQ block and keys of
#: its ring stages by head width (32 at 256: Q and dO take 128 KB).
BWD_KV_TILE = {32: 128, 64: 128, 128: 128, 256: 64}
BWD_Q_TILE = 64
BWD_DQ_ROWS = 128
BWD_DQ_KEYS = {32: 64, 64: 64, 128: 64, 256: 32}
#: Ring depth at most (the source's MAX_STAGES), and the GQA cluster size at
#: most (the portable cluster size).
BWD_MAX_STAGES = 4
MAX_CLUSTER = 8
#: The dK/dV grid aims for this many blocks per SM before it stops growing
#: the cluster: under a causal mask its blocks' work is uneven (the lowest
#: key tiles see every query), and more, shorter blocks even out the tail.
#: On the H100 a cluster of 5 at RecurrentGemma's training microbatch ran
#: 2.9x faster than one block a key tile; at Gemma3's, the chosen cluster
#: of 4 ran 1.28x faster than none, but 13% slower than a cluster of 2
#: (at most 30 clusters of 4, 120 SMs, run at once; PERF.md, §6: row B1).
BWD_WAVES = 4
_ALIGN_SLACK, _BAR_BYTES = 1024, 256
#: The forward's compiled tiles (``csrc/flash_attention.cu``): bf16 query
#: rows a block and keys a K/V tile by head width (``FlashPlan``); f32
#: query rows a block and keys a tile (``F_BQ``, ``F_BK``).
FWD_Q_TILE = 128
FWD_KV_TILE = {32: 128, 64: 128, 128: 128, 256: 64}
F32_Q_TILE, F32_KV_TILE = 16, 32


def _up(x: int, m: int) -> int:
    return -(-x // m) * m


def bwd_smem_bytes(d: int, kernel: str, stages: int) -> int:
    """Dynamic shared memory of one block of the bf16 backward at head
    width ``d`` with a ring of ``stages``: ``kernel`` "dkdv" (K and V tiles,
    the ring's Q / dO tiles with their rows of lse and delta, P^T and dS^T)
    or "dq" (Q and dO tiles, the ring's K / V tiles), each with 1024 bytes
    of alignment slack and 256 of barriers.  The source's ``flash_bwd_smem``
    returns the same."""
    if kernel == "dkdv":
        kv = BWD_KV_TILE[d]
        stage = _up(2 * BWD_Q_TILE * d * 2 + 2 * BWD_Q_TILE * 4, 1024)
        tiles = 2 * kv * d * 2 + stages * stage + 2 * kv * BWD_Q_TILE * 2
    elif kernel == "dq":
        tiles = 2 * BWD_DQ_ROWS * d * 2 + stages * 2 * BWD_DQ_KEYS[d] * d * 2
    else:
        raise ValueError(f"bwd_smem_bytes: kernel {kernel!r} is 'dkdv' or 'dq'")
    return _ALIGN_SLACK + tiles + _BAR_BYTES


def fwd_smem_bytes(d: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one block of the forward at head width
    ``d``: bf16 the Q tile and two stages of K and V tiles, with 1024 bytes
    of alignment slack (``FlashPlan::SMEM``); f32 the Q rows, the K tile
    padded a column and the V tile (``f32_smem``).  The source's
    ``flash_fwd_smem`` returns the same."""
    if dtype == torch.bfloat16 and d in HEAD_DIMS:
        return FWD_Q_TILE * d * 2 + 2 * 2 * FWD_KV_TILE[d] * d * 2 + 1024
    if dtype == torch.float32 and d in F32_HEAD_DIMS:
        return (F32_Q_TILE * d + F32_KV_TILE * (d + 1) + F32_KV_TILE * d) * 4
    raise ValueError(f"fwd_smem_bytes: head dim {d} is not compiled for {dtype}")


def _deepest(d: int, kernel: str) -> int:
    """The deepest ring (2 .. BWD_MAX_STAGES) whose block fits SMEM_LIMIT."""
    return max(s for s in range(2, BWD_MAX_STAGES + 1)
               if bwd_smem_bytes(d, kernel, s) <= SMEM_LIMIT)


@dataclass(frozen=True)
class FlashBwdPlan:
    """One launch of the bf16 backward: ``kv_tile`` keys a dK/dV block with a
    ring of ``kv_stages`` stages of BWD_Q_TILE queries; a ring of
    ``dq_stages`` stages of ``dq_keys`` keys behind each dQ block of
    BWD_DQ_ROWS queries; and ``cluster`` blocks sharing a key tile, each
    walking group / cluster of the KV head's query heads."""

    kv_tile: int
    kv_stages: int
    dq_keys: int
    dq_stages: int
    cluster: int


def _clusters(hq: int, hkv: int) -> list[int]:
    group = hq // hkv
    return [c for c in range(1, MAX_CLUSTER + 1) if group % c == 0]


def _plan(d: int, cluster: int, kv_stages: int, dq_stages: int) -> FlashBwdPlan:
    return FlashBwdPlan(BWD_KV_TILE[d], kv_stages, BWD_DQ_KEYS[d], dq_stages, cluster)


def _check_plan_args(name, b, hq, hkv, t, s, d):
    if min(b, hq, hkv, t, s) < 1 or hq % hkv:
        raise ValueError(f"{name}: b={b} hq={hq} hkv={hkv} t={t} s={s}: need >= 1, hkv | hq")
    if d not in BWD_KV_TILE:
        raise ValueError(f"{name}: head dim {d} not in {HEAD_DIMS} (bf16)")


@functools.lru_cache(maxsize=1024)
def plan_flash_bwd(b: int, hq: int, hkv: int, t: int, s: int, d: int, sms: int) -> FlashBwdPlan:
    """The plan the wrapper launches for bf16 (b, hq, t, d) queries over (b,
    hkv, s, d) keys on a card of ``sms`` SMs.

    Tiles are the head width's compiled ones and each ring the deepest that
    fits the shared memory.  The cluster is the smallest divisor c of the
    group (c <= MAX_CLUSTER) whose dK/dV grid, b * hkv * c blocks a key
    tile, reaches BWD_WAVES blocks an SM, else the largest: at Hkv = 1 one
    block a key tile leaves the card under a wave (Gemma3's training
    microbatch, B=4, T=2048 at D=256: 128 blocks; a cluster of 4, 512).
    ``t`` enters no choice."""
    _check_plan_args("plan_flash_bwd", b, hq, hkv, t, s, d)
    if sms < 1:
        raise ValueError(f"plan_flash_bwd: sms={sms} must be >= 1")
    tiles = b * hkv * -(-s // BWD_KV_TILE[d])
    clusters = _clusters(hq, hkv)
    cluster = next((c for c in clusters if tiles * c >= BWD_WAVES * sms), clusters[-1])
    return _plan(d, cluster, _deepest(d, "dkdv"), _deepest(d, "dq"))


def flash_bwd_plans(b: int, hq: int, hkv: int, t: int, s: int, d: int) -> list[FlashBwdPlan]:
    """Every plan :func:`plan_flash_bwd` can choose for these shapes (on any
    SM count): each cluster size that divides the group, with the deepest
    rings (the card tests and ``chip_smoke.py`` check them all)."""
    _check_plan_args("flash_bwd_plans", b, hq, hkv, t, s, d)
    return [_plan(d, c, _deepest(d, "dkdv"), _deepest(d, "dq")) for c in _clusters(hq, hkv)]


def visible_pairs(t: int, s: int, causal: bool, window: int | None) -> int:
    """The query-key pairs the kernels' mask admits for T queries over S
    keys (the work of one (batch, head)): causal with the decode offset
    S - T, or not, each with an optional window."""
    i = np.arange(t, dtype=np.int64)
    if causal:
        j = i + (s - t)
        hi = np.minimum(s, j + 1)
        lo = np.maximum(0, j - window + 1) if window else np.zeros_like(i)
    else:
        hi = np.minimum(s, i + window) if window else np.full_like(i, s)
        lo = np.maximum(0, i - window + 1) if window else np.zeros_like(i)
    return int(np.maximum(0, hi - lo).sum())


def flash_cost(b: int, hq: int, hkv: int, t: int, s: int, d: int, dtype: torch.dtype, *,
               causal: bool = True, window: int | None = None, lse: bool = False) -> LaunchCost:
    """One launch of the forward, as PERF.md's rows 11-11k bound it: Q read
    and O written, K and V read, in their dtype (and each row's f32
    log-sum-exp written where ``lse``); 4 D operations a visible pair and
    query head (Q K^T and P V), of the dtype's class."""
    item = dtype.itemsize
    nbytes = item * (2 * b * hq * t * d + 2 * b * hkv * s * d) + (b * hq * t * 4 if lse else 0)
    flops = 4 * d * hq * b * visible_pairs(t, s, causal, window)
    return LaunchCost.of(flops, flop_class(dtype), nbytes)


def flash_bwd_cost(b: int, hq: int, hkv: int, t: int, s: int, d: int, dtype: torch.dtype, *,
                   causal: bool = True, window: int | None = None) -> LaunchCost:
    """One launch of the backward (its three kernels), as PERF.md's row B1
    bounds it: Q, O and dO read and dQ written, K and V read and dK and dV
    written, in their dtype, and the f32 log-sum-exp read; 10 D operations a
    visible pair and query head (S, dP, dV, dK, dQ)."""
    item = dtype.itemsize
    nbytes = item * (4 * b * hq * t * d + 4 * b * hkv * s * d) + b * hq * t * 4
    flops = 10 * d * hq * b * visible_pairs(t, s, causal, window)
    return LaunchCost.of(flops, flop_class(dtype), nbytes)


def _check_qkv(name, q, k, v, window):
    """One dtype (f32 or bf16), (B,Hq,T,D) and (B,Hkv,S,D) with Hkv | Hq,
    a compiled head width, a window None or >= 1, 16-byte aligned."""
    b, hq, t, d = q.shape
    _, hkv, s, _ = k.shape
    if q.dtype not in DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{name}: q/k/v dtypes {q.dtype}/{k.dtype}/"
                         f"{v.dtype} must be one of float32, bfloat16")
    if k.shape != v.shape or k.shape != (b, hkv, s, d) or hq % hkv:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}: need (B,Hq,T,D) and "
                         "(B,Hkv,S,D) with Hkv | Hq")
    dims = F32_HEAD_DIMS if q.dtype == torch.float32 else HEAD_DIMS
    if d not in dims:
        raise ValueError(f"{name}: head dim {d} not in {dims} for {q.dtype}")
    if window is not None and window < 1:
        raise ValueError(f"{name}: window must be >= 1, got {window}")
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError(f"{name}: q/k/v must be 16-byte aligned")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: int | None = None,
                         scale: float | None = None, lse: bool = False):
    """q: (B, Hq, T, D); k, v: (B, Hkv, S, D), Hkv | Hq, one dtype (f32 or
    bf16), D in :data:`HEAD_DIMS` (:data:`F32_HEAD_DIMS` in f32).  ``window``
    None or >= 1; ``scale`` defaults to D ** -0.5.  Returns (B, Hq, T, D) in
    q.dtype, and with ``lse`` also each row's log-sum-exp (B, Hq, T) f32.
    CPU tensors take the plain version."""
    if q.device.type == "cpu":
        if lse:
            return attention_ref_lse(q, k, v, causal=causal, window=window, scale=scale)
        return attention_ref(q, k, v, causal=causal, window=window, scale=scale)
    check_kernel_tensors("flash_attention_cuda", q=q, k=k, v=v)
    _check_qkv("flash_attention_cuda", q, k, v, window)
    b, hq, t, d = q.shape
    _, hkv, s, _ = k.shape
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty_like(q)
    rows = torch.empty((b, hq, t), dtype=torch.float32, device=q.device) if lse else None
    fn = load_library("flash_attention").flash_attention_fwd
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             None if rows is None else rows.data_ptr(),
             b, hq, hkv, t, s, d, int(causal), 0 if window is None else int(window),
             float(scale), DTYPE_CODE[q.dtype], launch_stream(q.device))
    if err:
        raise RuntimeError(f"flash_attention_fwd launch failed: cudaError {err}")
    flash_attention_cuda.launches += 1
    return (out, rows) if lse else out


flash_attention_cuda.launches = 0


def _check_bwd_args(name, q, k, v, o, lse, do, window, device_type="cuda"):
    check_kernel_tensors(name, device_type=device_type, q=q, k=k, v=v, o=o, lse=lse, do=do)
    _check_qkv(name, q, k, v, window)
    b, hq, t, _ = q.shape
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype or do.dtype != q.dtype:
        raise ValueError(f"{name}: o {tuple(o.shape)} {o.dtype} and do "
                         f"{tuple(do.shape)} {do.dtype} must match q {tuple(q.shape)} {q.dtype}")
    if lse.shape != (b, hq, t) or lse.dtype != torch.float32:
        raise ValueError(f"{name}: lse must be float32 {(b, hq, t)}, got "
                         f"{lse.dtype} {tuple(lse.shape)}")
    if any(x.data_ptr() % 16 for x in (o, do)):
        raise ValueError(f"{name}: o/do must be 16-byte aligned")


def _launch_bwd(q, k, v, o, lse, do, causal, window, scale, plan):
    b, hq, t, d = q.shape
    _, hkv, s, _ = k.shape
    scale = scale if scale is not None else d ** -0.5
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    bf16 = q.dtype == torch.bfloat16
    # The kernels' f32 scratch: bf16 keeps lse * log2 e and delta for rows
    # padded to BWD_DQ_ROWS; f32 keeps delta.
    rows = b * hq * (_up(t, BWD_DQ_ROWS) if bf16 else t)
    scratch = torch.empty(((2 if bf16 else 1) * rows,), dtype=torch.float32, device=q.device)
    p = plan if bf16 else FlashBwdPlan(0, 0, 0, 0, 0)
    err = load_library("flash_attention_bwd").flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
        scratch.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, hq, hkv, t, s, d,
        int(causal), 0 if window is None else int(window), float(scale), DTYPE_CODE[q.dtype],
        p.kv_tile, p.kv_stages, p.dq_keys, p.dq_stages, p.cluster, launch_stream(q.device))
    if err:
        raise RuntimeError(f"flash_attention_bwd launch failed ({plan}): cudaError {err}")
    return dq, dk, dv


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                             causal: bool = True, window: int | None = None,
                             scale: float | None = None):
    """The backward of :func:`flash_attention_cuda` from its output ``o``,
    its ``lse`` and the output cotangent ``do`` (both (B, Hq, T, D) in
    q.dtype): returns (dq, dk, dv) in q.dtype, dk and dv per KV head.  Three
    kernels on the current stream (bf16: prep, dK/dV, dQ, in
    :func:`plan_flash_bwd`'s plan; f32: delta, dK/dV, dQ), one launch
    counted in ``flash_attention_bwd_cuda.launches``.  CPU tensors take
    :func:`attention_bwd_ref`."""
    if q.device.type == "cpu":
        return attention_bwd_ref(q, k, v, o, lse, do, causal=causal, window=window,
                                 scale=scale)
    _check_bwd_args("flash_attention_bwd_cuda", q, k, v, o, lse, do, window)
    plan = None
    if q.dtype == torch.bfloat16:
        b, hq, t, d = q.shape
        plan = plan_flash_bwd(b, hq, k.shape[1], t, k.shape[2], d, sm_count(q.device))
    out = _launch_bwd(q, k, v, o, lse, do, causal, window, scale, plan)
    flash_attention_bwd_cuda.launches += 1
    return out


flash_attention_bwd_cuda.launches = 0


def flash_attention_meta(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: int | None = None,
                         scale: float | None = None, lse: bool = False):
    """:func:`flash_attention_cuda` on meta tensors: the same checks, empty
    outputs of the kernel's shapes (the f32 log-sum-exp with ``lse``), and
    the launch recorded (``core.lowering``)."""
    check_kernel_tensors("flash_attention_cuda", device_type="meta", q=q, k=k, v=v)
    _check_qkv("flash_attention_cuda", q, k, v, window)
    b, hq, t, d = q.shape
    _, hkv, s, _ = k.shape
    with kernel_scope():
        out = torch.empty_like(q)
        rows = torch.empty((b, hq, t), dtype=torch.float32, device="meta") if lse else None
    record_launch("flash_attention_cuda", flash_cost(b, hq, hkv, t, s, d, q.dtype, causal=causal,
                                                     window=window, lse=lse),
                  plan=(("causal", causal), ("window", window)))
    return (out, rows) if lse else out


def flash_attention_bwd_meta(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor, *,
                             causal: bool = True, window: int | None = None,
                             scale: float | None = None):
    """:func:`flash_attention_bwd_cuda` on meta tensors: the same checks and
    plan, empty gradients and the kernels' f32 scratch, and the launch
    recorded."""
    _check_bwd_args("flash_attention_bwd_cuda", q, k, v, o, lse, do, window, device_type="meta")
    b, hq, t, d = q.shape
    _, hkv, s, _ = k.shape
    bf16 = q.dtype == torch.bfloat16
    plan = plan_flash_bwd(b, hq, hkv, t, s, d, H100_SMS) if bf16 else None
    rows = b * hq * (_up(t, BWD_DQ_ROWS) if bf16 else t)
    with kernel_scope():
        grads = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        scratch = torch.empty(((2 if bf16 else 1) * rows,), dtype=torch.float32, device="meta")
        del scratch
    record_launch("flash_attention_bwd_cuda",
                  flash_bwd_cost(b, hq, hkv, t, s, d, q.dtype, causal=causal, window=window),
                  plan)
    return grads


def launch_bwd_plan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                    lse: torch.Tensor, do: torch.Tensor, *, plan: FlashBwdPlan,
                    causal: bool = True, window: int | None = None,
                    scale: float | None = None):
    """The bf16 backward on CUDA tensors with a given plan (one of
    :func:`flash_bwd_plans`); counts no launch.  The wrapper launches
    :func:`plan_flash_bwd`'s choice; the card tests and ``chip_smoke.py``
    check and time the others."""
    _check_bwd_args("launch_bwd_plan", q, k, v, o, lse, do, window)
    if q.dtype != torch.bfloat16:
        raise ValueError("launch_bwd_plan: the plans are the bf16 kernels'")
    b, hq, t, d = q.shape
    if plan not in flash_bwd_plans(b, hq, k.shape[1], t, k.shape[2], d):
        raise ValueError(f"launch_bwd_plan: {plan} is not a plan of these inputs")
    return _launch_bwd(q, k, v, o, lse, do, causal, window, scale, plan)


# --------------------------------------------------------------------------
# Launch declarations (``repro_torch.analysis.resources``)
# --------------------------------------------------------------------------

#: Threads of a block of the bf16 kernels (a producer warpgroup and two
#: consumers), of the f32 forward, and of the backward's prep kernel; the
#: rows a prep block takes (a warp a row).
WG_THREADS, F32_THREADS, PREP_THREADS = 384, 128, 128
#: Static shared memory of the bf16 forward: its nine mbarriers.
FWD_STATIC_SMEM = 9 * 8
_FWD = "src/repro_torch/kernels/local_attention/csrc/flash_attention.cu:"
_BWD = "src/repro_torch/kernels/local_attention/csrc/flash_attention_bwd.cu:launch_bf16"


def attention_heads(cfg):
    """(query heads, KV heads, head width) of an arch's attention, or None
    for an arch without attention layers."""
    if not any(k in ("attn", "local", "global") for k in cfg.layer_kinds):
        return None
    return cfg.num_heads + cfg.head_pad, cfg.num_kv_heads, cfg.head_dim


def _fwd_shapes(cfg):
    """(path, b, t, lse) of every forward launch shape on the arch's main
    paths.  Decoder-only serving attends in plain PyTorch; prompt scoring
    and training run flash.  The encoder-decoder arch also runs it in its
    encoder (4096 frames when scoring, 1024 in ``encode``), its decoder's
    self-attention (1024 tokens) and cross-attention (while scoring, and
    each decode step and prompt window against the frames)."""
    if cfg.is_enc_dec:
        return [("encoder", 1, 4096, False), ("decoder", 1, 1024, False),
                ("encode", 4, 1024, False), ("decode cross K=1", 4, 1, False),
                ("decode cross K=64", 4, 64, False)]
    shapes = [("scoring", *scoring_shape(cfg), False)]
    if train_microbatch(cfg):
        shapes.append(("train", *train_microbatch(cfg), True))
    return shapes


def fwd_launch(shape, b, hq, t, d, dtype, lse=False):
    """The forward's launch for (b, hq, t, d) queries: bf16 a block of
    FWD_Q_TILE query rows of one head, the last tile first; f32 a block of
    F32_Q_TILE rows."""
    code, smem = DTYPE_CODE[dtype], fwd_smem_bytes(d, dtype)
    bf16 = dtype == torch.bfloat16
    grid = ((b * hq, -(-t // FWD_Q_TILE), 1) if bf16 else (-(-t // F32_Q_TILE), b * hq, 1))
    return KernelLaunch(
        kernel="flash_attention_cuda", location=_FWD + ("launch_bf16" if bf16 else "launch_f32"),
        shape=shape, grid=grid, threads=WG_THREADS if bf16 else F32_THREADS,
        dynamic_smem=smem, static_smem=FWD_STATIC_SMEM if bf16 else None,
        library="flash_attention", occupancy=(0, d, code, int(lse)),
        queries=(("flash_fwd_smem", (d, code), smem),),
        meta=(("b", b), ("hq", hq), ("t", t), ("d", d)))


def bwd_launches(shape, b, hq, hkv, t, s, d, sms):
    """The bf16 backward's three launches in :func:`plan_flash_bwd`'s plan:
    prep (a warp a padded query row), dK/dV (a cluster of ``plan.cluster``
    blocks a KV head and key tile) and dQ (BWD_DQ_ROWS queries a block)."""
    plan = plan_flash_bwd(b, hq, hkv, t, s, d, sms)
    tp = _up(t, BWD_DQ_ROWS)
    kv_smem = bwd_smem_bytes(d, "dkdv", plan.kv_stages)
    dq_smem = bwd_smem_bytes(d, "dq", plan.dq_stages)
    meta = (("b", b), ("hq", hq), ("hkv", hkv), ("t", t), ("d", d))
    common = dict(shape=shape, library="flash_attention_bwd", location=_BWD, meta=meta,
                  kernel="flash_attention_bwd_cuda")
    return [
        KernelLaunch(grid=(-(-b * hq * tp // (PREP_THREADS // 32)), 1, 1),
                     threads=PREP_THREADS, dynamic_smem=0, occupancy=(2, d, 0), **common),
        KernelLaunch(grid=(b * hkv * plan.cluster, -(-s // plan.kv_tile), 1),
                     threads=WG_THREADS, cluster=(plan.cluster, 1, 1), dynamic_smem=kv_smem,
                     occupancy=(0, d, plan.kv_stages),
                     queries=(("flash_bwd_smem", (d, 0, plan.kv_stages), kv_smem),), **common),
        KernelLaunch(grid=(b * hq, tp // BWD_DQ_ROWS, 1), threads=WG_THREADS,
                     dynamic_smem=dq_smem, occupancy=(1, d, plan.dq_stages),
                     queries=(("flash_bwd_smem", (d, 1, plan.dq_stages), dq_smem),), **common),
    ]


def _fwd_spec(cfg, sms):
    heads = attention_heads(cfg)
    if heads is None:
        return []
    hq, _, d = heads
    dtype = getattr(torch, cfg.dtype)
    return [fwd_launch(f"{path} B={b} T={t}", b, hq, t, d, dtype, lse)
            for path, b, t, lse in _fwd_shapes(cfg)]


def _bwd_spec(cfg, sms):
    heads = attention_heads(cfg)
    if heads is None or not train_microbatch(cfg):
        return []
    hq, hkv, d = heads
    b, t = train_microbatch(cfg)
    return bwd_launches(f"train B={b} T={t}", b, hq, hkv, t, t, d, sms)


register_launch_spec("flash_attention_cuda", _fwd_spec)
register_launch_spec("flash_attention_bwd_cuda", _bwd_spec)
