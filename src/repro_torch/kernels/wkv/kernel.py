"""Chunked RWKV6 WKV forward: the CUDA kernel ``csrc/wkv_chunked.cu`` and
its plain PyTorch version, for inference and for training, with and
without the segment summary.

Counterparts of ``repro.kernels.wkv.kernel.wkv_pallas``,
``wkv_pallas_train``, ``wkv_pallas_summary`` and
``wkv_pallas_train_summary``.  The Pallas kernel
walks a ``(batch, head, chunk)`` grid in order and carries the (Dh × Dh)
state S in a VMEM scratch; the CUDA kernel loops over the chunks inside one
block per (batch·head, value-column tile) and keeps its S tile in shared
memory for the whole sweep (see the note at the top of the source).  The
tile's width comes from :func:`plan_columns`, pure Python: it depends on the
shape, the chunk, the dtype and the card's SM count, never on where the
inputs lie (a T-window launch and a contiguous one take the same plan), and
the outputs are bit-equal across plans.

:func:`wkv_cuda` is the wrapper: on CUDA tensors it launches the kernel
(counting the launch in ``wkv_cuda.launches``) or raises; on CPU tensors it
runs :func:`wkv_plain`.  :func:`wkv_train_cuda` is the training forward:
the same kernel with its ``s_hist`` output on (the state entering each
chunk, the one residual the backward keeps), counted in
``wkv_train_cuda.launches``; its plain version is :func:`wkv_train_plain`.
:func:`wkv_summary_cuda` and :func:`wkv_train_summary_cuda` are the same
two sweeps that also return ``a_seg`` (B, H, 64) f32, the product of the
segment's decays: the decay half of the (A, S) segment summary the
sequence-parallel path (:mod:`repro_torch.kernels.wkv.seqpar`) composes
across shards.  Their r/k/v/w may be T-windows of longer tensors (views
``x[:, :, s0:s1]`` of contiguous (B, H, T, 64) tensors), which the kernel
reads in place; their plain versions are :func:`wkv_summary_plain` and
:func:`wkv_train_summary_plain`.
No wrapper takes tensors that require grad: gradients go through
:class:`repro_torch.kernels.wkv.vjp.WKVFunction` and
:class:`~repro_torch.kernels.wkv.vjp.WKVSummaryFunction`.
"""

from __future__ import annotations

import torch

from repro_torch.core.lowering import LaunchCost, kernel_scope, plain_version, record_launch
from repro_torch.kernels.common import (
    DTYPE_CODE,
    H100_SMS,
    SEQ_GRAD,
    SEQ_PROMPT,
    SEQ_SHARDS,
    SERVE_BATCH,
    SERVE_PROMPT,
    SMEM_LIMIT,
    KernelLaunch,
    check_kernel_tensors,
    launch_stream,
    load_library,
    register_launch_spec,
    scoring_shape,
    sm_count,
    train_microbatch,
    validate_divisible,
)
from repro_torch.kernels.wkv.ref import (
    wkv_chunked_hist_ref,
    wkv_chunked_ref,
    wkv_segment_decay,
)

__all__ = ["WKV_DH", "MAX_CHUNK", "COL_TILES", "SMEM_LIMIT", "padded_chunk",
           "fwd_smem_bytes", "plan_columns", "launch_plan", "wkv_cuda",
           "wkv_plain", "wkv_train_cuda", "wkv_train_plain", "wkv_summary_cuda",
           "wkv_summary_plain", "wkv_train_summary_cuda", "wkv_train_summary_plain",
           "check_wkv_args", "row_stride", "chunked_cost", "wkv_meta", "wkv_train_meta",
           "wkv_summary_meta", "wkv_train_summary_meta"]

#: Head width the CUDA kernels are written for (the model's RWKV head dim).
WKV_DH = 64
#: Largest chunk the chunked kernel takes (its shared-memory tiles).
MAX_CHUNK = 64
#: The value-column tiles one block of the chunked kernel may take, widest
#: first.
COL_TILES = (64, 32, 16, 8)
#: The blocks the chunked kernel's plan aims to keep resident on each SM
#: (a block's two roles are 12 warps), and the share of that it must reach.
BLOCKS_PER_SM, FILL = 1, 0.9


def _up128(x: int) -> int:
    return -(-x // 128) * 128


def padded_chunk(chunk: int) -> int:
    """The chunk the kernels' tiles are sized for: ``chunk`` rounded up to a
    power of two, at least 4."""
    return next(p for p in (4, 8, 16, 32, 64) if chunk <= p)


def fwd_smem_bytes(chunk: int, col_tile: int, itemsize: int) -> int:
    """Shared memory of one block of ``csrc/wkv_chunked.cu`` (its
    ``fit_layout``, region by region, 128-byte aligned): the ring stages of
    r/k/w rows and the v tile (two, or one where two do not fit), two
    hand-off slots (r_dec^T, k_rem, v, the masked score planes, the bonus's
    warp partials, w_total), two k_inv^T tiles, the bonus and the summed
    scores, out's five partial planes and two S tiles.  The source's ``wkv_chunked_smem`` returns the
    same (a card test holds them equal)."""
    lp = padded_chunk(chunk)
    ld = lp + 4
    planes = 4 if lp <= 16 else 1
    ring = _up128(128 + 4 * WKV_DH)
    row = _up128(lp * WKV_DH * itemsize)
    stage = _up128(3 * row + lp * col_tile * itemsize)
    slot = (_up128(WKV_DH * ld * 4) + _up128(lp * WKV_DH * 4) + _up128(lp * col_tile * 4)
            + _up128(planes * lp * ld * 4) + _up128(8 * lp * 4) + _up128(4 * WKV_DH))
    rest = (2 * _up128(WKV_DH * ld * 4) + _up128(lp * 4) + _up128(lp * ld * 4)
            + _up128(5 * lp * col_tile * 4) + 2 * _up128(WKV_DH * col_tile * 4))
    two = ring + 2 * stage + 2 * slot + rest
    return two if two <= SMEM_LIMIT else two - stage


def plan_columns(b: int, h: int, t: int, chunk: int, dtype: torch.dtype, sms: int) -> int:
    """The value columns one block of the chunked kernel takes (one of
    :data:`COL_TILES`) for (b, h, t, 64) inputs at ``chunk`` on a card of
    ``sms`` SMs: the widest tile whose blocks (b·h·64/tile) reach ``FILL``
    of ``BLOCKS_PER_SM`` per SM, else the narrowest, among the tiles whose
    shared memory fits.  A narrower tile repeats the decay factors and the
    scores in more blocks but shortens each block's products; the outputs do
    not change.  ``t`` enters only through ``chunk``: the plan never sees
    the T stride of a window."""
    if dtype not in DTYPE_CODE:
        raise ValueError(f"plan_columns: dtype {dtype} not supported (float32, bfloat16)")
    validate_divisible("T", t, chunk)
    item = torch.empty((), dtype=dtype).element_size()
    fits = [c for c in COL_TILES if fwd_smem_bytes(chunk, c, item) <= SMEM_LIMIT]
    for tile in fits:
        if b * h * (WKV_DH // tile) >= FILL * BLOCKS_PER_SM * sms:
            return tile
    return fits[-1]


def check_wkv_args(name, r, k, v, w, u, h0, *, t_window=False, device_type="cuda"):
    """Validate kernel inputs: one CUDA device (the meta device for the
    meta twins), f32/bf16 r/k/v/w/u of one dtype, f32 h0, the (B,H,T,64)
    layout, contiguity, and no autograd.  With ``t_window`` r/k/v/w may
    instead be T-windows of longer contiguous tensors, all four alike.
    Returns the token count between consecutive (b, h) rows of r/k/v/w (T
    when they are contiguous)."""
    b, h, t, dh = r.shape
    tensors = {"r": r, "k": k, "v": v, "w": w, "u": u, "h0": h0}
    check_kernel_tensors(name, strided=("r", "k", "v", "w") if t_window else (),
                         device_type=device_type, **tensors)
    if r.dtype not in DTYPE_CODE:
        raise ValueError(f"{name}: dtype {r.dtype} not supported (float32, bfloat16)")
    for key in ("k", "v", "w", "u"):
        if tensors[key].dtype != r.dtype:
            raise ValueError(f"{name}: {key} dtype {tensors[key].dtype} != r dtype {r.dtype}")
    if h0.dtype != torch.float32:
        raise ValueError(f"{name}: h0 must be float32, got {h0.dtype}")
    for key in ("k", "v", "w"):
        if tensors[key].shape != r.shape:
            raise ValueError(f"{name}: {key} shape {tuple(tensors[key].shape)} != {tuple(r.shape)}")
    if dh != WKV_DH:
        raise ValueError(f"{name}: head dim {dh} != {WKV_DH}")
    if u.shape != (h, dh):
        raise ValueError(f"{name}: u shape {tuple(u.shape)} != {(h, dh)}")
    if h0.shape != (b, h, dh, dh):
        raise ValueError(f"{name}: h0 shape {tuple(h0.shape)} != {(b, h, dh, dh)}")
    return row_stride(name, r, k, v, w)


def row_stride(name, r, k, v, w):
    """Tokens between consecutive (b, h) rows of r/k/v/w, which are
    contiguous or T-windows ``x[:, :, s0:s1]`` of contiguous tensors with
    one layout."""
    b, h, t, dh = r.shape
    if all(x.is_contiguous() for x in (r, k, v, w)):
        return t
    strides = {x.stride() for x in (r, k, v, w)}
    row = r.stride(1) if h > 1 else (r.stride(0) if b > 1 else t * dh)
    if (len(strides) > 1 or r.stride(3) != 1 or r.stride(2) != dh or row % dh
            or row < t * dh or (b > 1 and h > 1 and r.stride(0) != h * row)):
        raise ValueError(
            f"{name}: r/k/v/w must be contiguous or T-windows of contiguous "
            f"(B, H, T, {dh}) tensors with one layout, got strides {sorted(strides)}")
    return row // dh


@plain_version
def wkv_plain(r, k, v, w, u, h0, *, chunk: int):
    """Plain version: :func:`wkv_chunked_ref` with ``out`` in r.dtype."""
    out, s = wkv_chunked_ref(r, k, v, w, u, h0, chunk)
    return out.to(r.dtype), s


#: (s_hist, a_seg) outputs on -> the C entry point of wkv_chunked.cu.
_ENTRIES = {
    (False, False): "wkv_chunked_fwd",
    (True, False): "wkv_chunked_train_fwd",
    (False, True): "wkv_chunked_summary_fwd",
    (True, True): "wkv_chunked_train_summary_fwd",
}


def _launch_chunked(name, r, k, v, w, u, h0, chunk, with_hist, with_summary=False,
                    col_tile=None):
    """Check the inputs, allocate the outputs and launch the chunked kernel
    (its ``s_hist`` and ``a_seg`` outputs on or off; the summary entries
    read T-windows in place) with ``col_tile`` value columns a block, or
    :func:`plan_columns`'s choice.  Returns (out, S[, s_hist][, a_seg])."""
    b, h, t, dh = r.shape
    if chunk > MAX_CHUNK:
        raise ValueError(f"{name}: chunk={chunk} > {MAX_CHUNK}")
    t_stride = check_wkv_args(name, r, k, v, w, u, h0, t_window=with_summary)
    if col_tile is None:
        col_tile = plan_columns(b, h, t, chunk, r.dtype, sm_count(r.device))
    dev, f32 = r.device, torch.float32
    outs = [torch.empty(r.shape, dtype=r.dtype, device=dev),
            torch.empty((b, h, dh, dh), dtype=f32, device=dev)]
    if with_hist:
        outs.append(torch.empty((b, h, t // chunk, dh, dh), dtype=f32, device=dev))
    ints = [b, h, t, dh, chunk, DTYPE_CODE[r.dtype], col_tile]
    if with_summary:
        outs.append(torch.empty((b, h, dh), dtype=f32, device=dev))
        ints.insert(3, t_stride)
    entry = _ENTRIES[(with_hist, with_summary)]
    fn = getattr(load_library("wkv_chunked"), entry)
    err = fn(*(x.data_ptr() for x in (r, k, v, w, u, h0, *outs)),
             *ints, launch_stream(dev))
    if err:
        raise RuntimeError(f"{entry} launch failed: error {err} (a cudaError_t, or "
                           "10000 + the CUresult of a tensor map)")
    return tuple(outs)


def launch_plan(r, k, v, w, u, h0, *, chunk: int, col_tile: int, hist: bool = False,
                summary: bool = False):
    """Launch the chunked kernel on CUDA tensors with a given column tile
    (one of :data:`COL_TILES` whose shared memory fits) and the ``s_hist``
    and ``a_seg`` outputs on or off; counts no launch.  The wrappers launch
    :func:`plan_columns`'s choice; the card tests and ``chip_smoke.py``
    compare and time the others."""
    validate_divisible("T", r.shape[2], chunk)
    return _launch_chunked("launch_plan", r, k, v, w, u, h0, chunk, with_hist=hist,
                           with_summary=summary, col_tile=col_tile)


def wkv_cuda(r, k, v, w, u, h0, *, chunk: int):
    """Fused chunked WKV sweep.  r/k/v/w: (B, H, T, 64); u: (H, 64);
    h0: (B, H, 64, 64) f32; ``chunk`` divides T, 1..64.  Returns
    (out (B,H,T,64) r.dtype, S (B,H,64,64) f32).  CPU tensors take the
    plain version."""
    validate_divisible("T", r.shape[2], chunk)
    if r.device.type == "cpu":
        return wkv_plain(r, k, v, w, u, h0, chunk=chunk)
    outs = _launch_chunked("wkv_cuda", r, k, v, w, u, h0, chunk, with_hist=False)
    wkv_cuda.launches += 1
    return outs


wkv_cuda.launches = 0


def wkv_train_plain(r, k, v, w, u, h0, *, chunk: int):
    """Plain version of the training forward: (out in r.dtype, S f32,
    s_hist (B, H, T/chunk, Dh, Dh) f32)."""
    out, s, hist = wkv_chunked_hist_ref(r, k, v, w, u, h0, chunk)
    return out.to(r.dtype), s, hist


def wkv_train_cuda(r, k, v, w, u, h0, *, chunk: int):
    """The training forward sweep: :func:`wkv_cuda` that also returns
    ``s_hist`` (B, H, T/chunk, 64, 64) f32, the state entering each chunk.
    CPU tensors take the plain version."""
    validate_divisible("T", r.shape[2], chunk)
    if r.device.type == "cpu":
        return wkv_train_plain(r, k, v, w, u, h0, chunk=chunk)
    outs = _launch_chunked("wkv_train_cuda", r, k, v, w, u, h0, chunk, with_hist=True)
    wkv_train_cuda.launches += 1
    return outs


wkv_train_cuda.launches = 0


def wkv_summary_plain(r, k, v, w, u, h0, *, chunk: int):
    """Plain version of the summary forward: (out in r.dtype, S f32,
    a_seg (B, H, Dh) f32)."""
    out, s = wkv_plain(r, k, v, w, u, h0, chunk=chunk)
    return out, s, wkv_segment_decay(w)


def wkv_summary_cuda(r, k, v, w, u, h0, *, chunk: int):
    """:func:`wkv_cuda` that also returns ``a_seg`` (B, H, 64) f32, the
    product of the segment's clipped decays.  r/k/v/w may be T-windows of
    longer contiguous tensors.  CPU tensors take the plain version."""
    validate_divisible("T", r.shape[2], chunk)
    if r.device.type == "cpu":
        return wkv_summary_plain(r, k, v, w, u, h0, chunk=chunk)
    outs = _launch_chunked("wkv_summary_cuda", r, k, v, w, u, h0, chunk,
                           with_hist=False, with_summary=True)
    wkv_summary_cuda.launches += 1
    return outs


wkv_summary_cuda.launches = 0


def wkv_train_summary_plain(r, k, v, w, u, h0, *, chunk: int):
    """Plain version of the training summary forward: (out in r.dtype,
    S f32, s_hist f32, a_seg f32)."""
    return (*wkv_train_plain(r, k, v, w, u, h0, chunk=chunk), wkv_segment_decay(w))


def wkv_train_summary_cuda(r, k, v, w, u, h0, *, chunk: int):
    """The training forward with the segment summary: (out, S, s_hist,
    a_seg) from one sweep.  r/k/v/w may be T-windows of longer contiguous
    tensors.  CPU tensors take the plain version."""
    validate_divisible("T", r.shape[2], chunk)
    if r.device.type == "cpu":
        return wkv_train_summary_plain(r, k, v, w, u, h0, chunk=chunk)
    outs = _launch_chunked("wkv_train_summary_cuda", r, k, v, w, u, h0, chunk,
                           with_hist=True, with_summary=True)
    wkv_train_summary_cuda.launches += 1
    return outs


wkv_train_summary_cuda.launches = 0


# --------------------------------------------------------------------------
# The meta branch: each wrapper's twin on meta tensors (``core.lowering``)
# --------------------------------------------------------------------------

def chunked_cost(b: int, h: int, t: int, chunk: int, dtype: torch.dtype, *,
                 hist: bool = False, summary: bool = False) -> LaunchCost:
    """One launch of the chunked forward, as PERF.md's rows 1, 4, 6 and 7
    bound it.  Bytes: r, k, v, w read and out written in the inputs' dtype,
    u in it too, h0 read and S written in f32, and ``s_hist`` (a state a
    chunk) and ``a_seg`` written in f32 where they are on.  Operations in f32
    (the CUDA cores), a multiply-add as two, per chunk of L: L(L-1) Dh
    (scores), 2 L^2 Dh (intra) and 4 L Dh^2 (inter and the state update)."""
    item, dh, n = dtype.itemsize, WKV_DH, t // chunk
    state = b * h * dh * dh * 4
    nbytes = 5 * b * h * t * dh * item + h * dh * item + 2 * state
    nbytes += n * state if hist else 0
    nbytes += b * h * dh * 4 if summary else 0
    flops = b * h * n * (chunk * (chunk - 1) * dh + 2 * chunk * chunk * dh
                         + 4 * chunk * dh * dh)
    return LaunchCost.of(flops, "f32", nbytes)


def _chunked_meta(name, r, k, v, w, u, h0, chunk, hist, summary):
    """The meta twin of :func:`_launch_chunked`: the same checks and plan,
    empty outputs of the kernel's shapes, and the launch recorded."""
    b, h, t, dh = r.shape
    validate_divisible("T", t, chunk)
    if chunk > MAX_CHUNK:
        raise ValueError(f"{name}: chunk={chunk} > {MAX_CHUNK}")
    check_wkv_args(name, r, k, v, w, u, h0, t_window=summary, device_type="meta")
    col = plan_columns(b, h, t, chunk, r.dtype, H100_SMS)
    f32 = torch.float32
    with kernel_scope():
        outs = [torch.empty(r.shape, dtype=r.dtype, device="meta"),
                torch.empty((b, h, dh, dh), dtype=f32, device="meta")]
        if hist:
            outs.append(torch.empty((b, h, t // chunk, dh, dh), dtype=f32, device="meta"))
        if summary:
            outs.append(torch.empty((b, h, dh), dtype=f32, device="meta"))
    record_launch(name, chunked_cost(b, h, t, chunk, r.dtype, hist=hist, summary=summary),
                  plan=(("col_tile", col),))
    return tuple(outs)


def wkv_meta(r, k, v, w, u, h0, *, chunk: int):
    """:func:`wkv_cuda` on meta tensors."""
    return _chunked_meta("wkv_cuda", r, k, v, w, u, h0, chunk, False, False)


def wkv_train_meta(r, k, v, w, u, h0, *, chunk: int):
    """:func:`wkv_train_cuda` on meta tensors."""
    return _chunked_meta("wkv_train_cuda", r, k, v, w, u, h0, chunk, True, False)


def wkv_summary_meta(r, k, v, w, u, h0, *, chunk: int):
    """:func:`wkv_summary_cuda` on meta tensors."""
    return _chunked_meta("wkv_summary_cuda", r, k, v, w, u, h0, chunk, False, True)


def wkv_train_summary_meta(r, k, v, w, u, h0, *, chunk: int):
    """:func:`wkv_train_summary_cuda` on meta tensors."""
    return _chunked_meta("wkv_train_summary_cuda", r, k, v, w, u, h0, chunk, True, True)


# --------------------------------------------------------------------------
# Launch declarations (``repro_torch.analysis.resources``)
# --------------------------------------------------------------------------

#: Threads of a block of the chunked kernel: its prep and carry roles.
FWD_THREADS = 512
_LOCATION = "src/repro_torch/kernels/wkv/csrc/wkv_chunked.cu:launch"


def rwkv_geometry(cfg):
    """(heads, the model's chunk, the inputs' dtype) of an RWKV arch's WKV
    launches, or None for an arch without RWKV layers."""
    if not cfg.rwkv:
        return None
    from repro_torch.model.recurrent import WKV_CHUNK

    return cfg.d_model // WKV_DH, WKV_CHUNK, getattr(torch, cfg.dtype)


def chunked_launch(kernel, shape, b, h, t, chunk, dtype, sms):
    """The chunked kernel's launch for (b, h, t, 64) inputs at ``chunk``:
    :func:`plan_columns`'s tile, one block a (b, h) and column tile."""
    col = plan_columns(b, h, t, chunk, dtype, sms)
    code, item = DTYPE_CODE[dtype], dtype.itemsize
    return KernelLaunch(
        kernel=kernel, location=_LOCATION, shape=shape, grid=(WKV_DH // col, b * h, 1),
        threads=FWD_THREADS, dynamic_smem=fwd_smem_bytes(chunk, col, item),
        library="wkv_chunked", occupancy=(0, chunk, col, code),
        queries=(("wkv_chunked_smem", (chunk, col, code), fwd_smem_bytes(chunk, col, item)),),
        meta=(("b", b), ("h", h), ("t", t), ("chunk", chunk), ("col_tile", col)))


def _fwd_spec(kernel, shapes):
    """A spec over ``shapes(cfg)``: (path, b, t) triples."""
    def spec(cfg, sms):
        geo = rwkv_geometry(cfg)
        if geo is None:
            return []
        h, chunk, dtype = geo
        return [chunked_launch(kernel, f"{path} B={b} T={t}", b, h, t, chunk,
                               dtype, sms) for path, b, t in shapes(cfg)]
    return spec


register_launch_spec("wkv_cuda", _fwd_spec("wkv_cuda", lambda cfg: [
    ("prefill", SERVE_BATCH, SERVE_PROMPT), ("scoring", *scoring_shape(cfg))]))
register_launch_spec("wkv_train_cuda", _fwd_spec("wkv_train_cuda", lambda cfg: [
    ("train", *train_microbatch(cfg))] if train_microbatch(cfg) else []))
register_launch_spec("wkv_summary_cuda", _fwd_spec("wkv_summary_cuda", lambda cfg: [
    ("seq prefill shard", 1, SEQ_PROMPT // SEQ_SHARDS),
    ("seq generate shard", 2, SEQ_GRAD // SEQ_SHARDS)]))
register_launch_spec("wkv_train_summary_cuda", _fwd_spec("wkv_train_summary_cuda", lambda cfg: [
    ("seq gradient shard", 1, SEQ_GRAD // SEQ_SHARDS)]))
