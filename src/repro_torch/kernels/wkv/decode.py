"""WKV decode kernels: the single step and the K-token window, both on the
CUDA kernel ``csrc/wkv_decode.cu``, and their plain PyTorch versions.

Counterparts of ``repro.kernels.wkv.decode.wkv_decode_pallas`` and
``wkv_decode_window_pallas``.  One token: ``o = r @ S + (r·u·k) v``,
``S' = diag(w) S + kᵀv``, f32 accumulation.  The window runs K such steps in
one launch with S held in registers, so S crosses device memory once per
window.  The single step is the window kernel at K = 1, which keeps a
window bit-identical to K chained single steps; each entry point keeps its
own wrapper and launch count (``wkv_decode_cuda.launches``,
``wkv_decode_window_cuda.launches``).  CPU tensors take the plain version.

A block of the kernel owns one (batch, head) and a tile of its 64 value
columns, 8 a warp; :func:`plan_decode_columns` (pure Python) picks the tile
from the shape, the window, the dtype and the card's SM count.  Every sum
runs in an order the tile does not change, so the outputs are bit-equal
across plans.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.common import DTYPE_CODE, launch_stream, load_library, sm_count
from repro_torch.kernels.wkv.kernel import WKV_DH, check_wkv_args
from repro_torch.kernels.wkv.ref import wkv_sequential_ref

# Stateful (decode) dispatches at or below this many tokens take the window
# kernel; longer ones take the chunked kernel.
DECODE_WINDOW_MAX = 64
#: The value columns one block of the decode kernel may take, widest first
#: (8 a warp, so 8 to 1 warps a block).
DECODE_TILES = (64, 32, 16, 8)
#: The share of the SMs the plan's blocks (one (batch, head) and a column
#: tile each) must reach: for a window of at most DECODE_SHORT tokens, and
#: for a longer one, whose staging (growing with the window) wider blocks
#: share among more warps.
DECODE_SHORT, DECODE_FILL, DECODE_FILL_LONG = 8, 0.9, 0.45

__all__ = [
    "DECODE_WINDOW_MAX",
    "DECODE_TILES",
    "decode_smem_bytes",
    "plan_decode_columns",
    "launch_plan",
    "wkv_decode_cuda",
    "wkv_decode_window_cuda",
    "wkv_decode_plain",
]


def _up128(x: int) -> int:
    return -(-x // 128) * 128


def decode_smem_bytes(k: int, itemsize: int) -> int:
    """Dynamic shared memory of one block of ``csrc/wkv_decode.cu`` for a
    ``k``-token window, 128-byte aligned regions: the staging barrier, the k
    bonuses (f32), u[h] and the r, k, w, v slabs (k × 64 each) in the
    inputs' dtype, and for bf16 the same slabs widened to f32.  The source's
    ``wkv_decode_smem`` returns the same (a card test holds them equal).  It
    does not depend on the column tile: a block stages its (batch, head)'s
    whole slabs."""
    slabs = 4 * k * WKV_DH
    wide = 0 if itemsize == 4 else 4 * slabs
    return 128 + _up128(4 * k) + _up128(WKV_DH * itemsize) + slabs * itemsize + wide


def plan_decode_columns(b: int, h: int, k: int, dtype: torch.dtype, sms: int) -> int:
    """The value columns one block of the decode kernel takes (one of
    :data:`DECODE_TILES`) for a ``k``-token window of (b, h) heads on a card
    of ``sms`` SMs: the widest tile whose blocks (b·h·64/tile) reach
    :data:`DECODE_FILL` of the SMs (:data:`DECODE_FILL_LONG` for a window of
    more than :data:`DECODE_SHORT` tokens), else the narrowest.  Each warp
    runs its 8 columns through the whole window whatever the tile; what the
    tile trades is the staging every block does for its (batch, head) (the
    bulk copies of the whole r/k/w/v slabs, their widening to f32 and the
    bonuses), shared by more warps in a wider block, against the SMs the
    blocks reach.  At B=1 (``chip_smoke.py`` phase 4 times every tile) a
    block of 2 warps on every SM was the fastest up to 8 tokens and one of 4
    warps on half the SMs from 32 tokens on.  ``k`` and the dtype also set
    the block's shared memory (:func:`decode_smem_bytes`, at most 97 KB,
    bf16 at k = 64), which fits every tile."""
    if dtype not in DTYPE_CODE:
        raise ValueError(f"plan_decode_columns: dtype {dtype} not supported "
                         "(float32, bfloat16)")
    if not 1 <= k <= DECODE_WINDOW_MAX:
        raise ValueError(f"plan_decode_columns: window of {k} tokens outside "
                         f"1..{DECODE_WINDOW_MAX}")
    fill = DECODE_FILL if k <= DECODE_SHORT else DECODE_FILL_LONG
    for tile in DECODE_TILES:
        if b * h * (WKV_DH // tile) >= fill * sms:
            return tile
    return DECODE_TILES[-1]


def wkv_decode_plain(r, k, v, w, u, h0):
    """Plain version of both decode kernels: the sequential loop, ``out``
    in r.dtype."""
    out, s = wkv_sequential_ref(r, k, v, w, u, h0)
    return out.to(r.dtype), s


def _launch(name, r, k, v, w, u, h0, col_tile=None):
    """Check the inputs, allocate the outputs and launch the window kernel
    with ``col_tile`` value columns a block, or :func:`plan_decode_columns`'s
    choice.  Returns (out, S)."""
    b, h, t, dh = r.shape
    if not 1 <= t <= DECODE_WINDOW_MAX:
        raise ValueError(f"{name}: window of {t} tokens outside 1..{DECODE_WINDOW_MAX}")
    check_wkv_args(name, r, k, v, w, u, h0)
    if col_tile is None:
        col_tile = plan_decode_columns(b, h, t, r.dtype, sm_count(r.device))
    out = torch.empty_like(r)
    s_out = torch.empty((b, h, dh, dh), dtype=torch.float32, device=r.device)
    err = load_library("wkv_decode").wkv_decode_window_fwd(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        h0.data_ptr(), out.data_ptr(), s_out.data_ptr(), b, h, t, dh,
        DTYPE_CODE[r.dtype], col_tile, launch_stream(r.device))
    if err:
        raise RuntimeError(f"wkv_decode_window_fwd launch failed: cudaError {err}")
    return out, s_out


def launch_plan(r, k, v, w, u, h0, *, col_tile: int):
    """Launch the decode kernel on CUDA tensors with a given column tile (one
    of :data:`DECODE_TILES`); counts no launch.  The wrappers launch
    :func:`plan_decode_columns`'s choice; the card tests and
    ``chip_smoke.py`` compare and time the others."""
    return _launch("launch_plan", r, k, v, w, u, h0, col_tile)


def wkv_decode_cuda(r, k, v, w, u, h0):
    """Single decode step.  r/k/v/w: (B, H, 1, 64); u: (H, 64);
    h0: (B, H, 64, 64) f32.  Returns (out (B,H,1,64) r.dtype, S f32)."""
    if r.shape[2] != 1:
        raise ValueError(f"wkv_decode_cuda is single-step; got T={r.shape[2]}")
    if r.device.type == "cpu":
        return wkv_decode_plain(r, k, v, w, u, h0)
    res = _launch("wkv_decode_cuda", r, k, v, w, u, h0)
    wkv_decode_cuda.launches += 1
    return res


def wkv_decode_window_cuda(r, k, v, w, u, h0):
    """K-token decode window, 1 <= K <= 64.  r/k/v/w: (B, H, K, 64);
    u: (H, 64); h0: (B, H, 64, 64) f32.  Returns (out (B,H,K,64) r.dtype,
    S f32), bit-identical to K chained :func:`wkv_decode_cuda` steps."""
    if r.device.type == "cpu":
        return wkv_decode_plain(r, k, v, w, u, h0)
    res = _launch("wkv_decode_window_cuda", r, k, v, w, u, h0)
    wkv_decode_window_cuda.launches += 1
    return res


wkv_decode_cuda.launches = 0
wkv_decode_window_cuda.launches = 0
