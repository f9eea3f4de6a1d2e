"""Public op: the fused WKV recurrence with device dispatch.

Counterpart of ``repro.kernels.wkv.ops.wkv_fused``, with the same contract:

* ``use_kernel=None`` takes the CUDA kernels for CUDA tensors and the
  plain PyTorch versions for CPU tensors; ``True`` forces the kernels and
  raises on CPU tensors; ``False`` forces the plain versions.
* ``decode=True`` marks a stateful serving call: windows of at most
  :data:`~repro_torch.kernels.wkv.decode.DECODE_WINDOW_MAX` tokens take the
  decode kernels (the single step at T == 1, the window otherwise); longer
  sweeps take the chunked kernel.  ``decode=None`` infers ``T == 1``.
* ``chunk`` is a request: when it does not divide T, the largest divisor
  below it is used, with a warning once per ``(T, chunk)`` per warn scope.
* ``h0=None`` means zeros; ``out`` comes back in r.dtype and S in f32.
"""

from __future__ import annotations

import warnings

import torch

from repro_torch.kernels.common import largest_divisor_chunk
from repro_torch.kernels.wkv.decode import (
    DECODE_WINDOW_MAX,
    wkv_decode_cuda,
    wkv_decode_plain,
    wkv_decode_window_cuda,
)
from repro_torch.kernels.wkv.kernel import wkv_cuda, wkv_plain

# (T, chunk) pairs already warned about, keyed by warn scope.
_CHUNK_WARNED: dict[str | None, set[tuple[int, int]]] = {}


def reset_chunk_warnings(scope: str | None = None):
    """Forget the (T, chunk) pairs warned about in ``scope``."""
    _CHUNK_WARNED.pop(scope, None)


def resolve_chunk(t: int, chunk: int, *, scope: str | None = None) -> int:
    """Largest divisor of ``t`` no larger than ``chunk``; warns on adjust
    (once per distinct ``(t, chunk)`` per warn scope)."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    c = largest_divisor_chunk(t, chunk)
    if c != min(chunk, t):
        seen = _CHUNK_WARNED.setdefault(scope, set())
        if (t, chunk) not in seen:
            seen.add((t, chunk))
            warnings.warn(
                f"wkv chunk={chunk} does not divide T={t}; using chunk={c}",
                stacklevel=3,
            )
    return c


def wkv_fused(r, k, v, w, u, h0=None, *, chunk: int = 64,
              use_kernel: bool | None = None, decode: bool | None = None,
              warn_scope: str | None = None):
    """RWKV6 WKV:  S_t = diag(w_t) S_{t-1} + k_t^T v_t;
    o_t = r_t · (S_{t-1} + u k_t^T v_t).

    r/k/v/w: (B, H, T, Dh); u: (H, Dh); h0: (B, H, Dh, Dh) or None (zeros).
    Returns ``(out, S_out)``: out (B,H,T,Dh) in r.dtype, S_out f32.
    """
    b, h, t, dh = r.shape
    if h0 is None:
        h0 = torch.zeros((b, h, dh, dh), dtype=torch.float32, device=r.device)
    kernel = r.is_cuda if use_kernel is None else use_kernel
    if kernel and not r.is_cuda:
        raise ValueError(
            "wkv_fused(use_kernel=True) needs CUDA tensors; the CUDA kernels "
            f"cannot run on {r.device}")
    if decode is None:
        decode = t == 1
    if decode and t <= DECODE_WINDOW_MAX:
        if not kernel:
            return wkv_decode_plain(r, k, v, w, u, h0)
        if t == 1:
            return wkv_decode_cuda(r, k, v, w, u, h0)
        return wkv_decode_window_cuda(r, k, v, w, u, h0)
    c = resolve_chunk(t, chunk, scope=warn_scope)
    if not kernel:
        return wkv_plain(r, k, v, w, u, h0, chunk=c)
    return wkv_cuda(r, k, v, w, u, h0, chunk=c)
