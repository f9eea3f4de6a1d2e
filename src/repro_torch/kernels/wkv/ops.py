"""Public op: the fused WKV recurrence with device dispatch.

Counterpart of ``repro.kernels.wkv.ops.wkv_fused``, with the same contract:

* ``use_kernel=None`` takes the CUDA kernels for CUDA tensors and the
  plain PyTorch versions for CPU tensors; ``True`` forces the kernels and
  raises on CPU tensors; ``False`` forces the plain versions.  Meta
  tensors take the kernels' meta twins (shapes and costs for
  :mod:`repro_torch.core.lowering`, nothing launched) where CUDA tensors
  would take the kernels.
* ``decode=True`` marks a stateful serving call: windows of at most
  :data:`~repro_torch.kernels.wkv.decode.DECODE_WINDOW_MAX` tokens take the
  decode kernels (the single step at T == 1, the window otherwise); longer
  sweeps take the chunked kernel.  ``decode=None`` infers ``T == 1``.
* ``chunk`` is a request: when it does not divide T, the largest divisor
  below it is used, with a warning once per ``(T, chunk)`` per warn scope.
* ``h0=None`` means zeros; ``out`` comes back in r.dtype and S in f32.
* Under autograd (grad enabled and any input requiring grad) the chunked
  path runs through :class:`~repro_torch.kernels.wkv.vjp.WKVFunction`: the
  training forward and the reverse-sweep backward, kernels on the card and
  plain versions on the CPU.  The decode path runs through
  :class:`~repro_torch.kernels.wkv.vjp.WKVDecodeFunction` there: the
  decode kernels forward, the training forward and the reverse sweep at
  chunk 1 backward (the reference's ``wkv_decode_diff``).

:func:`wkv_fused_summary` (counterpart of the reference's
``wkv_fused_summary``) is the chunked path that also returns ``a_seg``, the
segment's decay product: the local building block of the
sequence-parallel path (:mod:`repro_torch.kernels.wkv.seqpar`).  It has
no ``use_kernel``: the tensor's device alone picks the kernel or the plain
version, with :class:`~repro_torch.kernels.wkv.vjp.WKVSummaryFunction`
under autograd.
"""

from __future__ import annotations

import warnings

import torch

from repro_torch.kernels.common import by_device, largest_divisor_chunk, on_kernel_device
from repro_torch.kernels.wkv.decode import (
    DECODE_WINDOW_MAX,
    wkv_decode_cuda,
    wkv_decode_meta,
    wkv_decode_plain,
    wkv_decode_window_cuda,
    wkv_decode_window_meta,
)
from repro_torch.kernels.wkv.kernel import (
    wkv_cuda,
    wkv_meta,
    wkv_plain,
    wkv_summary_cuda,
    wkv_summary_meta,
)
from repro_torch.kernels.wkv.vjp import WKVDecodeFunction, WKVFunction, WKVSummaryFunction

# (T, chunk) pairs already warned about, keyed by warn scope: two configs
# (or two test cases) hitting the same awkward (T, chunk) each warn once.
_CHUNK_WARNED: dict[str | None, set[tuple[int, int]]] = {}

# The active scope stack (chunk_warning_scope); empty -> the None scope.
_WARN_SCOPE: list[str | None] = []


def reset_chunk_warnings(scope: str | None = None, *, all_scopes: bool = False):
    """Forget the (T, chunk) pairs warned about in ``scope``, or in every
    scope."""
    if all_scopes:
        _CHUNK_WARNED.clear()
    else:
        _CHUNK_WARNED.pop(scope, None)


class chunk_warning_scope:  # noqa: N801 — the reference's context-manager name
    """Scope the chunk-adjustment warnings of calls that name no scope to
    ``tag`` while the context is open."""

    def __init__(self, tag: str | None):
        self.tag = tag

    def __enter__(self):
        _WARN_SCOPE.append(self.tag)
        return self

    def __exit__(self, *exc):
        _WARN_SCOPE.pop()
        return False


def resolve_chunk(t: int, chunk: int, *, scope: str | None = None) -> int:
    """Largest divisor of ``t`` no larger than ``chunk``; warns on adjust
    (once per distinct ``(t, chunk)`` per warn scope)."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    c = largest_divisor_chunk(t, chunk)
    if c != min(chunk, t):
        if scope is None and _WARN_SCOPE:
            scope = _WARN_SCOPE[-1]
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
    on_card = on_kernel_device(r)
    kernel = on_card if use_kernel is None else use_kernel
    if kernel and not on_card:
        raise ValueError(
            "wkv_fused(use_kernel=True) needs CUDA tensors; the CUDA kernels "
            f"cannot run on {r.device}")
    if decode is None:
        decode = t == 1
    grad = torch.is_grad_enabled() and any(
        x.requires_grad for x in (r, k, v, w, u, h0))
    if decode and t <= DECODE_WINDOW_MAX:
        if grad:
            if on_card != bool(kernel):
                raise ValueError(
                    "wkv_fused: under autograd the kernels run on CUDA tensors and "
                    "the plain versions on CPU tensors")
            return WKVDecodeFunction.apply(r, k, v, w, u, h0)
        if not kernel:
            return wkv_decode_plain(r, k, v, w, u, h0)
        if t == 1:
            return by_device(r, wkv_decode_cuda, wkv_decode_meta)(r, k, v, w, u, h0)
        return by_device(r, wkv_decode_window_cuda, wkv_decode_window_meta)(r, k, v, w, u, h0)
    c = resolve_chunk(t, chunk, scope=warn_scope)
    if grad:
        if on_card != bool(kernel):
            raise ValueError(
                "wkv_fused: under autograd the kernels run on CUDA tensors and "
                "the plain versions on CPU tensors; use_kernel=False on the card "
                "has no backward")
        return WKVFunction.apply(r, k, v, w, u, h0, c)
    if not kernel:
        return wkv_plain(r, k, v, w, u, h0, chunk=c)
    return by_device(r, wkv_cuda, wkv_meta)(r, k, v, w, u, h0, chunk=c)


def wkv_fused_summary(r, k, v, w, u, h0=None, *, chunk: int = 64):
    """Like :func:`wkv_fused` (the chunked path) but also returns ``a_seg``
    (B, H, Dh) f32, the segment decay product: the diag half of the
    ``(A, S)`` segment summary.  Each shard of the sequence-parallel path
    calls it with a zero entering state, and only ``(a_seg, S_out)``,
    O(Dh²) per (batch, head), crosses the mesh axis.  The tensor's device
    decides: the summary kernel for CUDA tensors, its plain version for CPU
    tensors, :class:`~repro_torch.kernels.wkv.vjp.WKVSummaryFunction` under
    autograd.  Returns ``(out, S_out, a_seg)``."""
    if h0 is None:
        b, h, _, dh = r.shape
        h0 = torch.zeros((b, h, dh, dh), dtype=torch.float32, device=r.device)
    c = resolve_chunk(r.shape[2], chunk)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (r, k, v, w, u, h0)):
        return WKVSummaryFunction.apply(r, k, v, w, u, h0, c)
    return by_device(r, wkv_summary_cuda, wkv_summary_meta)(r, k, v, w, u, h0, chunk=c)
