"""Sequence-parallel WKV: device-space elevator edges over a mesh axis
(counterpart of ``repro.kernels.wkv.seqpar``).

Within a shard the (Dh × Dh) WKV state rides the chunked kernel's carry
from chunk to chunk.  The same elevator edge exists between shards.  A
sequence-sharded model that gathers the state, or the tokens, to stitch
shards together is the paper's scratchpad pattern at mesh granularity.
The segment-summary protocol removes it:

1. every shard runs the fused sweep on its own tokens with a **zero**
   entering state, also emitting the segment summary ``(a_seg, S⁰)``: the
   decay product (B, H, Dh) and the exit state (B, H, Dh, Dh)
   (``ops.wkv_fused_summary``: the summary kernel on the card);
2. the summaries compose across the ``seq`` axis under the ``DIAG_STATE``
   monoid (``core.chunk_scan.device_linear_scan_carry``): log₂(n) + 1
   point-to-point hops per summary tensor, each O(Dh²), never a token
   re-gather;
3. each shard rebuilds its true entering state ``S_in = carry_a ★ h0 +
   carry_b`` and adds the linear entry correction ``(r_t ⊙ D_{<t}) @
   S_in`` to its outputs (``ref.wkv_entry_correction``); the final state
   is the last shard's exit state.

Single-controller, as the reference's CPU tests run it: one process holds
every shard (:mod:`repro_torch.launch.mesh`), a shard's tokens are a
T-window of the caller's tensors placed on its device (in place where the
devices agree: the summary kernels, and under autograd the reverse sweep,
read the window with the full T's stride, and the gradient keeps it as a
view), and the hops are :func:`repro_torch.core.device_comm.device_shift`.
Autograd through this path runs the composition backward: the backward of
each hop is the opposite hop, so the adjoint ``dS``/``d_a`` summaries run
last shard to first, while each shard's local gradient goes through the
reverse kernel sweep (``vjp.WKVSummaryFunction``).

What the reference keeps sharded outside the WKV (the token activations
between layers, by its GSPMD rules) the port keeps whole on the caller's
device: each shard's outputs come back there, and the final state too.
On one card, where the shards share the device, that costs nothing; over
several cards it is a copy of each shard's outputs per layer, which the
port's multi-card slice removes.
"""

from __future__ import annotations

import torch

from repro_torch.core.chunk_scan import DIAG_STATE, device_linear_scan_carry
from repro_torch.kernels.wkv.ops import wkv_fused_summary
from repro_torch.kernels.wkv.ref import wkv_entry_correction

__all__ = ["wkv_seq_local", "wkv_seqshard"]


def wkv_seq_local(r, k, v, w, u, h0, *, chunk: int = 64):
    """The protocol over one row of shards along the seq axis.

    ``r/k/v/w`` are lists of the shards' (B, H, T/n, Dh) tensors, in axis
    order, each on its shard's device; ``u`` (H, Dh) and ``h0`` (B, H, Dh,
    Dh) are the global ones.  Returns ``(outs, S_out)``: each shard's
    outputs (in r.dtype, on its device) and the exit state of the whole
    sequence (f32, on the last shard's device)."""
    f32 = torch.float32
    out0, s0, a_seg = zip(*(
        wkv_fused_summary(ri, ki, vi, wi, u.to(ri.device), None, chunk=chunk)
        for ri, ki, vi, wi in zip(r, k, v, w)))
    # Compose the (A, S) summaries along the axis: the entering state of
    # shard i is carry_a ★ h0 + carry_b (h0 enters shard 0 as the elevator
    # boundary constant).
    carry_a, carry_b = device_linear_scan_carry(a_seg, s0, monoid=DIAG_STATE)
    s_in = [DIAG_STATE.scale(ca, h0.to(ri.device, f32)) + cb
            for ri, ca, cb in zip(r, carry_a, carry_b)]
    outs = [(o.to(f32) + wkv_entry_correction(ri, wi, si)).to(ri.dtype)
            for ri, wi, o, si in zip(r, w, out0, s_in)]
    # The global exit state is the last shard's.
    return outs, DIAG_STATE.scale(a_seg[-1], s_in[-1]) + s0[-1]


def wkv_seqshard(r, k, v, w, u, h0=None, *, mesh, seq_axis: str, batch_axis=None,
                 chunk: int = 64):
    """Sequence-sharded WKV over ``mesh``'s ``seq_axis``.

    Same signature and returns as :func:`repro_torch.kernels.wkv.ops.wkv_fused`
    (``out`` in r.dtype, ``S_out`` f32, both on r's device) plus the mesh
    placement: the T axis of r/k/v/w is split over ``seq_axis`` (T must
    divide evenly), the batch axis over ``batch_axis`` (a name, a tuple of
    names or None; B must divide evenly), and each batch group runs the
    protocol over its own row of shards.  u and h0 are replicated along
    ``seq_axis``.  Differentiable."""
    b, h, t, dh = r.shape
    if h0 is None:
        h0 = torch.zeros((b, h, dh, dh), dtype=torch.float32, device=r.device)
    rows = mesh.device_grid(seq_axis, batch_axis)
    n_b, n_seq = len(rows), len(rows[0])
    if t % n_seq or b % n_b:
        raise ValueError(
            f"wkv_seqshard: (B, T) = {(b, t)} does not split over {n_b} batch "
            f"groups x {n_seq} seq shards")
    tb, ts = b // n_b, t // n_seq
    home = r.device
    # The shards as views (``split``, whose backward is one concatenation of
    # the shards' grads), moved to their devices: in place where the devices
    # agree.
    groups = [x.split(tb, dim=0) for x in (r, k, v, w, h0)]
    outs, s_outs = [], []
    for row, *xs in zip(rows, *groups):
        r_, k_, v_, w_ = ([xt.to(dev) for xt, dev in zip(x.split(ts, dim=2), row)]
                          for x in xs[:4])
        o, s = wkv_seq_local(r_, k_, v_, w_, u, xs[4], chunk=chunk)
        outs.append(torch.cat([x.to(home) for x in o], dim=2))
        s_outs.append(s.to(home))
    if n_b == 1:
        return outs[0], s_outs[0]
    return torch.cat(outs, dim=0), torch.cat(s_outs, dim=0)
