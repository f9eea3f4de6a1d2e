"""Chunked RWKV6 WKV backward: the CUDA kernel ``csrc/wkv_bwd.cu`` and its
plain PyTorch version.

Counterpart of ``repro.kernels.wkv.bwd.wkv_pallas_bwd``: the reverse chunk
sweep that carries the (Dh × Dh) adjoint state dS from chunk s+1 to chunk
s, seeded with ``d_s_out`` at the last chunk, and recomputes the decays and
scores of each chunk from the primals and ``s_hist`` (the entering states
the training forward wrote).  The CUDA kernel runs the sweep of one
(batch, head) on a cluster of 1, 2 or 4 blocks, each holding its share of
the value columns of dS in shared memory for the whole sweep and
exchanging its partial sums over them through distributed shared memory
(see the note at the top of the source).  The cluster's size comes from
:func:`plan_cluster`, pure Python: it depends on the shape, the chunk, the
dtype and the card's SM count, never on the T stride of a window.

:func:`wkv_bwd_cuda` is the wrapper: on CUDA tensors it launches the kernel
(counting the launch in ``wkv_bwd_cuda.launches``) or raises; on CPU
tensors it runs :func:`wkv_bwd_plain`.  Both return ``(dr, dk, dv, dw,
du_part, dh0)``: dr/dk/dv/dw in the primal dtype, ``du_part`` (B, H, Dh)
f32 per-batch partials of the u cotangent (the caller sums over batch) and
``dh0`` (B, H, Dh, Dh) f32.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.common import (
    check_kernel_tensors,
    launch_stream,
    load_library,
    sm_count,
    validate_divisible,
)
from repro_torch.kernels.wkv.kernel import (
    DTYPE_CODE,
    SMEM_LIMIT,
    WKV_DH,
    _up128,
    padded_chunk,
    row_stride,
)

__all__ = ["BWD_MAX_CHUNK", "CLUSTERS", "bwd_smem_bytes", "plan_cluster",
           "launch_plan", "wkv_bwd_cuda", "wkv_bwd_plain"]

#: Largest chunk the backward kernel takes (its shared-memory tiles).
BWD_MAX_CHUNK = 32
#: The cluster sizes (blocks per (batch, head)) the backward may take.
CLUSTERS = (1, 2, 4)
#: The share of the SMs the backward's blocks should reach.  Every block of
#: a cluster repeats the decay factors and the scores of its (batch, head),
#: so a larger cluster pays only where the smaller one leaves more than
#: half the SMs idle: on the H100, one block per (batch, head) at B=4, H=32
#: (128 blocks) and a cluster of 2 at B=1 (64 blocks) were the fastest
#: (``chip_smoke.py`` phase 4 times every cluster size at both shapes).
FILL = 0.45


def bwd_smem_bytes(chunk: int, cluster: int, itemsize: int) -> int:
    """Shared memory of one block of ``csrc/wkv_bwd.cu`` (its ``layout``,
    128-byte aligned regions): two ring stages (r/k/w rows, the block's v
    and do columns, its s_hist slice), the decay tiles and their k-major
    copies, the block's do/v/S/G tiles, the scores, two exchange buffers,
    the cluster's sums, the r.u.k warp partials, dv's four key-quarter
    partials and the d_rdec / d_kinv / V G^T tiles of the block's key
    columns.  The source's ``wkv_bwd_smem`` returns the same."""
    lp = padded_chunk(chunk)
    ld, nj, dh = lp + 4, WKV_DH // cluster, WKV_DH
    stage = (3 * _up128(lp * dh * itemsize) + 2 * _up128(lp * nj * itemsize)
             + _up128(dh * nj * 4))
    tiles = (3 * _up128(lp * dh * 4) + 3 * _up128(dh * ld * 4) + _up128(lp * nj * 4)
             + 2 * _up128(nj * ld * 4) + 2 * _up128(nj * (dh + 4) * 4) + _up128(dh * nj * 4)
             + _up128(lp * ld * 4))
    xch = 2 * _up128(lp * dh * 4) + _up128(lp * ld * 4) + _up128(lp * 4) + _up128(dh * 4)
    sums = (2 * _up128(lp * ld * 4) + 2 * _up128(lp * 4) + 3 * _up128(dh * 4)
            + _up128(8 * lp * 4) + _up128(4 * lp * nj * 4) + 3 * _up128(lp * nj * 4))
    return _up128(128 + 4 * dh) + 2 * stage + tiles + 2 * xch + sums


def plan_cluster(b: int, h: int, t: int, chunk: int, dtype: torch.dtype, sms: int) -> int:
    """The blocks of one (batch, head) in the backward (one of
    :data:`CLUSTERS`) for (b, h, t, 64) inputs at ``chunk`` on a card of
    ``sms`` SMs: the smallest cluster whose blocks (b·h·cluster) reach
    ``FILL`` of the SMs, else the largest, among those whose shared memory
    fits.  A larger cluster splits the value-column products over its
    blocks and adds one cluster barrier and an exchange through distributed
    shared memory a chunk.  ``t`` enters only through ``chunk``."""
    if dtype not in DTYPE_CODE:
        raise ValueError(f"plan_cluster: dtype {dtype} not supported (float32, bfloat16)")
    validate_divisible("T", t, chunk)
    item = torch.empty((), dtype=dtype).element_size()
    fits = [c for c in CLUSTERS if bwd_smem_bytes(chunk, c, item) <= SMEM_LIMIT]
    for c in fits:
        if b * h * c >= FILL * sms:
            return c
    return fits[-1]


def wkv_bwd_plain(r, k, v, w, u, s_hist, d_out, d_s_out, *, chunk: int):
    """Plain version, with the kernel's signature and order of work: the
    chunks back to front, each recomputing its decays from the primals and
    taking its entering state from ``s_hist``."""
    b, h, t, dh = r.shape
    validate_divisible("T", t, chunk)
    n = t // chunk
    f32 = torch.float32
    uu = u.float()[None, :, None, :]                       # (1, H, 1, Dh)
    mask = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                 device=r.device), diagonal=-1)
    zero = torch.zeros((), device=r.device)
    dS = d_s_out.float()
    du = torch.zeros((b, h, dh), dtype=f32, device=r.device)
    grads = [torch.empty((b, h, t, dh), dtype=r.dtype, device=r.device)
             for _ in range(4)]
    for c in reversed(range(n)):
        sl = slice(c * chunk, (c + 1) * chunk)
        rc, kc, vc, wc, do = (a[:, :, sl].float() for a in (r, k, v, w, d_out))
        S = s_hist[:, :, c].float()
        logw = torch.log(wc.clamp(1e-8, 1.0))
        cum_incl = torch.cumsum(logw, dim=2)
        cum_excl = cum_incl - logw
        last_c = cum_incl[:, :, -1:]
        w_total = torch.exp(last_c[:, :, 0])               # (B, H, Dh)
        r_dec = rc * torch.exp(cum_excl)
        k_inv = kc * torch.exp(-cum_incl)
        k_rem = kc * torch.exp(last_c - cum_incl)
        scores = torch.where(mask, r_dec @ k_inv.transpose(-1, -2), zero)
        dscores = torch.where(mask, do @ vc.transpose(-1, -2), zero)
        dov = (do * vc).sum(-1, keepdim=True)              # (B, H, L, 1)

        d_rdec = dscores @ k_inv + do @ S.transpose(-1, -2)
        d_kinv = dscores.transpose(-1, -2) @ r_dec
        d_krem = vc @ dS.transpose(-1, -2)
        dr = d_rdec * torch.exp(cum_excl) + uu * kc * dov
        dk = (d_kinv * torch.exp(-cum_incl) + d_krem * torch.exp(last_c - cum_incl)
              + rc * uu * dov)
        dv = (scores.transpose(-1, -2) @ do + k_rem @ dS
              + (rc * uu * kc).sum(-1, keepdim=True) * do)

        dcum_excl = d_rdec * r_dec
        dcum_incl = -d_kinv * k_inv - d_krem * k_rem
        last = (d_krem * k_rem).sum(2) + w_total * (S * dS).sum(-1)
        dcum_incl[:, :, -1] += last
        suf_incl = torch.flip(torch.cumsum(torch.flip(dcum_incl, (2,)), 2), (2,))
        suf_excl = torch.flip(torch.cumsum(torch.flip(dcum_excl, (2,)), 2), (2,))
        dlogw = suf_incl + suf_excl - dcum_excl
        in_range = (wc >= 1e-8) & (wc <= 1.0)
        dw = torch.where(in_range, dlogw / wc.clamp(1e-8, 1.0), zero)
        for out, g in zip(grads, (dr, dk, dv, dw)):
            out[:, :, sl] = g.to(out.dtype)
        du += (rc * kc * dov).sum(2)
        # Adjoint hand-off to chunk c-1.
        dS = dS * w_total[..., None] + r_dec.transpose(-1, -2) @ do
    return (*grads, du, dS)


def _check_bwd_args(r, k, v, w, u, s_hist, d_out, d_s_out, chunk):
    """Validate the inputs; returns the token count between consecutive
    (b, h) rows of r/k/v/w (T when they are contiguous)."""
    b, h, t, dh = r.shape
    tensors = {"r": r, "k": k, "v": v, "w": w, "u": u, "s_hist": s_hist,
               "d_out": d_out, "d_s_out": d_s_out}
    check_kernel_tensors("wkv_bwd_cuda", strided=("r", "k", "v", "w"), **tensors)
    if r.dtype not in DTYPE_CODE:
        raise ValueError(f"wkv_bwd_cuda: dtype {r.dtype} not supported (float32, bfloat16)")
    for key in ("k", "v", "w", "u", "d_out"):
        if tensors[key].dtype != r.dtype:
            raise ValueError(f"wkv_bwd_cuda: {key} dtype {tensors[key].dtype} != r dtype {r.dtype}")
    for key in ("s_hist", "d_s_out"):
        if tensors[key].dtype != torch.float32:
            raise ValueError(f"wkv_bwd_cuda: {key} must be float32, got {tensors[key].dtype}")
    for key in ("k", "v", "w", "d_out"):
        if tensors[key].shape != r.shape:
            raise ValueError(f"wkv_bwd_cuda: {key} shape {tuple(tensors[key].shape)} != {tuple(r.shape)}")
    if dh != WKV_DH:
        raise ValueError(f"wkv_bwd_cuda: head dim {dh} != {WKV_DH}")
    want = {"u": (h, dh), "s_hist": (b, h, t // chunk, dh, dh), "d_s_out": (b, h, dh, dh)}
    for key, shape in want.items():
        if tuple(tensors[key].shape) != shape:
            raise ValueError(f"wkv_bwd_cuda: {key} shape {tuple(tensors[key].shape)} != {shape}")
    return row_stride("wkv_bwd_cuda", r, k, v, w)


def wkv_bwd_cuda(r, k, v, w, u, s_hist, d_out, d_s_out, *, chunk: int):
    """Reverse chunk sweep.  r/k/v/w/d_out: (B, H, T, 64) of one dtype,
    r/k/v/w contiguous or T-windows of longer contiguous tensors (a shard
    of the sequence-parallel path, read in place), d_out contiguous;
    u: (H, 64); s_hist: (B, H, T/chunk, 64, 64) f32 from the training
    forward; d_s_out: (B, H, 64, 64) f32; ``chunk`` divides T, 1..32.
    Returns ``(dr, dk, dv, dw, du_part, dh0)``.  CPU tensors take the plain
    version."""
    validate_divisible("T", r.shape[2], chunk)
    if r.device.type == "cpu":
        return wkv_bwd_plain(r, k, v, w, u, s_hist, d_out, d_s_out, chunk=chunk)
    out = launch_plan(r, k, v, w, u, s_hist, d_out, d_s_out, chunk=chunk)
    wkv_bwd_cuda.launches += 1
    return out


def launch_plan(r, k, v, w, u, s_hist, d_out, d_s_out, *, chunk: int, cluster=None):
    """Launch the backward kernel on CUDA tensors with ``cluster`` blocks
    per (batch, head) (one of :data:`CLUSTERS` whose shared memory fits),
    or :func:`plan_cluster`'s choice; counts no launch.  The card tests and
    ``chip_smoke.py`` compare and time the other sizes."""
    b, h, t, dh = r.shape
    validate_divisible("T", t, chunk)
    if chunk > BWD_MAX_CHUNK:
        raise ValueError(f"wkv_bwd_cuda: chunk={chunk} > {BWD_MAX_CHUNK}")
    t_stride = _check_bwd_args(r, k, v, w, u, s_hist, d_out, d_s_out, chunk)
    if cluster is None:
        cluster = plan_cluster(b, h, t, chunk, r.dtype, sm_count(r.device))
    dr, dk, dv, dw = (torch.empty(r.shape, dtype=r.dtype, device=r.device)
                      for _ in range(4))
    du_part = torch.empty((b, h, dh), dtype=torch.float32, device=r.device)
    dh0 = torch.empty((b, h, dh, dh), dtype=torch.float32, device=r.device)
    fn = load_library("wkv_bwd").wkv_bwd
    err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
             u.data_ptr(), s_hist.data_ptr(), d_out.data_ptr(),
             d_s_out.data_ptr(), dr.data_ptr(), dk.data_ptr(), dv.data_ptr(),
             dw.data_ptr(), du_part.data_ptr(), dh0.data_ptr(),
             b, h, t, t_stride, dh, chunk, DTYPE_CODE[r.dtype], cluster,
             launch_stream(r.device))
    if err:
        raise RuntimeError(f"wkv_bwd launch failed: error {err} (a cudaError_t, or "
                           "10000 + the CUresult of a tensor map)")
    return dr, dk, dv, dw, du_part, dh0


wkv_bwd_cuda.launches = 0
