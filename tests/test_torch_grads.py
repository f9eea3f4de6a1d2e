"""The port's differentiable kernels against the reference's, on the CPU.

Each ``torch.autograd.Function`` added for training runs here through its
plain versions (the CUDA kernels are held to those on the card, in
tests/test_torch_cuda.py and chip_smoke.py's phase 2c), on the same numpy
inputs and cotangents as ``jax.vjp`` of the reference:

* ``FlashAttentionFunction`` (``attention_bwd_ref``) against ``jax.vjp`` of
  the reference's ``attention_ref`` and ``attention_blockwise``: causal,
  causal window, non-causal with and without a window, the decode offset
  and cross-attention (T != S), GQA 4/1 and 14/2, and a T that is not a
  block multiple;
* ``ElevatorScanFunction`` (``elevator_scan_bwd_ref``) against the
  reference's ``elevator_scan`` and its window, ``elevator_decode_diff``,
  in interpret mode (the spec of tests/test_kernel_elevator_scan.py);
* ``TokenShiftFunction`` (``token_shift_bwd_ref``) against
  ``token_shift_ref``;
* ``WKVDecodeFunction`` (the decode path of ``wkv_fused`` under grad)
  against the reference's ``wkv_decode_diff`` in interpret mode, at the
  windows of tests/test_kernel_wkv.py (T = 1 and 7) and 37;
* ``torch.autograd.gradcheck`` of the four at tiny shapes, in f64 (the WKV
  window's in f32: its plain versions compute in f32).

Tolerances: the plain backwards and JAX's derivatives are the same f32
math in other orders (about 1e-6 of the largest value here), so each grad
is held to 1e-4 of its largest value plus 1e-4 relative (the reference
holds its own kernels' grads to 1e-4).  The scan's and the token shift's
plain backwards take the reference's order, and are held to 1e-6.
gradcheck: its defaults (eps 1e-6, atol 1e-5, rtol 1e-3) in f64; the WKV
window's is stated at its test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.elevator_scan.decode import elevator_decode_diff
from repro.kernels.elevator_scan.ops import elevator_scan as jax_scan
from repro.kernels.local_attention import ref as jax_attn
from repro.kernels.token_shift.ref import token_shift_ref as jax_token_shift
from repro.kernels.wkv.decode import wkv_decode_diff
from repro_torch.kernels.elevator_scan.ops import elevator_scan
from repro_torch.kernels.elevator_scan.vjp import ElevatorScanFunction
from repro_torch.kernels.local_attention.ops import flash_attention
from repro_torch.kernels.local_attention.vjp import FlashAttentionFunction
from repro_torch.kernels.token_shift.ops import token_shift
from repro_torch.kernels.token_shift.vjp import TokenShiftFunction
from repro_torch.kernels.wkv import ops as wkv_ops
from repro_torch.kernels.wkv.vjp import WKVDecodeFunction

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)

TOL = 1e-4
EXACT_TOL = 1e-6


def _close(got, want, tol=TOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.detach().float().numpy()
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol * max(1e-3, np.abs(w).max()))


def _torch_grads(fn, args, cot):
    """Grads of sum(fn(*args) * cot) with respect to every arg."""
    ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
    out = fn(*ts)
    outs = out if isinstance(out, tuple) else (out,)
    cots = cot if isinstance(cot, tuple) else (cot,)
    loss = sum((o.float() * torch.from_numpy(c)).sum() for o, c in zip(outs, cots))
    return torch.autograd.grad(loss, ts)


def _jax_grads(fn, args, cot):
    out, vjp = jax.vjp(fn, *[jnp.asarray(a) for a in args])
    if isinstance(out, tuple):
        return vjp(tuple(jnp.asarray(c, o.dtype) for c, o in zip(cot, out)))
    return vjp(jnp.asarray(cot, out.dtype))


# --------------------------------------------------------------------------
# Flash attention
# --------------------------------------------------------------------------

#: (B, Hq, Hkv, T, S, D, causal, window): every mask variant of the
#: forward's, GQA 4/1 (gemma3) and 14/2 (qwen2-0.5b), T != S both ways.
ATTN_CASES = [
    (2, 4, 1, 24, 24, 16, True, None),
    (1, 4, 1, 40, 40, 16, True, 8),
    (1, 14, 2, 20, 20, 8, True, None),
    (2, 2, 2, 18, 18, 16, False, None),
    (1, 4, 2, 30, 30, 8, False, 5),
    (1, 4, 1, 6, 30, 16, True, None),      # decode offset S - T
    (1, 4, 1, 6, 30, 16, True, 4),
    (2, 4, 4, 12, 33, 8, False, None),     # cross-attention, T < S
    (1, 2, 2, 33, 12, 8, False, None),     # T > S
    (1, 4, 1, 37, 37, 16, True, 16),       # T not a block multiple
]


#: The cases also held to the reference's flash-structured blockwise form
#: (its first call per shape costs seconds of tracing): a causal window, a
#: non-causal window and cross-attention.
BLOCKWISE_CASES = [ATTN_CASES[i] for i in (1, 4, 7)]


def _attn_np(b, hq, hkv, t, s, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, t, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    cot = rng.standard_normal((b, hq, t, d)).astype(np.float32)
    return [q, k, v], cot


@pytest.mark.parametrize("case", ATTN_CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_grads_match_reference(case):
    b, hq, hkv, t, s, d, causal, window = case
    args, cot = _attn_np(b, hq, hkv, t, s, d, seed=t * s + hq)
    got = _torch_grads(lambda *x: FlashAttentionFunction.apply(*x, causal, window, None),
                       args, cot)
    want = _jax_grads(lambda *x: jax_attn.attention_ref(*x, causal=causal, window=window),
                      args, cot)
    _close(got, want)
    if case in BLOCKWISE_CASES:
        blockwise = _jax_grads(
            lambda *x: jax_attn.attention_blockwise(*x, causal=causal, window=window, block=16),
            args, cot)
        _close(got, blockwise)


def test_flash_op_takes_the_function_under_grad():
    args, _ = _attn_np(1, 4, 1, 8, 8, 16, seed=0)
    q, k, v = (torch.from_numpy(a) for a in args)
    with torch.no_grad():
        assert flash_attention(q.requires_grad_(True), k, v).grad_fn is None
    out = flash_attention(q, k, v, window=4)
    assert type(out.grad_fn).__name__ == "FlashAttentionFunctionBackward"
    assert torch.equal(out, flash_attention(q.detach(), k, v, window=4))


# --------------------------------------------------------------------------
# The RG-LRU scan and its window
# --------------------------------------------------------------------------

def _scan_np(b, t, d, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 1.0, (b, t, d)).astype(np.float32)
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    h0 = rng.standard_normal((b, d)).astype(np.float32)
    cot = rng.standard_normal((b, t, d)).astype(np.float32)
    return [a, x, h0], cot


@pytest.mark.parametrize("b,t,d", [(2, 37, 32), (1, 300, 16)])
def test_scan_grads_match_reference(b, t, d):
    args, cot = _scan_np(b, t, d, seed=t)
    got = _torch_grads(lambda a, x, h0: ElevatorScanFunction.apply(a, x, h0, False), args, cot)
    want = _jax_grads(lambda a, x, h0: jax_scan(a, x, h0, use_kernel=False), args, cot)
    _close(got, want)


@pytest.mark.parametrize("k", [1, 9, 64])
def test_scan_window_grads_match_elevator_decode_diff(k):
    """The window under grad (``decode=True``) against the reference's
    ``elevator_decode_diff`` with its Pallas window in interpret mode."""
    args, cot = _scan_np(2, k, 128, seed=11 + k)
    got = _torch_grads(lambda a, x, h0: elevator_scan(a, x, h0, decode=True), args, cot)
    want = _jax_grads(lambda a, x, h0: elevator_decode_diff(True, True, a, x, h0), args, cot)
    _close(got, want, tol=EXACT_TOL)


def test_scan_without_h0_and_in_bf16():
    args, cot = _scan_np(1, 20, 16, seed=5)
    a, x = (torch.from_numpy(v).requires_grad_(True) for v in args[:2])
    h = elevator_scan(a, x)
    ga, gx = torch.autograd.grad((h * torch.from_numpy(cot)).sum(), (a, x))
    want = _jax_grads(lambda a_, x_: jax_scan(a_, x_, use_kernel=False), args[:2], cot)
    _close((ga, gx), want)
    # The model scans f32 inputs: under grad the scan takes only those, and
    # bf16 runs without grad alone.
    ab, xb = (t.detach().to(torch.bfloat16).requires_grad_(True) for t in (a, x))
    with pytest.raises(ValueError, match="float32 under grad"):
        elevator_scan(ab, xb)
    with torch.no_grad():
        hb = elevator_scan(ab, xb)
    assert hb.dtype == torch.bfloat16
    want_h = np.asarray(jax_scan(jnp.asarray(ab.detach().float().numpy()),
                                 jnp.asarray(xb.detach().float().numpy()), use_kernel=False))
    _close((hb,), (want_h,), tol=2.0 ** -7)


# --------------------------------------------------------------------------
# The token shift
# --------------------------------------------------------------------------

@pytest.mark.parametrize("b,t,d,taps", [(2, 4, 16, 4), (1, 67, 24, 4), (2, 19, 8, 3)])
def test_token_shift_grads_match_reference(b, t, d, taps):
    rng = np.random.default_rng(t)
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    w = (rng.standard_normal((taps, d)) * 0.3).astype(np.float32)
    cot = rng.standard_normal((b, t, d)).astype(np.float32)
    got = _torch_grads(TokenShiftFunction.apply, [x, w], cot)
    want = _jax_grads(jax_token_shift, [x, w], cot)
    _close(got, want, tol=EXACT_TOL)
    xt, wt = (torch.from_numpy(v).requires_grad_(True) for v in (x, w))
    assert type(token_shift(xt, wt).grad_fn).__name__ == "TokenShiftFunctionBackward"


# --------------------------------------------------------------------------
# The WKV decode window
# --------------------------------------------------------------------------

def _wkv_np(b, h, t, dh, seed):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, h, t, dh)).astype(np.float32) for _ in range(3))
    w = rng.uniform(0.85, 0.999, (b, h, t, dh)).astype(np.float32)
    u = rng.standard_normal((h, dh)).astype(np.float32)
    h0 = rng.standard_normal((b, h, dh, dh)).astype(np.float32)
    d_out = rng.standard_normal((b, h, t, dh)).astype(np.float32)
    d_s = rng.standard_normal((b, h, dh, dh)).astype(np.float32)
    return [r, k, v, w, u, h0], (d_out, d_s)


@pytest.mark.parametrize("t", [1, 7, 37])
def test_wkv_decode_grads_match_wkv_decode_diff(t):
    args, cots = _wkv_np(1, 2, t, 16, seed=74 + t)
    got = _torch_grads(lambda *x: wkv_ops.wkv_fused(*x, decode=True), args, cots)
    want = _jax_grads(lambda *x: wkv_decode_diff(True, True, *x), args, cots)
    _close(got, want)


def test_wkv_decode_takes_the_function_under_grad():
    args, _ = _wkv_np(1, 1, 4, 16, seed=3)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
    out, _ = wkv_ops.wkv_fused(*ts, decode=True)
    assert type(out.grad_fn).__name__ == "WKVDecodeFunctionBackward"
    with torch.no_grad():
        plain, _ = wkv_ops.wkv_fused(*ts, decode=True)
    assert torch.equal(out.detach(), plain)


# --------------------------------------------------------------------------
# gradcheck in f64
# --------------------------------------------------------------------------

def _f64(*shapes, seed=0, low=None):
    g = torch.Generator().manual_seed(seed)
    out = []
    for s in shapes:
        x = (torch.rand(s, generator=g, dtype=torch.float64) * 0.5 + 0.5 if low
             else torch.randn(s, generator=g, dtype=torch.float64))
        out.append(x.requires_grad_(True))
    return out


@pytest.mark.parametrize("causal,window,t,s", [(True, None, 5, 5), (True, 2, 3, 6),
                                               (False, 3, 4, 4), (False, None, 3, 5)])
def test_gradcheck_flash(causal, window, t, s):
    q, = _f64((1, 4, t, 4), seed=1)
    k, v = _f64((1, 2, s, 4), (1, 2, s, 4), seed=2)
    assert torch.autograd.gradcheck(
        lambda q_, k_, v_: FlashAttentionFunction.apply(q_, k_, v_, causal, window, None),
        (q, k, v))


@pytest.mark.parametrize("decode", [False, True])
def test_gradcheck_scan(decode):
    a, = _f64((2, 5, 3), seed=3, low=True)
    x, h0 = _f64((2, 5, 3), (2, 3), seed=4)
    assert torch.autograd.gradcheck(
        lambda a_, x_, h_: ElevatorScanFunction.apply(a_, x_, h_, decode), (a, x, h0))


def test_gradcheck_token_shift():
    x, w = _f64((2, 6, 3), (4, 3), seed=5)
    assert torch.autograd.gradcheck(TokenShiftFunction.apply, (x, w))


def test_gradcheck_wkv_decode():
    """The WKV plain versions compute in f32 whatever the input (as the
    reference's), so this one runs in f32: central differences of step
    1e-2 (truncation about 1e-4 relative here, f32 rounding about 1e-5 / 1e-2
    = 1e-3 relative), held to atol 5e-3 and rtol 5e-3."""
    r, k, v = _f64((1, 1, 3, 4), (1, 1, 3, 4), (1, 1, 3, 4), seed=6)
    w, = _f64((1, 1, 3, 4), seed=7, low=True)
    u, h0 = _f64((1, 4), (1, 1, 4, 4), seed=8)
    args = [x.detach().float().requires_grad_(True) for x in (r, k, v, w, u, h0)]
    assert torch.autograd.gradcheck(WKVDecodeFunction.apply, args, eps=1e-2, atol=5e-3,
                                    rtol=5e-3)
