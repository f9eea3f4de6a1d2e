"""The port's WKV training functions against the reference's, on the CPU.

* the plain training forward (``wkv_train_plain``) against the Pallas
  ``wkv_pallas_train`` in interpret mode, on (out, S, s_hist);
* the plain backward (``wkv_bwd_plain``) against the Pallas
  ``wkv_pallas_bwd`` in interpret mode, on identical cotangents and
  ``s_hist``;
* the port's ``wkv_chunked_bwd_ref`` against the reference's;
* ``WKVFunction`` (through ``wkv_fused``) against ``torch.autograd``
  through ``wkv_sequential_ref``.

The CUDA kernels against the plain versions are in tests/test_torch_cuda.py.

Tolerance: the reference holds its kernels to its oracles at 5e-4
(tests/test_kernel_wkv.py); the same f32 arithmetic in other summation
orders agrees to about 2e-7 relative here, so 5e-4 of the largest value
(atol) plus 5e-4 relative is stated for f32.  bf16 grads are rounded to
bf16 by the Function, one ulp is 2**-8 relative, stated as 2**-7.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.wkv.bwd import wkv_pallas_bwd
from repro.kernels.wkv.kernel import wkv_pallas_train
from repro.kernels.wkv.ref import wkv_chunked_bwd_ref as jax_bwd_ref
from repro_torch.kernels.wkv import ops
from repro_torch.kernels.wkv.bwd import wkv_bwd_cuda, wkv_bwd_plain
from repro_torch.kernels.wkv.kernel import wkv_train_cuda, wkv_train_plain
from repro_torch.kernels.wkv.ref import wkv_chunked_bwd_ref, wkv_sequential_ref

jax.config.update("jax_platform_name", "cpu")
# Tiny tensors: one intra-op thread, so parallel test workers do not
# oversubscribe the cores.
torch.set_num_threads(1)

TOL = 5e-4
BF16_RTOL = 2.0 ** -7


def _np_inputs(b, h, t, dh, seed=0, zero_h0=False):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, h, t, dh)).astype(np.float32) for _ in range(3))
    w = rng.uniform(0.85, 0.999, (b, h, t, dh)).astype(np.float32)
    u = rng.standard_normal((h, dh)).astype(np.float32)
    h0 = (np.zeros((b, h, dh, dh), np.float32) if zero_h0
          else rng.standard_normal((b, h, dh, dh)).astype(np.float32))
    d_out = rng.standard_normal((b, h, t, dh)).astype(np.float32)
    d_s_out = rng.standard_normal((b, h, dh, dh)).astype(np.float32)
    return [r, k, v, w, u, h0], d_out, d_s_out


def _close(got, want, tol=TOL):
    for g, w in zip(got, want):
        g = g.float().numpy() if isinstance(g, torch.Tensor) else np.asarray(g, np.float32)
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol * max(1.0, np.abs(w).max()))


def _t(arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


CASES = [
    (2, 2, 64, 64, 16, False),     # nonzero h0, the model's width and chunk
    (1, 2, 96, 32, 32, True),
    (2, 1, 17, 16, 1, False),      # T=17: the only divisor below 16 is 1
]


@pytest.mark.parametrize("b,h,t,dh,chunk,zero_h0", CASES)
def test_train_forward_matches_pallas(b, h, t, dh, chunk, zero_h0):
    prims, _, _ = _np_inputs(b, h, t, dh, seed=t, zero_h0=zero_h0)
    want = wkv_pallas_train(*_j(prims), chunk=chunk, interpret=True)
    got = wkv_train_plain(*_t(prims), chunk=chunk)
    assert got[2].shape == (b, h, t // chunk, dh, dh)
    _close(got, want)
    # The CPU wrapper is the plain version.
    for a, c in zip(wkv_train_cuda(*_t(prims), chunk=chunk), got):
        assert torch.equal(a, c)


@pytest.mark.parametrize("b,h,t,dh,chunk,zero_h0", CASES)
def test_backward_matches_pallas(b, h, t, dh, chunk, zero_h0):
    prims, d_out, d_s_out = _np_inputs(b, h, t, dh, seed=t + 1, zero_h0=zero_h0)
    _, _, s_hist = wkv_pallas_train(*_j(prims), chunk=chunk, interpret=True)
    s_hist = np.asarray(s_hist)
    args = prims[:5] + [s_hist, d_out, d_s_out]
    want = wkv_pallas_bwd(*_j(args), chunk=chunk, interpret=True)
    got = wkv_bwd_plain(*_t(args), chunk=chunk)
    assert got[4].shape == (b, h, dh) and got[5].shape == (b, h, dh, dh)
    _close(got, want)
    for a, c in zip(wkv_bwd_cuda(*_t(args), chunk=chunk), got):
        assert torch.equal(a, c)


@pytest.mark.parametrize("b,h,t,dh,chunk,zero_h0", CASES)
def test_bwd_ref_matches_reference(b, h, t, dh, chunk, zero_h0):
    prims, d_out, d_s_out = _np_inputs(b, h, t, dh, seed=t + 2, zero_h0=zero_h0)
    want = jax_bwd_ref(*_j(prims), jnp.asarray(d_out), jnp.asarray(d_s_out), chunk=chunk)
    got = wkv_chunked_bwd_ref(*_t(prims), torch.from_numpy(d_out),
                              torch.from_numpy(d_s_out), chunk=chunk)
    _close(got, want)


def _autograd_sequential(prims, d_out, d_s_out):
    args = [a.clone().requires_grad_(True) for a in _t(prims)]
    out, s = wkv_sequential_ref(*args)
    loss = (out * torch.from_numpy(d_out)).sum() + (s * torch.from_numpy(d_s_out)).sum()
    return torch.autograd.grad(loss, args)


def _function_grads(prims, d_out, d_s_out, chunk, dtype=torch.float32):
    args = [a.to(dtype).requires_grad_(True) for a in _t(prims[:5])]
    h0 = torch.from_numpy(prims[5]).requires_grad_(True)
    out, s = ops.wkv_fused(*args, h0, chunk=chunk)
    assert out.dtype == dtype and s.dtype == torch.float32
    loss = (out.float() * torch.from_numpy(d_out)).sum() + (s * torch.from_numpy(d_s_out)).sum()
    grads = torch.autograd.grad(loss, args + [h0])
    assert [g.dtype for g in grads] == [dtype] * 5 + [torch.float32]
    return grads


@pytest.mark.filterwarnings("ignore:wkv chunk")
@pytest.mark.parametrize("t,chunk,zero_h0", [
    (64, 16, False),    # nonzero h0, the model's chunk
    (20, 16, True),     # T=20: fallback chunk 10
    (17, 16, False),    # T=17: fallback chunk 1
])
def test_function_grads_match_autograd(t, chunk, zero_h0):
    prims, d_out, d_s_out = _np_inputs(2, 2, t, 32, seed=t, zero_h0=zero_h0)
    _close(_function_grads(prims, d_out, d_s_out, chunk),
           [g.numpy() for g in _autograd_sequential(prims, d_out, d_s_out)])


def test_function_grads_chunk_invariant():
    prims, d_out, d_s_out = _np_inputs(1, 2, 128, 32, seed=5)
    want = [g.numpy() for g in _autograd_sequential(prims, d_out, d_s_out)]
    for chunk in (8, 32, 128):
        _close(_function_grads(prims, d_out, d_s_out, chunk), want)


def test_function_grads_bf16_io():
    prims, d_out, d_s_out = _np_inputs(2, 2, 32, 32, seed=7)
    # Both sides see the bf16-rounded primals and output cotangent (the
    # grad of a bf16 output arrives in bf16); the Function's grads are
    # rounded to bf16 once at the end.
    def bf16(a):
        return torch.from_numpy(a).bfloat16().float().numpy()

    prims = [bf16(a) for a in prims[:5]] + [prims[5]]
    d_out = bf16(d_out)
    got = _function_grads(prims, d_out, d_s_out, 16, dtype=torch.bfloat16)
    want = [g.numpy() for g in _autograd_sequential(prims, d_out, d_s_out)]
    _close(got[:5], want[:5], tol=BF16_RTOL)
    _close(got[5:], want[5:])


def test_no_grad_takes_the_inference_path():
    prims, _, _ = _np_inputs(1, 1, 32, 16, seed=3)
    args = [a.requires_grad_(True) for a in _t(prims)]
    with torch.no_grad():
        out, _ = ops.wkv_fused(*args, chunk=16)
    assert out.grad_fn is None
    out, _ = ops.wkv_fused(*args, chunk=16)
    assert type(out.grad_fn).__name__ == "WKVFunctionBackward"


@pytest.mark.parametrize("t", [1, 4])
def test_decode_under_grad_matches_autograd(t):
    """The decode path under grad (``WKVDecodeFunction``: the decode
    kernels' plain version forward, the training forward and the reverse
    sweep at chunk 1 backward) against ``torch.autograd`` through
    ``wkv_sequential_ref``."""
    prims, d_out, d_s_out = _np_inputs(1, 1, t, 64, seed=3)
    args = [a.requires_grad_(True) for a in _t(prims)]
    out, s_fin = ops.wkv_fused(*args, decode=True)
    assert type(out.grad_fn).__name__ == "WKVDecodeFunctionBackward"
    loss = (out * torch.from_numpy(d_out)).sum() + (s_fin * torch.from_numpy(d_s_out)).sum()
    got = torch.autograd.grad(loss, args)
    _close(got, [g.numpy() for g in _autograd_sequential(prims, d_out, d_s_out)])
