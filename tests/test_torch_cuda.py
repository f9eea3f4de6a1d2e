"""The port's CUDA kernels on the card, against their plain PyTorch
versions.  Every test here carries the ``cuda`` marker and skips where
there is no CUDA device; the module imports neither JAX nor the reference
package, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: f32 1e-4 (the same f32 arithmetic summed in another order;
measured errors are below 1e-5 at values up to 34); bf16 outputs are
rounded to bf16 by both sides, so one bf16 ulp, 2**-7 relative.  The
training kernels' grads span larger values (dw in the hundreds), so their
tolerance is taken relative to the largest value of each output.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.kernels.wkv import bwd as BW
from repro_torch.kernels.wkv import decode as D
from repro_torch.kernels.wkv import kernel as K
from repro_torch.kernels.wkv.vjp import WKVFunction
from repro_torch.model import model as M
from repro_torch.optim import adamw
from repro_torch.serve.engine import ServeEngine
from repro_torch.train import step as TS
from repro_torch.tree import tree_leaves, tree_map

pytestmark = pytest.mark.cuda

F32_TOL = 1e-4
BF16_RTOL = 2.0 ** -7


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the WKV kernels are CUDA C++ for sm_90a")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(b, h, t, seed, device, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, h, t, 64)).astype(np.float32) for _ in range(3))
    w = rng.uniform(0.85, 0.999, (b, h, t, 64)).astype(np.float32)
    u = rng.standard_normal((h, 64)).astype(np.float32)
    h0 = rng.standard_normal((b, h, 64, 64)).astype(np.float32)
    io = [torch.from_numpy(a).to(device, dtype) for a in (r, k, v, w, u)]
    return io + [torch.from_numpy(h0).to(device)]


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def _close(got, want, tol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.float().cpu().numpy(), w.float().cpu().numpy(),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,chunk", [(256, 16), (100, 10), (64, 64)])
def test_chunked_matches_plain(cuda, dtype, t, chunk):
    args = _inputs(2, 4, t, t, cuda, dtype)
    got = K.wkv_cuda(*args, chunk=chunk)
    assert got[0].dtype == dtype and got[1].dtype == torch.float32
    _close(got, K.wkv_plain(*args, chunk=chunk),
           F32_TOL if dtype == torch.float32 else BF16_RTOL)


@pytest.mark.parametrize("kw", [1, 8, 37, 64])
def test_window_is_chained_single_steps(cuda, kw):
    args = _inputs(2, 4, kw, kw, cuda)
    r, k, v, w, u, s = args
    out, s_win = D.wkv_decode_window_cuda(*args)
    outs = []
    for i in range(kw):
        o, s = D.wkv_decode_cuda(*(x[:, :, i:i + 1].contiguous() for x in (r, k, v, w)), u, s)
        outs.append(o)
    assert torch.equal(torch.cat(outs, 2), out) and torch.equal(s, s_win)
    _close([out, s_win], D.wkv_decode_plain(*args), F32_TOL)


def test_wrappers_refuse_grad_and_bad_layouts(cuda):
    args = _inputs(1, 1, 1, 0, cuda)
    with pytest.raises(ValueError, match="grad"):
        D.wkv_decode_cuda(args[0].clone().requires_grad_(True), *args[1:])
    with pytest.raises(ValueError, match="contiguous"):
        wide = _inputs(1, 2, 4, 0, cuda)
        K.wkv_cuda(wide[0].transpose(2, 3), *wide[1:], chunk=4)
    with pytest.raises(ValueError, match="h0 must be float32"):
        D.wkv_decode_cuda(*args[:5], args[5].double())


def test_reduced_model_card_matches_cpu(cuda):
    """The reduced f32 model through the kernels against the same weights
    through the plain versions on the CPU: greedy tokens equal (a 40-token
    prefill through the window kernel, an 80-token forward through the
    chunked kernel, then single steps)."""
    cfg = get_config("rwkv6-1.6b").reduced()
    p_cpu = M.init_params(cfg, seed=1, device="cpu")
    p_gpu = _to(p_cpu, cuda)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 80)))
    with torch.inference_mode():
        l_cpu = M.forward(p_cpu, cfg, toks)
        l_gpu = M.forward(p_gpu, cfg, toks.to(cuda))
    _close([l_gpu], [l_cpu], F32_TOL)
    g_cpu = ServeEngine(cfg, p_cpu, max_len=128, device="cpu").generate(toks[:, :40], 12)
    g_gpu = ServeEngine(cfg, p_gpu, max_len=128).generate(toks[:, :40].to(cuda), 12)
    assert torch.equal(g_cpu, g_gpu.cpu())


def _close_scaled(got, want, tol):
    for g, w in zip(got, want):
        g, w = g.float().cpu().numpy(), w.float().cpu().numpy()
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol * max(1.0, np.abs(w).max()))


def _cotangents(b, h, t, seed, device, dtype):
    rng = np.random.default_rng(seed + 100)
    d_out = torch.from_numpy(rng.standard_normal((b, h, t, 64)).astype(np.float32))
    d_s = torch.from_numpy(rng.standard_normal((b, h, 64, 64)).astype(np.float32))
    return d_out.to(device, dtype), d_s.to(device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,chunk", [(256, 16), (100, 10)])
def test_train_forward_matches_plain(cuda, dtype, t, chunk):
    args = _inputs(2, 4, t, t, cuda, dtype)
    got = K.wkv_train_cuda(*args, chunk=chunk)
    assert got[2].shape == (2, 4, t // chunk, 64, 64)
    tol = F32_TOL if dtype == torch.float32 else BF16_RTOL
    _close_scaled(got, K.wkv_train_plain(*args, chunk=chunk), tol)
    # s_hist costs the inference outputs nothing: they are bit-identical.
    inf = K.wkv_cuda(*args, chunk=chunk)
    assert torch.equal(inf[0], got[0]) and torch.equal(inf[1], got[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,chunk", [(256, 16), (100, 10), (64, 32)])
def test_backward_matches_plain(cuda, dtype, t, chunk):
    r, k, v, w, u, h0 = _inputs(2, 4, t, t, cuda, dtype)
    _, _, s_hist = K.wkv_train_cuda(r, k, v, w, u, h0, chunk=chunk)
    d_out, d_s = _cotangents(2, 4, t, t, cuda, dtype)
    args = (r, k, v, w, u, s_hist, d_out, d_s)
    got = BW.wkv_bwd_cuda(*args, chunk=chunk)
    assert [g.dtype for g in got] == [dtype] * 4 + [torch.float32] * 2
    tol = 1e-4 if dtype == torch.float32 else BF16_RTOL
    _close_scaled(got, BW.wkv_bwd_plain(*args, chunk=chunk), tol)
    again = BW.wkv_bwd_cuda(*args, chunk=chunk)
    assert all(torch.equal(a, b) for a, b in zip(got, again))   # no atomics


def test_training_wrappers_refuse_grad_and_bad_args(cuda):
    r, k, v, w, u, h0 = _inputs(1, 2, 32, 0, cuda)
    with pytest.raises(ValueError, match="grad"):
        K.wkv_train_cuda(r.clone().requires_grad_(True), k, v, w, u, h0, chunk=16)
    _, _, s_hist = K.wkv_train_cuda(r, k, v, w, u, h0, chunk=16)
    d_out, d_s = _cotangents(1, 2, 32, 0, cuda, torch.float32)
    with pytest.raises(ValueError, match="grad"):
        BW.wkv_bwd_cuda(r, k, v, w, u, s_hist, d_out.requires_grad_(True), d_s, chunk=16)
    with pytest.raises(ValueError, match="s_hist shape"):
        BW.wkv_bwd_cuda(r, k, v, w, u, s_hist, d_out.detach(), d_s, chunk=8)
    with pytest.raises(ValueError, match="chunk=64"):
        BW.wkv_bwd_cuda(*(x.repeat(1, 1, 2, 1) if x.ndim == 4 else x
                          for x in (r, k, v, w)), u, s_hist, d_out.detach(), d_s, chunk=64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_function_grads_card_match_cpu(cuda, dtype):
    base = _inputs(2, 4, 64, 3, "cpu", dtype)
    d_out, d_s = _cotangents(2, 4, 64, 3, "cpu", dtype)
    grads = {}
    for dev in ("cpu", cuda):
        args = [x.to(dev).requires_grad_(True) for x in base]
        out, s = WKVFunction.apply(*args, 16)
        loss = (out.float() * d_out.to(dev).float()).sum() + (s * d_s.to(dev)).sum()
        grads[str(dev)] = torch.autograd.grad(loss, args)
    tol = 1e-4 if dtype == torch.float32 else BF16_RTOL
    _close_scaled(grads["cuda"], grads["cpu"], tol)


def test_reduced_train_step_card_matches_cpu(cuda):
    """One train step (microbatch 2, full remat) of the reduced f32 model
    through the kernels against the same step through the plain versions
    on the CPU: loss, grad norm and updated parameters (a first AdamW step
    moves each by at most 2 lr = 6e-6 here, so 1e-5 absolute)."""
    cfg = dataclasses.replace(get_config("rwkv6-1.6b").reduced(), microbatch=2, remat="full")
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=4, seed=2)
    params = TS.init_train_state(cfg, 1, device="cpu").params
    out = {}
    for dev in ("cpu", cuda):
        # A copy per device: the step updates the parameters in place.
        moved = tree_map(lambda p: p.detach().to(dev, copy=True).requires_grad_(True), params)
        state = TS.TrainState(moved, adamw.init_state(moved), None)
        state, m = TS.make_train_step(cfg)(state, make_batch(dcfg, 0, device=dev))
        out[str(dev)] = (float(m["loss"]), float(m["grad_norm"]),
                         [p.detach().cpu() for p in tree_leaves(state.params)])
    (l_c, g_c, p_c), (l_g, g_g, p_g) = out["cpu"], out["cuda"]
    assert l_g == pytest.approx(l_c, rel=1e-5) and g_g == pytest.approx(g_c, rel=1e-4)
    for a, b in zip(p_g, p_c):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5)
