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
from pathlib import Path

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
        pytest.skip("needs a CUDA device: the port's kernels are CUDA C++ for sm_90a")
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 2, 4])
@pytest.mark.parametrize("kw", [1, 2, 8, 37, 64])
def test_window_is_chained_single_steps(cuda, kw, b, dtype):
    """At RWKV6's 32 heads, so B=1 takes a 32-column plan and B=2, 4 the
    64-column one; K=64 in f32 runs with the opted-in shared memory."""
    args = _inputs(b, 32, kw, kw + b, cuda, dtype)
    r, k, v, w, u, s = args
    out, s_win = D.wkv_decode_window_cuda(*args)
    outs = []
    for i in range(kw):
        o, s = D.wkv_decode_cuda(*(x[:, :, i:i + 1].contiguous() for x in (r, k, v, w)), u, s)
        outs.append(o)
    assert torch.equal(torch.cat(outs, 2), out) and torch.equal(s, s_win)
    _close([out, s_win], D.wkv_decode_plain(*args),
           F32_TOL if dtype == torch.float32 else BF16_RTOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,kw", [(1, 1), (4, 1), (1, 8), (4, 37), (2, 64)])
def test_decode_plans_are_bit_equal(cuda, monkeypatch, b, kw, dtype):
    """Every column tile gives the same bits: through ``launch_plan``, and
    through the wrapper with the SM count forced so that the planner's own
    function picks each tile."""
    args = _inputs(b, 32, kw, 40 + kw, cuda, dtype)
    want = D.wkv_decode_window_cuda(*args)
    for tile in D.DECODE_TILES:
        got = D.launch_plan(*args, col_tile=tile)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), tile
    forced = {}
    for sms in (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096):
        monkeypatch.setattr(D, "sm_count", lambda dev, sms=sms: sms)
        tile = D.plan_decode_columns(b, 32, kw, dtype, sms)
        if tile not in forced:
            forced[tile] = D.wkv_decode_window_cuda(*args)
    assert set(forced) == set(D.DECODE_TILES)
    for tile, got in forced.items():
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), tile


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kw", [1, 37])
def test_decode_s_out_may_alias_h0(cuda, kw, dtype):
    """The C entry point with s_out = h0: each block reads its state tile
    before it writes it, so the state is updated in place."""
    from repro_torch.kernels import common

    args = _inputs(4, 32, kw, 7, cuda, dtype)
    want = D.wkv_decode_window_cuda(*args)
    r, k, v, w, u, h0 = args
    out = torch.empty_like(r)
    for tile in D.DECODE_TILES:
        s = h0.clone()
        err = common.load_library("wkv_decode").wkv_decode_window_fwd(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
            s.data_ptr(), out.data_ptr(), s.data_ptr(), 4, 32, kw, 64,
            common.DTYPE_CODE[dtype], tile, torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        assert err == 0
        assert torch.equal(out, want[0]) and torch.equal(s, want[1]), tile


def test_decode_shared_memory_formula_matches_the_source(cuda):
    """The plan's shared-memory size (pure Python) equals the source's
    layout; K=64 needs more than the 48 KB default in both dtypes, and the
    wrapper's launch there (after the source's opt-in) matches the plain
    version."""
    from repro_torch.kernels import common

    lib = common.load_library("wkv_decode")
    for kw in range(1, 65):
        for code, item in ((0, 4), (1, 2)):
            assert lib.wkv_decode_smem(kw, code) == D.decode_smem_bytes(kw, item)
    assert lib.wkv_decode_smem(64, 0) > 48 * 1024
    args = _inputs(2, 32, 64, 64, cuda, torch.float32)
    _close(D.wkv_decode_window_cuda(*args), D.wkv_decode_plain(*args), F32_TOL)


def test_decode_refuses_misaligned_tensors(cuda):
    """The bulk copies need 16-byte aligned slabs: a view that starts one
    element in is refused by the C entry point, and the wrapper raises."""
    args = _inputs(1, 2, 1, 0, cuda)
    base = torch.zeros(args[0].numel() + 1, device=cuda)
    shifted = base[1:].view(args[0].shape)
    shifted.copy_(args[0])
    with pytest.raises(RuntimeError, match="launch failed"):
        D.wkv_decode_cuda(shifted, *args[1:])


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


def _first_moments_close(got, want, tol=1e-4):
    """After one step AdamW's first moment is (1 - b1) times the clipped
    gradient: each leaf held as the CPU tests hold gradients (GRAD_TOL, 1e-4
    of the leaf's largest value), so a gradient's sign and size both count."""
    for g, w in zip(got, want):
        g, w = g.cpu().numpy(), w.cpu().numpy()
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol * max(1e-3, np.abs(w).max()))


def test_reduced_train_step_card_matches_cpu(cuda):
    """One train step (microbatch 2, full remat) of the reduced f32 model
    through the kernels against the same step through the plain versions
    on the CPU: loss, grad norm, each gradient leaf (AdamW's first moment)
    and updated parameters (a first AdamW step moves each by at most 2 lr =
    6e-6 here, so 1e-5 absolute)."""
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
                         [p.detach().cpu() for p in tree_leaves(state.params)],
                         tree_leaves(state.opt.mu))
    (l_c, g_c, p_c, m_c), (l_g, g_g, p_g, m_g) = out["cpu"], out["cuda"]
    assert l_g == pytest.approx(l_c, rel=1e-5) and g_g == pytest.approx(g_c, rel=1e-4)
    _first_moments_close(m_g, m_c)
    for a, b in zip(p_g, p_c):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# RecurrentGemma's kernels: the elevator scan and its decode window, the
# token shift and flash attention.
# ---------------------------------------------------------------------------

from repro_torch.kernels import card_checks as CC  # noqa: E402
from repro_torch.kernels.elevator_scan import decode as ED  # noqa: E402
from repro_torch.kernels.elevator_scan import kernel as EK  # noqa: E402
from repro_torch.kernels.local_attention import kernel as FA  # noqa: E402
from repro_torch.kernels.token_shift import kernel as TS_K  # noqa: E402

def _attn_close(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    if got.dtype == torch.float32:
        _close([got], [want], F32_TOL)
    else:
        ratio = CC.attn_bf16_ratio(got, want)
        assert ratio <= 1.0, f"bf16 attention error is {ratio:.3f} x its tolerance"


def _scan_inputs(b, t, d, seed, device, dtype=torch.float32, h0=True):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (b, t, d)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((b, t, d)).astype(np.float32))
    h = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32)) if h0 else None
    return (a.to(device, dtype), x.to(device, dtype),
            None if h is None else h.to(device))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,d,h0", [(4, 256, 2560, True), (1, 1000, 200, False),
                                      (2, 1, 64, True), (3, 129, 384, True)])
def test_elevator_scan_matches_plain(cuda, dtype, b, t, d, h0):
    """Bit for bit since the serial-chain redesign: the kernel runs each
    channel's steps in the plain version's order and rounding."""
    a, x, h = _scan_inputs(b, t, d, t + d, cuda, dtype, h0)
    got = EK.elevator_scan_cuda(a, x, h)
    assert got.dtype == dtype and got.shape == (b, t, d)
    assert torch.equal(got, EK.elevator_scan_ref(a, x, h))


def _misaligned(t):
    """A contiguous copy of ``t`` that starts 4 bytes past a 16-byte
    boundary (no tensor map takes it)."""
    flat = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
    off = 4 // t.element_size()
    out = flat[off:off + t.numel()].view(t.shape)
    out.copy_(t)
    assert out.is_contiguous() and out.data_ptr() % 16 == 4
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,d,h0", [(4, 256, 2560, True), (1, 1000, 200, False),
                                      (2, 1, 64, True), (3, 129, 384, True),
                                      (2, 77, 250, True), (1, 65, 2563, False),
                                      (1, 4096, 2560, True)])
def test_elevator_scan_every_plan_is_bit_equal(cuda, dtype, b, t, d, h0):
    """Every plan of ``scan_plans`` (the TMA ring's channel tiles, the
    loader-warp variant) equals the plain version bit for bit, h0 absent
    too; inputs 4 bytes off the 16-byte grid take the loader warps and
    agree as well."""
    a, x, h = _scan_inputs(b, t, d, 7 * t + d, cuda, dtype, h0)
    want = EK.elevator_scan_ref(a, x, h)
    plans = EK.scan_plans(b, t, d, dtype)
    assert EK.plan_scan(b, t, d, dtype, torch.cuda.get_device_properties(0).multi_processor_count) \
        in plans
    for plan in plans:
        got = EK.launch_plan(a, x, h, plan=plan)
        assert torch.equal(got, want), plan
    am, xm = _misaligned(a), _misaligned(x)
    assert EK.plan_scan(b, t, d, dtype, 132, EK.pointer_alignment(am, xm)).mode == "loaders"
    assert torch.equal(EK.elevator_scan_cuda(am, xm, h), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_elevator_scan_equals_chained_windows(cuda, dtype):
    """The scan over 200 tokens equals windows of 64, 64, 64 and 8 tokens
    chained through their f32 exit states, bit for bit: one step function,
    one order."""
    a, x, h = _scan_inputs(2, 200, 2560, 31, cuda, dtype)
    whole = EK.elevator_scan_cuda(a, x, h)
    outs = []
    for lo in range(0, 200, 64):
        o, h = ED.elevator_decode_window_cuda(a[:, lo:lo + 64].contiguous(),
                                              x[:, lo:lo + 64].contiguous(), h)
        outs.append(o)
    assert torch.equal(torch.cat(outs, 1), whole)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kw", [1, 8, 37, 64])
def test_elevator_window_is_chained_single_steps(cuda, dtype, kw):
    a, x, h = _scan_inputs(4, kw, 2560, kw, cuda, dtype)
    out, h_win = ED.elevator_decode_window_cuda(a, x, h)
    outs = []
    for i in range(kw):
        o, h = ED.elevator_decode_window_cuda(a[:, i:i + 1].contiguous(),
                                              x[:, i:i + 1].contiguous(), h)
        outs.append(o)
    assert torch.equal(torch.cat(outs, 1), out) and torch.equal(h, h_win)
    a, x, h = _scan_inputs(4, kw, 2560, kw, cuda, dtype)
    want = ED.elevator_decode_window_plain(a, x, h)
    assert torch.equal(out, want[0]) and torch.equal(h_win, want[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("kw", [1, 8, 37, 64])
def test_elevator_window_every_plan_is_chained_single_steps(cuda, dtype, b, kw):
    """Every plan of ``window_plans`` (staged by TMA, or register loads at
    each access width and block size) equals K chained single launches and
    the plain version bit for bit, at B=1 and B=4."""
    a, x, h = _scan_inputs(b, kw, 2560, 3 * kw + b, cuda, dtype)
    want = ED.elevator_decode_window_plain(a, x, h)
    hh, outs = h, []
    for i in range(kw):
        o, hh = ED.elevator_decode_window_cuda(a[:, i:i + 1].contiguous(),
                                               x[:, i:i + 1].contiguous(), hh)
        outs.append(o)
    assert torch.equal(torch.cat(outs, 1), want[0]) and torch.equal(hh, want[1])
    for plan in ED.window_plans(b, kw, 2560, dtype):
        out, h_out = ED.launch_plan(a, x, h, plan=plan)
        assert torch.equal(out, want[0]) and torch.equal(h_out, want[1]), plan


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kw", [1, 8, 64])
def test_elevator_window_h_out_may_alias_h0(cuda, dtype, kw):
    """The C entry point with h_out = h0, in every plan: each thread reads
    its h0 entries before it writes its exit state."""
    from repro_torch.kernels import common

    lib = common.load_library("elevator_scan")
    a, x, h = _scan_inputs(4, kw, 2560, 5 + kw, cuda, dtype)
    want = ED.elevator_decode_window_plain(a, x, h)
    for plan in ED.window_plans(4, kw, 2560, dtype):
        h_io, out = h.clone(), torch.empty_like(x)
        err = lib.elevator_decode_window_fwd(
            a.data_ptr(), x.data_ptr(), h_io.data_ptr(), out.data_ptr(), h_io.data_ptr(),
            4, kw, 2560, common.DTYPE_CODE[dtype], plan.vec, plan.threads,
            ED.WINDOW_MODES[plan.mode], torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        assert err == 0, plan
        assert torch.equal(out, want[0]) and torch.equal(h_io, want[1]), plan


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,d,taps", [(4, 4, 2560, 4), (4, 259, 2560, 4), (1, 67, 100, 2),
                                        (2, 1, 300, 8), (1, 4096, 2560, 4)])
def test_token_shift_matches_plain(cuda, dtype, b, t, d, taps):
    rng = np.random.default_rng(t)
    x = torch.from_numpy(rng.standard_normal((b, t, d)).astype(np.float32)).to(cuda, dtype)
    w = torch.from_numpy(rng.standard_normal((taps, d)).astype(np.float32)).to(cuda, dtype)
    got = TS_K.token_shift_cuda(x, w)
    want = TS_K.token_shift_ref(x, w)
    assert got.dtype == dtype
    # The same f32 products and sums in the same order: equal bit for bit.
    assert torch.equal(got, want)


@pytest.mark.parametrize("d", [2560, 2562])
@pytest.mark.parametrize("t", [1, 3, 4, 7, 259, 4096])
def test_token_shift_f32_bit_for_bit(cuda, t, d):
    """f32 at every tap count, at a D that is a multiple of the 4-channel
    slot and one that is not (its last slot is a tail of 2), and on rows
    that are not 16-byte aligned (a view one element in): equal to the plain
    version bit for bit."""
    rng = np.random.default_rng(t * 7 + d)
    for taps in range(2, TS_K.MAX_TAPS + 1):
        x = torch.from_numpy(rng.standard_normal((2, t, d)).astype(np.float32)).to(cuda)
        w = torch.from_numpy(rng.standard_normal((taps, d)).astype(np.float32)).to(cuda)
        assert torch.equal(TS_K.token_shift_cuda(x, w), TS_K.token_shift_ref(x, w)), taps
    base = torch.zeros(x.numel() + 1, device=cuda)
    xm = base[1:].view(x.shape)
    xm.copy_(x)
    assert torch.equal(TS_K.token_shift_cuda(xm, w), TS_K.token_shift_ref(xm, w))


def _qkv(b, hq, hkv, t, s, d, seed, device, dtype):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32)).to(device, dtype)
               for sh in ((b, hq, t, d), (b, hkv, s, d), (b, hkv, s, d)))
    return q, k, v


ATTN_CASES = [
    # (b, hq, hkv, t, s, causal, window)
    (1, 2, 2, 128, 128, True, None),       # causal, full
    (1, 2, 2, 384, 384, True, None),
    (2, 8, 1, 256, 256, True, None),       # GQA group 8
    (1, 4, 2, 768, 768, True, 256),        # sliding window
    (1, 2, 2, 256, 256, True, 4096),       # window past T
    (2, 4, 4, 128, 384, False, None),      # non-causal, full
    (1, 2, 1, 300, 300, False, 100),       # non-causal window
    (1, 2, 2, 200, 200, True, None),       # T, S not block multiples
    (2, 4, 2, 1, 512, True, None),         # decode alignment
    (1, 2, 1, 8, 300, True, 128),          # windowed decode offset
    (1, 10, 1, 4096, 4096, True, 2048),    # RecurrentGemma's local layers
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("case", ATTN_CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_attention_matches_plain(cuda, dtype, d, case):
    b, hq, hkv, t, s, causal, window = case
    q, k, v = _qkv(b, hq, hkv, t, s, d, t * 7 + s, cuda, dtype)
    got = FA.flash_attention_cuda(q, k, v, causal=causal, window=window)
    _attn_close(got, FA.attention_ref(q, k, v, causal=causal, window=window))


#: (Hq, Hkv, D, T) of the decoder-only archs' scoring: qwen2-0.5b (14/2 at
#: 64, T=4096), minitron-8b (32/8), nemotron-4-15b and dbrx (48/8),
#: qwen2-vl-7b (28/4) and qwen3-moe (64/4), all at 128 and T=2048.
ARCH_HEADS = [(14, 2, 64, 4096), (32, 8, 128, 2048), (48, 8, 128, 2048),
              (28, 4, 128, 2048), (64, 4, 128, 2048)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["causal", "decode-offset", "odd-T"])
@pytest.mark.parametrize("heads", ARCH_HEADS, ids=lambda h: "-".join(map(str, h)))
def test_flash_attention_at_decoder_arch_heads(cuda, dtype, mode, heads):
    """GQA over several KV heads: causal with no window over the whole T,
    an offset decode window (T=8 against S=300), and a T that is not a
    block multiple."""
    hq, hkv, d, t = heads
    t, s = {"causal": (t, t), "decode-offset": (8, 300), "odd-T": (1000, 1000)}[mode]
    q, k, v = _qkv(1, hq, hkv, t, s, d, hq * 13 + t, cuda, dtype)
    got = FA.flash_attention_cuda(q, k, v, causal=True)
    _attn_close(got, FA.attention_ref(q, k, v, causal=True))


#: (T, S) of seamless-m4t-large-v2's flash shapes that fit a test, MHA (16
#: query and 16 KV heads of 64), non-causal with no window: its encoder at
#: 1000 frames, cross-attention in decoding (1 and 64 tokens over 1000
#: frames) and with more queries than keys (600 over 300).
#: (B, T, S, causal) of seamless-m4t's flash calls that fit a test: its
#: encoder, its decoder's causal self-attention at MHA (group 1), and
#: cross-attention at scoring and in decoding at B=4.
SEAMLESS_SHAPES = [(1, 1000, 1000, False), (1, 1, 1000, False), (1, 64, 1000, False),
                   (1, 600, 300, False), (1, 1024, 1024, True), (4, 1024, 1024, False),
                   (4, 1, 1024, False), (4, 64, 1024, False)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SEAMLESS_SHAPES, ids=lambda s: "-".join(map(str, s)))
def test_flash_attention_at_seamless_heads(cuda, dtype, shape):
    b, t, s, causal = shape
    q, k, v = _qkv(b, 16, 16, t, s, 64, t * 3 + s + b, cuda, dtype)
    got = FA.flash_attention_cuda(q, k, v, causal=causal)
    _attn_close(got, FA.attention_ref(q, k, v, causal=causal))


def test_reduced_seamless_card_matches_cpu(cuda):
    """The reduced f32 seamless-m4t through the flash kernel (encoder,
    decoder and cross-attention) against the same weights with the plain
    version on the CPU: forward logits within 1e-4 and greedy decoding
    through ``make_decode_step`` against ``encode``'s output with equal
    tokens."""
    from repro_torch.serve.engine import make_decode_step

    cfg = get_config("seamless-m4t-large-v2").reduced()
    p_cpu = M.init_params(cfg, seed=1, device="cpu")
    p_gpu = _to(p_cpu, cuda)
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 40)))
    fr = torch.from_numpy(rng.standard_normal((2, 48, cfg.d_model)).astype(np.float32))
    step = make_decode_step(cfg)
    outs = {}
    with torch.inference_mode():
        l_cpu = M.forward(p_cpu, cfg, toks, enc_tokens_embeds=fr)
        l_gpu = M.forward(p_gpu, cfg, toks.to(cuda), enc_tokens_embeds=fr.to(cuda))
        _close([l_gpu], [l_cpu], F32_TOL)
        for dev, p in (("cpu", p_cpu), (cuda, p_gpu)):
            enc = M.encode(p, cfg, fr.to(dev))
            state = M.init_decode_state(cfg, 2, 64, 24, device=dev)
            logits, state = step(p, state, toks[:, :24].to(dev), 0, enc_out=enc)
            seq = [logits[:, -1].argmax(-1)]
            for i in range(24, 36):
                logits, state = step(p, state, seq[-1][:, None], i, enc_out=enc)
                seq.append(logits[:, -1].argmax(-1))
            outs[str(dev)] = torch.stack(seq, 1).cpu()
    assert torch.equal(outs["cpu"], outs["cuda"])


def test_moe_layer_is_deterministic_and_matches_cpu(cuda):
    """The MoE layer's combine sums each token's rows in a fixed order (no
    atomics): two card runs give the same bits, and the f32 layer equals
    the CPU's within 1e-5 of its largest output."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.model import model as M
    from repro_torch.model import moe as MoE

    cfg = dataclasses.replace(get_config("qwen3-moe-235b-a22b").reduced(), num_experts=32,
                              num_experts_per_tok=8)
    gen = torch.Generator().manual_seed(0)
    mk = M.init_mk(gen, torch.float32, torch.device("cpu"))
    p_cpu = MoE.init_moe(mk, cfg, "moe")
    p_gpu = {k: v.to(cuda) for k, v in p_cpu.items()}
    x = torch.randn(4, 64, cfg.d_model, generator=gen)
    a = MoE.apply_moe(p_gpu, x.to(cuda), cfg)
    assert torch.equal(a, MoE.apply_moe(p_gpu, x.to(cuda), cfg))
    want = MoE.apply_moe(p_cpu, x, cfg)
    assert float((a.cpu() - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_flash_attention_fully_masked_rows_are_zero(cuda):
    # T > S, causal: the first T - S queries see no key.
    q, k, v = _qkv(1, 2, 2, 96, 64, 64, 0, cuda, torch.bfloat16)
    got = FA.flash_attention_cuda(q, k, v, causal=True)
    assert bool((got[:, :, :32] == 0).all())
    _attn_close(got, FA.attention_ref(q, k, v, causal=True))


#: Faults planted in copies of the bf16 kernel's source, each of which the
#: bf16 check must reject at RecurrentGemma's shape: (anchor, replacement).
#: Each touches only some rows, as a real indexing or rescale bug would.
_FIRST = "    int i_first = any ? (w_lo - kb_first) / BK : 0;\n"
FLASH_FAULTS = {
    # Each warpgroup skips the first K tile of its run wherever the block's
    # key range spans more than 16 tiles (the rows from about 900 on); it
    # still waits for the tile and hands it back.
    "skip_first_tile": (_FIRST, _FIRST + "    if (hi - lo > 16 * BK) ++i_first;\n"),
    # The same, only where the window has slid past key 0 (rows >= 2048):
    # late rows move by a few percent, under the old whole-output bound.
    "skip_first_tile_late": (_FIRST, _FIRST + "    if (lo > 0) ++i_first;\n"),
    # Leave the online-softmax rescale off the lower 8 rows of each warp's
    # 16 (one half of a warpgroup's rows).
    "alpha_off_row_half": ("          o[4 * n + 2] *= alpha[1];\n          o[4 * n + 3] *= alpha[1];\n",
                           ""),
    # Reduce the row sum over only half the row's threads for that half.
    "l_sum_half": ("      l += __shfl_xor_sync(0xffffffffu, l, 2);\n",
                   "      if (h == 0) l += __shfl_xor_sync(0xffffffffu, l, 2);\n"),
}


def _compile_mutants(name, faults, out):
    """Each planted fault (an (anchor, replacement) pair or a tuple of them)
    compiled into its own copy of library ``name`` (nvcc in parallel, the
    build's flags); returns fault -> loaded library, its entry points bound
    as the build binds them."""
    import subprocess

    from repro_torch.kernels import common

    src = common.KERNEL_SOURCES[name].read_text()
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for fault, edit in faults.items():
        # One (anchor, replacement) pair, or a tuple of them applied in turn.
        text = src
        for anchor, repl in (edit if isinstance(edit[0], tuple) else (edit,)):
            assert text.count(anchor) == 1, fault
            text = text.replace(anchor, repl)
        cu = out / f"{fault}.cu"
        cu.write_text(text)
        procs[fault] = subprocess.Popen(
            [common._nvcc(), *common._NVCC_FLAGS, "-I", str(common.KERNEL_SOURCES[name].parent),
             "-o", str(out / f"{fault}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for fault, proc in procs.items():
        report, _ = proc.communicate()
        assert proc.returncode == 0, report
    return {fault: common.open_library(name, out / f"{fault}.so") for fault in faults}


@pytest.fixture(scope="module")
def flash_mutants(tmp_path_factory):
    """Each planted fault compiled into its own library (nvcc in parallel)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels are CUDA C++ for sm_90a")
    return _compile_mutants("flash_attention", FLASH_FAULTS,
                            tmp_path_factory.mktemp("flash_mutants"))


@pytest.mark.parametrize("fault", list(FLASH_FAULTS))
def test_flash_bf16_check_rejects_planted_fault(cuda, flash_mutants, monkeypatch, fault):
    from repro_torch.kernels import common

    q, k, v = _qkv(1, 10, 1, 4096, 4096, 256, 11, cuda, torch.bfloat16)
    want = FA.attention_ref(q, k, v, causal=True, window=2048)
    good = FA.flash_attention_cuda(q, k, v, causal=True, window=2048)
    monkeypatch.setitem(common._LIBS, "flash_attention", flash_mutants[fault])
    bad = FA.flash_attention_cuda(q, k, v, causal=True, window=2048)
    # The old check, for the record: max error <= 2e-2 + 8e-3 * max|plain|.
    old_tol = 2e-2 + 8e-3 * float(want.float().abs().max())
    for name, got in (("kernel", good), (fault, bad)):
        err = float((got.float() - want.float()).abs().max())
        print(f"[flash-fault] {name}: max_abs_err={err:.3e} old check "
              f"{'passes' if err <= old_tol else 'fails'} (tol {old_tol:.3e}); new check "
              f"ratio {CC.attn_bf16_ratio(got, want):.3f}")
    assert CC.attn_bf16_ratio(good, want) <= 1.0
    assert CC.attn_bf16_ratio(bad, want) > 1.0


def test_new_wrappers_refuse_grad_and_bad_args(cuda):
    a, x, h = _scan_inputs(1, 4, 64, 0, cuda)
    with pytest.raises(ValueError, match="grad"):
        EK.elevator_scan_cuda(a.clone().requires_grad_(True), x, h)
    with pytest.raises(ValueError, match="float32"):
        ED.elevator_decode_window_cuda(a, x, h.double())
    with pytest.raises(ValueError, match="grad"):
        TS_K.token_shift_cuda(x.requires_grad_(True), torch.ones(4, 64, device=cuda))
    q, k, v = _qkv(1, 2, 1, 8, 8, 48, 0, cuda, torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        FA.flash_attention_cuda(q, k, v)


def test_reduced_recurrentgemma_card_matches_cpu(cuda):
    """The reduced f32 RecurrentGemma through the kernels against the same
    weights through the plain versions on the CPU: forward logits at
    T=200 (past the window of 64) within 1e-4, and greedy tokens equal (a
    40-token prefill through the window kernel, then single steps)."""
    cfg = get_config("recurrentgemma-2b").reduced()
    p_cpu = M.init_params(cfg, seed=1, device="cpu")
    p_gpu = _to(p_cpu, cuda)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 200)))
    with torch.inference_mode():
        l_cpu = M.forward(p_cpu, cfg, toks)
        l_gpu = M.forward(p_gpu, cfg, toks.to(cuda))
    _close([l_gpu], [l_cpu], F32_TOL)
    g_cpu = ServeEngine(cfg, p_cpu, max_len=128, device="cpu").generate(toks[:, :40], 12)
    g_gpu = ServeEngine(cfg, p_gpu, max_len=128).generate(toks[:, :40].to(cuda), 12)
    assert torch.equal(g_cpu, g_gpu.cpu())


# ---------------------------------------------------------------------------
# The paper-demo kernels: the 5-point stencil and the operand-forwarding
# matmul, and the Rodinia suite on the card.
# ---------------------------------------------------------------------------

from repro_torch.benchmarks import rodinia  # noqa: E402
from repro_torch.kernels.matmul_fwd import kernel as MM  # noqa: E402
from repro_torch.kernels.matmul_fwd import ops as MM_OPS  # noqa: E402
from repro_torch.kernels.stencil2d import kernel as ST  # noqa: E402
from repro_torch.kernels.stencil2d import ops as ST_OPS  # noqa: E402

#: The shared card checks (``repro_torch.kernels.card_checks``, which
#: ``chip_smoke.py`` runs too) and this file's extra shapes: a one-row grid;
#: the reference test's other matmul cases and odd shapes inside the block
#: contract (K or N not a multiple of 8 take the element-wise tile loads).
STENCIL_CASES = CC.STENCIL_CASES + ((1, 33, (0.5, 0.1, 0.2, 0.3, 0.4), 2.0),)
MATMUL_CASES = CC.MATMUL_CASES + (
    (128, 128, 128, 128, 128, 128),
    (256, 512, 128, 128, 128, 256),
    (100, 36, 72, 256, 256, 256),
    (96, 100, 60, 256, 256, 256),
    (3, 5, 7, 256, 256, 256),
)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", STENCIL_CASES, ids=lambda c: f"{c[0]}x{c[1]}-b{c[3]}")
def test_stencil2d_matches_plain_bit_for_bit(cuda, dtype, case):
    h, w, coeffs, boundary = case
    rng = np.random.default_rng(h + w)
    x = torch.from_numpy(rng.standard_normal((h, w)).astype(np.float32)).to(cuda, dtype)
    c = torch.tensor(coeffs, device=cuda)
    n = ST.stencil2d_cuda.launches
    got = ST_OPS.stencil2d(x, c, boundary=boundary)
    assert ST.stencil2d_cuda.launches == n + 1
    want = ST.stencil2d_ref(x, c, boundary)
    assert got.dtype == dtype and got.shape == (h, w)
    # The same f32 products summed in the same order, rounded once.
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", MATMUL_CASES, ids=lambda c: "x".join(map(str, c[:3])))
def test_matmul_fwd_matches_plain(cuda, dtype, case):
    m, k, n, bm, bn, bk = case
    rng = np.random.default_rng(m * n + k)
    a = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(cuda, dtype)
    b = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32)).to(cuda, dtype)
    count = MM.matmul_fwd_cuda.launches
    got = MM_OPS.matmul_fwd(a, b, block_m=bm, block_n=bn, block_k=bk)
    assert MM.matmul_fwd_cuda.launches == count + 1
    want = MM.matmul_ref(a, b)
    assert got.dtype == dtype and got.shape == (m, n)
    # f32: MATMUL_F32_RTOL of max|plain|; bf16: one bf16 ulp of the plain
    # output beyond that.
    assert CC.matmul_error(got, want)[2] <= 1.0


def test_wgmma_smallest_product_is_exact(cuda):
    """One 64 x 64 x 16 product through the wgmma variant (TMA with the
    128-byte swizzle, A K-major, B N-major through the transpose bit) on
    small integers, whose products and sums are exact in f32 and bf16: any
    misplaced element of a descriptor shows as a wrong value."""
    rng = np.random.default_rng(64)
    a = torch.from_numpy(rng.integers(-3, 4, (64, 16)).astype(np.float32))
    b = torch.from_numpy(rng.integers(-3, 4, (16, 64)).astype(np.float32))
    assert MM.plan(64, 64, 16, torch.bfloat16, 132)[0] == "wgmma"
    got = MM.matmul_fwd_cuda(a.to(cuda, torch.bfloat16), b.to(cuda, torch.bfloat16))
    assert torch.equal(got.float().cpu(), a @ b)
    # The same operands as rows of a wider product: other tiles, one k-tile.
    a2 = torch.cat([a, -a, 2 * a], 0)
    b2 = torch.cat([b, b.flip(1)], 1)
    got = MM.matmul_fwd_cuda(a2.to(cuda, torch.bfloat16), b2.to(cuda, torch.bfloat16))
    assert torch.equal(got.float().cpu(), a2 @ b2)


#: Faults planted in copies of the matmul source, each of which
#: ``card_checks.matmul_error`` must reject: (anchor, replacement).
MATMUL_FAULTS = {
    # The split-K sum leaves out the last split's plane.
    "split_sum_skips_last": (
        "    for (int z = 0; z < split; ++z) s += ws[(size_t)z * mn + i];\n",
        "    for (int z = 0; z < split - 1; ++z) s += ws[(size_t)z * mn + i];\n"),
    # The wgmma epilogue writes nothing for the last column tile.
    "epilogue_drops_last_column_tile": ("        if (c < N) {\n",
                                        "        if (c < N && n0 + BN < N) {\n"),
}
#: (M, K, N, dtype) at which each fault is checked: the split sum where K is
#: split (the suite's 256^3 in f32, split 8; K = 4096 in bf16, split 16); the
#: epilogue where the wgmma variant runs without and with a split (4096^3,
#: and K = 4096 at 256 x 256, in bf16).
MATMUL_FAULT_CASES = {
    "split_sum_skips_last": ((256, 256, 256, torch.float32),
                             (256, 4096, 256, torch.bfloat16)),
    "epilogue_drops_last_column_tile": ((4096, 4096, 4096, torch.bfloat16),
                                        (256, 4096, 256, torch.bfloat16)),
}


@pytest.fixture(scope="module")
def matmul_mutants(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels are CUDA C++ for sm_90a")
    return _compile_mutants("matmul_fwd", MATMUL_FAULTS,
                            tmp_path_factory.mktemp("matmul_mutants"))


@pytest.mark.parametrize("fault", list(MATMUL_FAULTS))
def test_matmul_check_rejects_planted_fault(cuda, matmul_mutants, monkeypatch, fault):
    from repro_torch.kernels import common

    for m, k, n, dtype in MATMUL_FAULT_CASES[fault]:
        # Inputs no other test uses, and the faulty launch first: no stale
        # output of the same product can sit in the memory it leaves unwritten.
        rng = np.random.default_rng(m + k + n + 7)
        a = torch.from_numpy(rng.uniform(-2, 2, (m, k)).astype(np.float32)).to(cuda, dtype)
        b = torch.from_numpy(rng.uniform(-2, 2, (k, n)).astype(np.float32)).to(cuda, dtype)
        with monkeypatch.context() as mp:
            mp.setitem(common._LIBS, "matmul_fwd", matmul_mutants[fault])
            bad = MM.matmul_fwd_cuda(a, b)
            torch.cuda.synchronize()
        good = MM.matmul_fwd_cuda(a, b)
        want = MM.matmul_ref(a, b)
        print(f"[matmul-fault] {fault} {m}x{k}x{n} {dtype}: kernel ratio "
              f"{CC.matmul_error(good, want)[2]:.3f}, faulty ratio "
              f"{CC.matmul_error(bad, want)[2]:.3e}")
        assert CC.matmul_error(good, want)[2] <= 1.0
        assert not CC.matmul_error(bad, want)[2] <= 1.0


def test_paper_demo_wrappers_refuse_bad_args(cuda):
    a = torch.ones(64, 64, device=cuda)
    with pytest.raises(ValueError, match="one dtype"):
        MM.matmul_fwd_cuda(a, a.bfloat16())
    with pytest.raises(ValueError, match="not divisible"):
        MM.matmul_fwd_cuda(torch.ones(300, 64, device=cuda), a)
    with pytest.raises(ValueError, match="grad"):
        MM.matmul_fwd_cuda(a.clone().requires_grad_(True), a)
    with pytest.raises(ValueError, match="CUDA device"):
        ST.stencil2d_cuda(a, torch.ones(5), block_h=64)
    with pytest.raises(ValueError, match="float32"):
        ST.stencil2d_cuda(a.double(), torch.ones(5, device=cuda), block_h=64)


def test_rodinia_smoke_on_the_card_launches_no_kernel(cuda):
    counts = (MM.matmul_fwd_cuda.launches, ST.stencil2d_cuda.launches)
    rows = rodinia.run(reps=1, smoke=True)
    assert [r["device"] for r in rows] == ["cuda"] * 9
    assert (MM.matmul_fwd_cuda.launches, ST.stencil2d_cuda.launches) == counts


# ---------------------------------------------------------------------------
# The segment-summary kernels and the sequence-parallel path on a seq mesh
# of the one card.
# ---------------------------------------------------------------------------

from repro_torch.kernels.wkv.vjp import WKVSummaryFunction  # noqa: E402
from repro_torch.launch.mesh import make_seq_mesh  # noqa: E402
from repro_torch.model.sharding import make_rules, sharding_context  # noqa: E402
from repro_torch.serve.engine import make_seq_prefill_step  # noqa: E402
from repro_torch.train.step import make_loss_fn  # noqa: E402
from repro_torch.tree import tree_unflatten  # noqa: E402


def _window_inputs(b, t, full_t, start, seed, device, dtype):
    """r/k/v/w as the T-window start..start+t of (b, 4, full_t, 64)
    tensors, as a shard reads them; u and h0 whole."""
    a = _inputs(b, 4, full_t, seed, device, dtype)
    return [x[:, :, start:start + t] for x in a[:4]] + a[4:]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CC.SUMMARY_CASES, ids=lambda c: "B{}-T{}-at{}-of{}".format(
    c[0], c[1], c[4], c[3]))
def test_summary_kernels_match_plain(cuda, dtype, case):
    b, t, chunk, full_t, start = case
    a = _window_inputs(b, t, full_t, start, t + start, cuda, dtype)
    flat = [x.contiguous() for x in a]
    tol = F32_TOL if dtype == torch.float32 else BF16_RTOL
    got = K.wkv_summary_cuda(*a, chunk=chunk)
    want = K.wkv_summary_plain(*a, chunk=chunk)
    _close_scaled(got[:2], want[:2], tol)
    assert CC.a_seg_ratio(got[2], want[2]) <= 1.0
    # Reading the window in place changes nothing: the contiguous launch's bits.
    assert all(torch.equal(x, y) for x, y in zip(got[:2], K.wkv_cuda(*flat, chunk=chunk)))
    tgot = K.wkv_train_summary_cuda(*a, chunk=chunk)
    _close_scaled(tgot[:3], K.wkv_train_summary_plain(*a, chunk=chunk)[:3], tol)
    assert all(torch.equal(x, y) for x, y in zip(tgot[:3], K.wkv_train_cuda(*flat, chunk=chunk)))
    assert torch.equal(tgot[3], got[2])
    # The backward kernel on the same windows (the seq gradient's shard).
    d_out, d_s = _cotangents(b, 4, t, start, cuda, dtype)
    bargs = (*a[:5], tgot[2], d_out, d_s)
    gb = BW.wkv_bwd_cuda(*bargs, chunk=chunk)
    _close_scaled(gb, BW.wkv_bwd_plain(*bargs, chunk=chunk), 1e-4 if dtype == torch.float32
                  else BF16_RTOL)
    flat_b = BW.wkv_bwd_cuda(*flat[:5], tgot[2], d_out, d_s, chunk=chunk)
    assert all(torch.equal(x, y) for x, y in zip(gb, flat_b))


def test_summary_a_seg_underflows_as_the_plain_version(cuda):
    # 1024 tokens of the model's fastest decays: a_seg is 0 or denormal on
    # both sides (the kernel keeps denormals).
    b, t = 1, 1024
    a = _inputs(b, 4, t, 9, cuda)
    a[3] = torch.full_like(a[3], float(np.exp(-0.09)))   # a_seg = e^-92.2, denormal
    got = K.wkv_summary_cuda(*a, chunk=16)[2]
    want = K.wkv_summary_plain(*a, chunk=16)[2]
    assert CC.a_seg_ratio(got, want) <= 1.0
    assert float(want.max()) < 2.0 ** -126 and float(got.max()) > 0.0


def test_summary_wrappers_refuse_bad_layouts(cuda):
    r, k, v, w, u, h0 = _inputs(2, 4, 64, 0, cuda)
    with pytest.raises(ValueError, match="grad"):
        K.wkv_summary_cuda(r.clone().requires_grad_(True), k, v, w, u, h0, chunk=16)
    with pytest.raises(ValueError, match="T-windows"):
        K.wkv_summary_cuda(r[:, :, :32], k[:, :, 32:], v[:, :, :32].contiguous(),
                           w[:, :, :32], u, h0, chunk=16)
    with pytest.raises(ValueError, match="T-windows"):
        K.wkv_train_summary_cuda(*(x.transpose(0, 1)[:, :, :32] for x in (r, k, v, w)),
                                 u[:2], h0.transpose(0, 1)[:, :, :, :].contiguous(), chunk=16)
    with pytest.raises(ValueError, match="contiguous"):
        K.wkv_cuda(r[:, :, :32], k[:, :, :32], v[:, :, :32], w[:, :, :32], u, h0, chunk=16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [False, True], ids=["whole", "window"])
def test_summary_function_grads_card_match_cpu(cuda, dtype, window):
    # window: r/k/v/w are tokens 64..128 of 192-token leaves, as a shard of
    # the seq path hands them over (saved and read in place on the card).
    base = _inputs(2, 4, 192 if window else 64, 4, "cpu", dtype)
    d_out, d_s = _cotangents(2, 4, 64, 4, "cpu", dtype)
    d_a = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 4, 64)).astype(np.float32))
    grads = {}
    for dev in ("cpu", cuda):
        leaves = [x.to(dev).requires_grad_(True) for x in base]
        args = [x[:, :, 64:128] if window and i < 4 else x for i, x in enumerate(leaves)]
        out, s, a = WKVSummaryFunction.apply(*args, 16)
        loss = ((out.float() * d_out.to(dev).float()).sum() + (s * d_s.to(dev)).sum()
                + (a * d_a.to(dev)).sum() * 1e3)
        grads[str(dev)] = torch.autograd.grad(loss, leaves)
    tol = 1e-4 if dtype == torch.float32 else BF16_RTOL
    _close_scaled(grads["cuda"], grads["cpu"], tol)


def test_reduced_seq_path_card_matches_cpu(cuda):
    """The reduced f32 model on a seq mesh of 4 shards: the seq prefill
    through the summary kernels (one launch per layer and shard, none of
    the single sweep) and the seq gradient through the training summary and
    the backward kernels, against the same mesh of CPU shards, within the
    CPU tests' tolerances (2e-3; 3e-3 of each leaf's largest value)."""
    cfg = get_config("rwkv6-1.6b").reduced()
    p_cpu = M.init_params(cfg, seed=2, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 257)))
    out = {}
    for dev, mesh in (("cpu", make_seq_mesh(4, device="cpu")), ("cuda", make_seq_mesh(4))):
        params = tree_map(lambda p: p.detach().to(dev, copy=True), p_cpu)
        K.wkv_summary_cuda.launches = K.wkv_cuda.launches = 0
        with torch.inference_mode():
            logits = make_seq_prefill_step(cfg, mesh, min_len=64)(params, toks[:, :256].to(dev))
        counts = (K.wkv_summary_cuda.launches, K.wkv_cuda.launches)
        leaves = [p.requires_grad_(True) for p in tree_leaves(params)]
        b = toks.to(dev)
        with sharding_context(mesh, make_rules(mesh, "prefill_seq")):
            loss = make_loss_fn(cfg)(tree_unflatten(params, leaves),
                                     {"tokens": b[:, :-1], "labels": b[:, 1:]})
            grads = torch.autograd.grad(loss, leaves)
        out[dev] = (logits.cpu(), counts, [g.cpu() for g in grads])
    assert out["cuda"][1] == (cfg.num_layers * 4, 0) and out["cpu"][1] == (0, 0)
    _close([out["cuda"][0]], [out["cpu"][0]], 2e-3)
    _close_scaled(out["cuda"][2], out["cpu"][2], 3e-3)


# ---------------------------------------------------------------------------
# The redesigned WKV kernels (TMA rings, prep and carry roles, clusters):
# the edges of the design and every plan, against the plain versions, and
# planted faults the checks must reject.
# ---------------------------------------------------------------------------

#: (B, H, T, chunk): a sweep shorter than the two-stage ring (T = chunk), a
#: prime T (chunk 1: 257 chunks of one token), the largest chunks (64 for
#: the forward, 32 for the backward), and B*H = 3, not a multiple of the
#: backward's clusters of 2 and 4.
WKV_EDGES = ((2, 4, 16, 16), (1, 2, 257, 1), (1, 2, 64, 64), (1, 3, 64, 32), (1, 3, 48, 16))


def _fwd_tiles(chunk, dtype):
    item = torch.empty((), dtype=dtype).element_size()
    return [c for c in K.COL_TILES if K.fwd_smem_bytes(chunk, c, item) <= K.SMEM_LIMIT]


def _bwd_clusters(chunk, dtype):
    item = torch.empty((), dtype=dtype).element_size()
    return [c for c in BW.CLUSTERS if BW.bwd_smem_bytes(chunk, c, item) <= K.SMEM_LIMIT]


def _scaled_ratio(got, want, tol):
    """Worst |got - want| / (tol max(1, max|want|) + tol |want|) over the
    outputs: ``_close_scaled``'s check, which passes at <= 1 (inf where an
    output is not finite)."""
    worst = 0.0
    for g, w in zip(got, want):
        g, w = g.float().cpu(), w.float().cpu()
        if not bool(torch.isfinite(g).all()):
            return float("inf")
        lim = tol * max(1.0, float(w.abs().max())) + tol * w.abs()
        worst = max(worst, float(((g - w).abs() / lim).max()))
    return worst


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", WKV_EDGES, ids=lambda c: "B{}-H{}-T{}-L{}".format(*c))
def test_wkv_edges_match_plain_in_every_plan(cuda, dtype, case):
    b, h, t, chunk = case
    args = _inputs(b, h, t, t + 7, cuda, dtype)
    tol = F32_TOL if dtype == torch.float32 else BF16_RTOL
    want = K.wkv_train_plain(*args, chunk=chunk)
    ref = None
    for tile in _fwd_tiles(chunk, dtype):
        got = K.launch_plan(*args, chunk=chunk, col_tile=tile, hist=True)
        _close_scaled(got, want, tol)
        # Column j sums in one order whatever the tile: bit-equal plans.
        assert ref is None or all(torch.equal(x, y) for x, y in zip(got, ref)), tile
        ref = got
    assert ref is not None
    assert all(torch.equal(x, y) for x, y in zip(K.wkv_train_cuda(*args, chunk=chunk), ref))
    if chunk > BW.BWD_MAX_CHUNK:
        return
    d_out, d_s = _cotangents(b, h, t, t, cuda, dtype)
    bargs = (*args[:5], ref[2], d_out, d_s)
    want = BW.wkv_bwd_plain(*bargs, chunk=chunk)
    btol = 1e-4 if dtype == torch.float32 else BF16_RTOL
    for cluster in _bwd_clusters(chunk, dtype):
        got = BW.launch_plan(*bargs, chunk=chunk, cluster=cluster)
        _close_scaled(got, want, btol)
        again = BW.launch_plan(*bargs, chunk=chunk, cluster=cluster)
        assert all(torch.equal(x, y) for x, y in zip(got, again)), cluster


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_every_plan_agrees_at_a_window_shape(cuda, dtype):
    """Every column tile of the four forward entries on a T-window read in
    place (tokens 64..192 of 256), bit-equal to each other and to the
    contiguous launch; every cluster size of the backward on the same
    window, each within tolerance of the plain version."""
    a = _window_inputs(2, 128, 256, 64, 5, cuda, dtype)
    flat = [x.contiguous() for x in a]
    tol = F32_TOL if dtype == torch.float32 else BF16_RTOL
    want = K.wkv_train_summary_plain(*a, chunk=16)
    ref = None
    for tile in _fwd_tiles(16, dtype):
        got = K.launch_plan(*a, chunk=16, col_tile=tile, hist=True, summary=True)
        _close_scaled(got[:3], want[:3], tol)
        assert CC.a_seg_ratio(got[3], want[3]) <= 1.0
        flat_got = K.launch_plan(*flat, chunk=16, col_tile=tile, hist=True)
        assert all(torch.equal(x, y) for x, y in zip(got[:3], flat_got))
        inf = K.launch_plan(*a, chunk=16, col_tile=tile, summary=True)
        assert torch.equal(inf[0], got[0]) and torch.equal(inf[1], got[1])
        assert ref is None or all(torch.equal(x, y) for x, y in zip(got, ref)), tile
        ref = got
    d_out, d_s = _cotangents(2, 4, 128, 5, cuda, dtype)
    bargs = (*a[:5], ref[2], d_out, d_s)
    want = BW.wkv_bwd_plain(*bargs, chunk=16)
    for cluster in _bwd_clusters(16, dtype):
        got = BW.launch_plan(*bargs, chunk=16, cluster=cluster)
        _close_scaled(got, want, 1e-4 if dtype == torch.float32 else BF16_RTOL)
        flat_got = BW.launch_plan(*flat[:5], ref[2], d_out, d_s, chunk=16, cluster=cluster)
        assert all(torch.equal(x, y) for x, y in zip(got, flat_got)), cluster


def test_shared_memory_formulas_match_the_sources(cuda):
    """The plans' shared-memory sizes (pure Python) equal the sources'
    layouts, which return 0 past the card's limit."""
    from repro_torch.kernels import common

    fwd, bwd = common.load_library("wkv_chunked"), common.load_library("wkv_bwd")
    for chunk in (1, 4, 10, 16, 31, 32, 64):
        for code, item in ((0, 4), (1, 2)):
            for tile in K.COL_TILES:
                py = K.fwd_smem_bytes(chunk, tile, item)
                assert fwd.wkv_chunked_smem(chunk, tile, code) == (py if py <= K.SMEM_LIMIT else 0)
            if chunk <= BW.BWD_MAX_CHUNK:
                for cluster in BW.CLUSTERS:
                    py = BW.bwd_smem_bytes(chunk, cluster, item)
                    assert bwd.wkv_bwd_smem(chunk, cluster, code) == (
                        py if py <= K.SMEM_LIMIT else 0)


#: Faults planted in copies of the two WKV sources: (anchor, replacement).
_FWD_WAIT = "      sm90::mbar_wait(&full[c % NS], (c / NS) & 1);\n"
_BWD_WAIT = "    sm90::mbar_wait(&full[m % NS], (m / NS) & 1);\n"
WKV_FWD_FAULTS = {
    # The prep role reads its ring stage without waiting for the TMA loads.
    "skip_ring_wait": (_FWD_WAIT, ""),
    # Every wait on the ring's full barriers takes the other phase.
    "flipped_ring_phase": (_FWD_WAIT, "      sm90::mbar_wait(&full[c % NS], ((c / NS) & 1) ^ 1);\n"),
    # s_hist[c - 1] receives the state entering chunk c: one chunk late.
    "s_hist_one_chunk_late": (
        "        sm90::tma_store_3d(&map_hist, Sc, j0, 0, bh * n + c);\n",
        "        if (c > 0) sm90::tma_store_3d(&map_hist, Sc, j0, 0, bh * n + c - 1);\n"),
}
WKV_BWD_FAULTS = {
    "skip_ring_wait": (_BWD_WAIT, ""),
    "flipped_ring_phase": (_BWD_WAIT, "    sm90::mbar_wait(&full[m % NS], ((m / NS) & 1) ^ 1);\n"),
    # The last cluster rank's partials of do S^T and V G^T left out of the
    # sums (the check runs at a cluster of 2).
    "cluster_rank_dropped": (
        "            x4[a][p] = p < C ? sm90::ld_cluster_f32x4(peer[p] + o) : make_float4(0.f, 0.f, 0.f, 0.f);\n",
        "            x4[a][p] = (p < C - 1 || C == 1) ? sm90::ld_cluster_f32x4(peer[p] + o) : make_float4(0.f, 0.f, 0.f, 0.f);\n"),
}


#: One faulty launch and its check, in a process of its own: a wait that
#: passes before its stage is loaded can leave a block exiting, or re-arming
#: the stage, with a TMA load in flight, which the card reports as a launch
#: failure that poisons the process's CUDA context.  Either outcome rejects
#: the fault: the wrapper raises, or the numbers miss the plain version.
_FAULT_CHECK = r"""
import json, sys
import numpy as np
import torch
from repro_torch.kernels import common
from repro_torch.kernels.elevator_scan import decode as ED
from repro_torch.kernels.elevator_scan import kernel as EK
from repro_torch.kernels.token_shift import kernel as TS
from repro_torch.kernels.wkv import bwd as BW
from repro_torch.kernels.wkv import decode as D
from repro_torch.kernels.wkv import kernel as K

lib, so, dt, tol = sys.argv[1], sys.argv[2], getattr(torch, sys.argv[3]), float(sys.argv[4])
case = sys.argv[5] if len(sys.argv) > 5 else lib
rng = np.random.default_rng(777)


def rand(*shape):
    return rng.standard_normal(shape).astype(np.float32)


def wkv_inputs(b, h, t):
    w = rng.uniform(0.85, 0.999, (b, h, t, 64)).astype(np.float32)
    io = [rand(b, h, t, 64), rand(b, h, t, 64), rand(b, h, t, 64), w, rand(h, 64)]
    return ([torch.from_numpy(x).cuda().to(dt) for x in io]
            + [torch.from_numpy(rand(b, h, 64, 64)).cuda()])


def cold():
    # Inputs cold in the 50 MB L2, as the main path finds them: a load
    # read before its wait then finds its stage not yet written.
    torch.empty(64 << 20, device="cuda").fill_(1.0)
    torch.cuda.synchronize()


common.load_library(lib)
if lib == "wkv_chunked":
    args = wkv_inputs(1, 4, 256)
    want = K.wkv_train_plain(*args, chunk=16)
    common._LIBS[lib] = common.open_library(lib, so)
    cold()
    got = K.wkv_train_cuda(*args, chunk=16)
elif lib == "wkv_bwd":
    args = wkv_inputs(1, 4, 256)
    d_out = torch.from_numpy(rand(1, 4, 256, 64)).cuda().to(dt)
    d_s = torch.from_numpy(rand(1, 4, 64, 64)).cuda()
    s_hist = K.wkv_train_cuda(*args, chunk=16)[2]
    bargs = (*args[:5], s_hist, d_out, d_s)
    want = BW.wkv_bwd_plain(*bargs, chunk=16)
    common._LIBS[lib] = common.open_library(lib, so)
    cold()
    got = BW.launch_plan(*bargs, chunk=16, cluster=2)
elif lib == "wkv_decode":
    # The window at the main path's B=4, 32 heads, K=32.
    args = wkv_inputs(4, 32, 32)
    want = D.wkv_decode_plain(*args)
    common._LIBS[lib] = common.open_library(lib, so)
    cold()
    got = D.wkv_decode_window_cuda(*args)
elif case == "elevator_scan":
    # The scan at B=1, T=1024, D=2560 (16 chunks through the ring).
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (1, 1024, 2560)).astype(np.float32)).cuda().to(dt)
    x = torch.from_numpy(rand(1, 1024, 2560)).cuda().to(dt)
    h = torch.from_numpy(rand(1, 2560)).cuda()
    want = [EK.elevator_scan_ref(a, x, h)]
    common._LIBS[lib] = common.open_library(lib, so)
    cold()
    got = [EK.elevator_scan_cuda(a, x, h)]
elif case == "elevator_window":
    # The staged window at B=4, K=8, D=2560; the memory the outputs will
    # take is filled with NaN first.
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (4, 8, 2560)).astype(np.float32)).cuda().to(dt)
    x = torch.from_numpy(rand(4, 8, 2560)).cuda().to(dt)
    h = torch.from_numpy(rand(4, 2560)).cuda()
    want = list(ED.elevator_decode_window_plain(a, x, h))
    common._LIBS[lib] = common.open_library(lib, so)
    torch.full_like(x, float("nan"))
    torch.full_like(h, float("nan"))
    got = list(ED.elevator_decode_window_cuda(a, x, h))
elif case == "flash_bwd":
    # Flash attention's backward at Gemma3's heads (4 over 1 of 256), T=512,
    # causal window 128 (the tiles the band cuts and those it covers).
    from repro_torch.kernels.local_attention import kernel as FA
    q = torch.from_numpy(rand(1, 4, 512, 256)).cuda().to(dt)
    k, v = (torch.from_numpy(rand(1, 1, 512, 256)).cuda().to(dt) for _ in range(2))
    do = torch.from_numpy(rand(1, 4, 512, 256)).cuda().to(dt)
    o, lse = FA.flash_attention_cuda(q, k, v, causal=True, window=128, lse=True)
    want = list(FA.attention_bwd_ref(q, k, v, o, lse, do, causal=True, window=128))
    common._LIBS[lib] = common.open_library(lib, so)
    got = list(FA.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=True, window=128))
elif case == "flash_bwd_ring":
    # At Gemma3's heads, causal, T=2048: 32 key tiles a KV head, each block
    # walking up to 32 query tiles through its two-stage ring; cold inputs.
    from repro_torch.kernels.local_attention import kernel as FA
    q = torch.from_numpy(rand(1, 4, 2048, 256)).cuda().to(dt)
    k, v = (torch.from_numpy(rand(1, 1, 2048, 256)).cuda().to(dt) for _ in range(2))
    do = torch.from_numpy(rand(1, 4, 2048, 256)).cuda().to(dt)
    o, lse = FA.flash_attention_cuda(q, k, v, causal=True, lse=True)
    want = list(FA.attention_bwd_ref(q, k, v, o, lse, do, causal=True))
    common._LIBS[lib] = common.open_library(lib, so)
    cold()
    got = list(FA.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=True))
elif case == "elevator_bwd_ring":
    # The scan's backward at B=1, T=4096, D=2560 (32 chunks through a ring
    # of 4 at each of 160 blocks), cold inputs, held bit for bit.
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (1, 4096, 2560)).astype(np.float32)).cuda()
    h = torch.from_numpy(rand(1, 4096, 2560)).cuda()
    dh = torch.from_numpy(rand(1, 4096, 2560)).cuda()
    h0 = torch.from_numpy(rand(1, 2560)).cuda()
    want = list(EK.elevator_scan_bwd_ref(a, h, dh, h0))
    common._LIBS[lib] = common.open_library(lib, so)
    cold()
    got = list(EK.elevator_scan_bwd_cuda(a, h, dh, h0))
elif case == "elevator_bwd":
    # The scan's backward at B=2, T=300, D=2560, held bit for bit.
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, 300, 2560)).astype(np.float32)).cuda().to(dt)
    h = torch.from_numpy(rand(2, 300, 2560)).cuda()
    dh = torch.from_numpy(rand(2, 300, 2560)).cuda().to(dt)
    h0 = torch.from_numpy(rand(2, 2560)).cuda()
    want = list(EK.elevator_scan_bwd_ref(a, h, dh, h0))
    common._LIBS[lib] = common.open_library(lib, so)
    got = list(EK.elevator_scan_bwd_cuda(a, h, dh, h0))
elif case == "shift_bwd":
    # The token shift's backward at B=2, T=300 (three row tiles a batch row).
    x = torch.from_numpy(rand(2, 300, 2560)).cuda().to(dt)
    w = torch.from_numpy(rand(4, 2560)).cuda().to(dt)
    do = torch.from_numpy(rand(2, 300, 2560)).cuda().to(dt)
    want = list(TS.token_shift_bwd_ref(x, w, do))
    common._LIBS[lib] = common.open_library(lib, so)
    got = list(TS.token_shift_bwd_cuda(x, w, do))
else:
    # The token shift at B=2, T=259, a D with a tail slot in either dtype;
    # the memory the output will take is filled with NaN first, so a channel
    # left unwritten cannot hold a right value from an earlier launch.
    x = torch.from_numpy(rand(2, 259, 2562)).cuda().to(dt)
    w = torch.from_numpy(rand(4, 2562)).cuda().to(dt)
    want = [TS.token_shift_ref(x, w)]
    common._LIBS[lib] = common.open_library(lib, so)
    torch.full_like(x, float("nan"))
    got = [TS.token_shift_cuda(x, w)]
torch.cuda.synchronize()
worst = 0.0
for g, x in zip(got, want):
    g, x = g.float().cpu(), x.float().cpu()
    if not bool(torch.isfinite(g).all()):
        worst = float("inf")
        break
    if tol == 0.0:
        worst = max(worst, 0.0 if torch.equal(g, x) else float("inf"))
        continue
    lim = tol * max(1.0, float(x.abs().max())) + tol * x.abs()
    worst = max(worst, float(((g - x).abs() / lim).max()))
print(json.dumps({"ratio": worst}))
"""


def _fault_outcome(lib, so, dtype, tol, case=None):
    """Run one faulty launch and its check in a fresh process (``case``
    names the launch where a library has more than one); returns a string
    for the record and whether the check rejected the fault."""
    import json
    import os
    import subprocess
    import sys

    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(Path(__file__).resolve().parents[1] / "src"), os.environ.get("PYTHONPATH", "")])}
    proc = subprocess.run([sys.executable, "-c", _FAULT_CHECK, lib, str(so),
                           str(dtype).split(".")[-1], str(tol), case or lib],
                          capture_output=True, text=True, timeout=600, env=env)
    if proc.returncode != 0:
        lines = ([ln for ln in proc.stderr.splitlines() if "CUDA error" in ln]
                 or proc.stderr.strip().splitlines() or ["?"])
        return f"launch failed: {lines[0].strip()[:160]}", True
    ratio = json.loads(proc.stdout.strip().splitlines()[-1])["ratio"]
    return f"ratio {ratio:.3e}", not ratio <= 1.0


@pytest.fixture(scope="module")
def wkv_mutants(tmp_path_factory):
    """Each planted fault compiled into its own copy of its library; the
    value is the shared object's path (loaded only by the check's own
    process)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels are CUDA C++ for sm_90a")
    out = tmp_path_factory.mktemp("wkv_mutants")
    _compile_mutants("wkv_chunked", WKV_FWD_FAULTS, out / "fwd")
    _compile_mutants("wkv_bwd", WKV_BWD_FAULTS, out / "bwd")
    return {("wkv_chunked", f): out / "fwd" / f"{f}.so" for f in WKV_FWD_FAULTS} | {
        ("wkv_bwd", f): out / "bwd" / f"{f}.so" for f in WKV_BWD_FAULTS}


@pytest.mark.parametrize("lib,fault", [("wkv_chunked", f) for f in WKV_FWD_FAULTS]
                         + [("wkv_bwd", f) for f in WKV_BWD_FAULTS])
def test_wkv_check_rejects_planted_fault(cuda, wkv_mutants, lib, fault):
    """The forward at B=1, H=4, T=256 (16 chunks) on the training entry;
    the backward at a cluster of 2; both dtypes; the good kernel passes the
    same check in this process."""
    for dtype in (torch.float32, torch.bfloat16):
        tol = (F32_TOL if lib == "wkv_chunked" else 1e-4) if dtype == torch.float32 else BF16_RTOL
        what, rejected = _fault_outcome(lib, wkv_mutants[(lib, fault)], dtype, tol)
        print(f"[wkv-fault] {lib} {fault} {dtype}: {what}")
        assert rejected, f"{lib} {fault} {dtype}: the check passed the faulty kernel ({what})"
    args = _inputs(1, 4, 256, 777, cuda, torch.float32)
    assert _scaled_ratio(K.wkv_train_cuda(*args, chunk=16),
                         K.wkv_train_plain(*args, chunk=16), F32_TOL) <= 1.0


#: Faults planted in copies of the two decode-step sources: (anchor,
#: replacement).  The decode window's threads read the staged slabs
#: without waiting for the bulk copies; the token shift leaves the last
#: channel of a row's tail slot unwritten.
DECODE_FAULTS = {
    ("wkv_decode", "skip_staging_wait"): ("  sm90::mbar_wait(bar, 0);\n", ""),
    ("token_shift", "dropped_tail_channel"): (
        "    if (c < left) Slot<T>::put(p + c, acc[c]);\n",
        "    if (c < left - 1) Slot<T>::put(p + c, acc[c]);\n"),
}


@pytest.fixture(scope="module")
def decode_mutants(tmp_path_factory):
    """Each planted fault compiled into its own copy of its library; the
    value is the shared object's path (loaded only by the check's own
    process)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels are CUDA C++ for sm_90a")
    out = tmp_path_factory.mktemp("decode_mutants")
    for (lib, fault), edit in DECODE_FAULTS.items():
        _compile_mutants(lib, {fault: edit}, out / lib)
    return {(lib, fault): out / lib / f"{fault}.so" for lib, fault in DECODE_FAULTS}


@pytest.mark.parametrize("lib,fault", list(DECODE_FAULTS))
def test_decode_step_check_rejects_planted_fault(cuda, decode_mutants, lib, fault):
    """The decode window at B=4, K=32 held to the tolerance of the chained
    test; the token shift (B=2, T=259, D=2562) held bit for bit; both dtypes,
    each faulty launch in a process of its own.  The good kernels pass the
    same checks in this process."""
    for dtype in (torch.float32, torch.bfloat16):
        tol = 0.0 if lib == "token_shift" else (
            F32_TOL if dtype == torch.float32 else BF16_RTOL)
        what, rejected = _fault_outcome(lib, decode_mutants[(lib, fault)], dtype, tol)
        print(f"[decode-fault] {lib} {fault} {dtype}: {what}")
        assert rejected, f"{lib} {fault} {dtype}: the check passed the faulty kernel ({what})"
    args = _inputs(4, 32, 32, 777, cuda, torch.float32)
    assert _scaled_ratio(D.wkv_decode_window_cuda(*args), D.wkv_decode_plain(*args),
                         F32_TOL) <= 1.0
    x = torch.randn((2, 259, 2562), device=cuda)
    w = torch.randn((4, 2562), device=cuda)
    assert torch.equal(TS_K.token_shift_cuda(x, w), TS_K.token_shift_ref(x, w))


#: Faults planted in copies of ``elevator_scan.cu``: (check case, anchor,
#: replacement).  The scan's chain warp reads its ring stage without waiting
#: for the TMA tiles; the staged window leaves the last channel of the row
#: unwritten.
ELEVATOR_FAULTS = {
    "skip_ring_wait": ("elevator_scan", "    sm90::mbar_wait(&full[s], (c / ns) & 1);\n", ""),
    "dropped_tail_channel": ("elevator_window", "  const bool live = d < D;\n",
                             "  const bool live = d < D - 1;\n"),
}


@pytest.fixture(scope="module")
def elevator_mutants(tmp_path_factory):
    """Each planted fault compiled into its own copy of the library; the
    value is the shared object's path (loaded only by the check's own
    process)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels are CUDA C++ for sm_90a")
    out = tmp_path_factory.mktemp("elevator_mutants")
    _compile_mutants("elevator_scan", {f: e[1:] for f, e in ELEVATOR_FAULTS.items()}, out)
    return {f: out / f"{f}.so" for f in ELEVATOR_FAULTS}


@pytest.mark.parametrize("fault", list(ELEVATOR_FAULTS))
def test_elevator_check_rejects_planted_fault(cuda, elevator_mutants, fault):
    """The scan at B=1, T=1024 on inputs cold in L2, and the staged window
    at B=4, K=8 with its output memory poisoned with NaN, both held bit for
    bit to their plain versions in both dtypes, each faulty launch in a
    process of its own.  The good kernels pass the same checks here."""
    case = ELEVATOR_FAULTS[fault][0]
    for dtype in (torch.float32, torch.bfloat16):
        what, rejected = _fault_outcome("elevator_scan", elevator_mutants[fault], dtype, 0.0,
                                        case)
        print(f"[elevator-fault] {fault} {dtype}: {what}")
        assert rejected, f"{fault} {dtype}: the check passed the faulty kernel ({what})"
    a, x, h = _scan_inputs(1, 1024, 2560, 777, cuda)
    assert torch.equal(EK.elevator_scan_cuda(a, x, h), EK.elevator_scan_ref(a, x, h))
    a, x, h = _scan_inputs(4, 8, 2560, 778, cuda)
    got, want = ED.elevator_decode_window_cuda(a, x, h), ED.elevator_decode_window_plain(a, x, h)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# --------------------------------------------------------------------------
# The backward kernels (training): flash attention, the RG-LRU scan, the
# token shift; the WKV decode window under grad; the Functions card vs CPU
# --------------------------------------------------------------------------

#: Backward tolerance relative to each output's largest value: f32 the same
#: math in another order; bf16 P and dS are rounded to bf16 as the mma
#: operands besides the outputs (chip_smoke.py's GRAD_TOLERANCE).
GRAD_RTOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _grad_close(got, want, dtype):
    for g, w in zip(got, want):
        err = float((g.float() - w.float()).abs().max())
        assert err <= GRAD_RTOL[dtype] * max(1e-2, float(w.float().abs().max())), err
        assert bool(torch.isfinite(g).all())


#: (b, hq, hkv, t, s, d, causal, window): every mask variant, GQA, T != S,
#: T off a tile, each head width.
FLASH_BWD_CASES = [
    (1, 4, 1, 512, 512, 256, True, 128),
    (2, 4, 1, 300, 300, 256, True, None),
    (1, 14, 2, 333, 333, 64, True, None),
    (1, 8, 2, 256, 256, 128, True, 100),
    (1, 4, 4, 200, 200, 32, False, 50),
    (2, 4, 4, 64, 320, 64, False, None),
    (1, 4, 2, 320, 64, 128, False, None),
    (1, 4, 1, 8, 300, 256, True, None),
    # RecurrentGemma's training attention: a group of 10 over one KV head
    # (a cluster of 5, two heads a block).
    (1, 10, 1, 1024, 1024, 256, True, 2048),
    # qwen2's group of 7 (a cluster of 7) at one KV head.
    (1, 7, 1, 512, 512, 128, True, None),
    # T a multiple of no tile (32, 64, 128).
    (2, 4, 2, 1001, 1001, 64, True, 300),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_BWD_CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_bwd_matches_plain(cuda, dtype, case):
    b, hq, hkv, t, s, d, causal, window = case
    q, k, v = _qkv(b, hq, hkv, t, s, d, t + s, cuda, dtype)
    do = _qkv(b, hq, hq, t, t, d, 1, cuda, dtype)[0]
    mask = dict(causal=causal, window=window)
    o, lse = FA.flash_attention_cuda(q, k, v, lse=True, **mask)
    assert torch.equal(o, FA.flash_attention_cuda(q, k, v, **mask))
    _, lse_ref = FA.attention_ref_lse(q, k, v, **mask)
    seen = torch.isfinite(lse_ref)
    assert torch.equal(torch.isfinite(lse), seen)
    assert float((lse[seen] - lse_ref[seen]).abs().max()) <= 1e-4
    got = FA.flash_attention_bwd_cuda(q, k, v, o, lse, do, **mask)
    _grad_close(got, FA.attention_bwd_ref(q, k, v, o, lse, do, **mask), dtype)
    again = FA.flash_attention_bwd_cuda(q, k, v, o, lse, do, **mask)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.parametrize("case", FLASH_BWD_CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_bwd_every_plan_matches_plain(cuda, case):
    """Every plan of ``flash_bwd_plans`` (each cluster size that divides the
    group) within GRAD_RTOL of the plain version in bf16, each repeating
    bit for bit."""
    b, hq, hkv, t, s, d, causal, window = case
    q, k, v = _qkv(b, hq, hkv, t, s, d, t + s, cuda, torch.bfloat16)
    do = _qkv(b, hq, hq, t, t, d, 1, cuda, torch.bfloat16)[0]
    mask = dict(causal=causal, window=window)
    o, lse = FA.flash_attention_cuda(q, k, v, lse=True, **mask)
    want = FA.attention_bwd_ref(q, k, v, o, lse, do, **mask)
    plans = FA.flash_bwd_plans(b, hq, hkv, t, s, d)
    assert FA.plan_flash_bwd(b, hq, hkv, t, s, d, torch.cuda.get_device_properties(
        0).multi_processor_count) in plans
    before = FA.flash_attention_bwd_cuda.launches
    for plan in plans:
        got = FA.launch_bwd_plan(q, k, v, o, lse, do, plan=plan, **mask)
        _grad_close(got, want, torch.bfloat16)
        again = FA.launch_bwd_plan(q, k, v, o, lse, do, plan=plan, **mask)
        assert all(torch.equal(x, y) for x, y in zip(got, again)), plan
    assert FA.flash_attention_bwd_cuda.launches == before


def test_flash_bwd_smem_matches_the_mirror(cuda):
    """The source's shared-memory figure of each bf16 backward kernel equals
    the planner's Python mirror at every head width and ring depth."""
    from repro_torch.kernels import common

    lib = common.load_library("flash_attention_bwd")
    for d in FA.HEAD_DIMS:
        for kernel, code in (("dkdv", 0), ("dq", 1)):
            for stages in range(2, FA.BWD_MAX_STAGES + 1):
                assert lib.flash_bwd_smem(d, code, stages) == FA.bwd_smem_bytes(
                    d, kernel, stages), (d, kernel, stages)
    assert lib.flash_bwd_smem(96, 0, 2) == -1


def test_flash_f32_head_dim_96(cuda):
    """The train_lm example's width, forward and backward, in f32."""
    q, k, v = _qkv(1, 8, 2, 256, 256, 96, 3, cuda, torch.float32)
    do = _qkv(1, 8, 8, 256, 256, 96, 4, cuda, torch.float32)[0]
    o, lse = FA.flash_attention_cuda(q, k, v, lse=True)
    _close([o], [FA.attention_ref(q, k, v)], F32_TOL)
    got = FA.flash_attention_bwd_cuda(q, k, v, o, lse, do)
    _grad_close(got, FA.attention_bwd_ref(q, k, v, o, lse, do), torch.float32)
    with pytest.raises(ValueError, match="head dim"):
        FA.flash_attention_cuda(q.bfloat16(), k.bfloat16(), v.bfloat16())


@pytest.mark.parametrize("b,t,d,h0", [(4, 1024, 2560, True), (1, 37, 200, False),
                                      (2, 1, 2560, True), (1, 4096, 2560, True)])
def test_elevator_bwd_bit_for_bit(cuda, b, t, d, h0):
    a, x, h_init = _scan_inputs(b, t, d, t + d, cuda, torch.float32, h0)
    h = EK.elevator_scan_cuda(a, x, h_init)
    dh = _scan_inputs(b, t, d, 5, cuda)[1]
    got = EK.elevator_scan_bwd_cuda(a, h, dh, h_init)
    want = EK.elevator_scan_bwd_ref(a, h, dh, h_init)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert all(g.dtype == torch.float32 for g in got)


@pytest.mark.parametrize("b,t,d,off", [(4, 1024, 2560, 0), (1, 37, 200, 0), (1, 4096, 2560, 0),
                                       (2, 1024, 2560, 0), (2, 300, 2560, 1), (1, 130, 201, 0)])
def test_elevator_bwd_every_plan_bit_for_bit(cuda, b, t, d, off):
    """Every plan of ``scan_bwd_plans`` (the TMA ring's two channel tiles
    where the layout takes them, the loader-warp variant) bit for bit
    against the plain version; ``off`` starts the inputs one float into
    their storage, which only the loader warps take, as does a row of 201
    floats."""
    a, x, h_init = _scan_inputs(b, t, d, t + d + off, cuda)
    h = EK.elevator_scan_cuda(a, x, h_init)
    dh = _scan_inputs(b, t, d, 6, cuda)[1]

    def shifted(z):
        buf = torch.empty(z.numel() + off, device=cuda)
        buf[off:].copy_(z.reshape(-1))
        return buf[off:].view(z.shape)

    if off:
        a, h, dh = shifted(a), shifted(h), shifted(dh)
    align = EK.pointer_alignment(a, h, dh)
    plans = EK.scan_bwd_plans(b, t, d, align)
    chosen = EK.plan_scan_bwd(b, t, d, torch.cuda.get_device_properties(0).multi_processor_count,
                              align)
    assert chosen in plans
    assert (chosen.mode == "loaders") == (off > 0 or d % 4 > 0)
    want = EK.elevator_scan_bwd_ref(a, h, dh, h_init)
    for plan in plans:
        got = EK.launch_bwd_plan(a, h, dh, h_init, plan=plan)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), plan
    got = EK.elevator_scan_bwd_cuda(a, h, dh, h_init)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,d,taps", [(4, 4, 2560, 4), (4, 67, 2560, 4), (4, 259, 2560, 4),
                                        (1, 4096, 2560, 4), (2, 130, 2562, 3), (1, 9, 64, 8),
                                        (2, 1024, 2560, 4)])
def test_token_shift_bwd_matches_plain(cuda, dtype, b, t, d, taps):
    """The wrapper's plan and every plan of ``shift_bwd_plans``: dx bit for
    bit, dw within the gradient tolerance and repeating bit for bit."""
    rng = np.random.default_rng(t + d)
    x, dout = (torch.from_numpy(rng.standard_normal((b, t, d)).astype(np.float32)).to(cuda, dtype)
               for _ in range(2))
    w = torch.from_numpy((rng.standard_normal((taps, d)) * 0.1).astype(np.float32)).to(cuda, dtype)
    dx, dw = TS_K.token_shift_bwd_cuda(x, w, dout)
    want = TS_K.token_shift_bwd_ref(x, w, dout)
    assert torch.equal(dx, want[0])
    _grad_close([dw], want[1:], dtype)
    again = TS_K.token_shift_bwd_cuda(x, w, dout)
    assert torch.equal(again[1], dw)
    for plan in TS_K.shift_bwd_plans(b, t, d, taps, dtype):
        got = TS_K.launch_bwd_plan(x, w, dout, plan=plan)
        assert torch.equal(got[0], want[0]), plan
        _grad_close([got[1]], want[1:], dtype)
        assert torch.equal(TS_K.launch_bwd_plan(x, w, dout, plan=plan)[1], got[1]), plan


def test_token_shift_bwd_off_the_16_byte_grid(cuda):
    """Inputs that start 2 or 4 bytes into their storage take the scalar
    variant in every plan (the 16-byte copies are refused for them), bit for
    bit in dx as before; the shared-memory mirror equals the source's."""
    from repro_torch.kernels import common

    lib = common.load_library("token_shift")
    for dtype, off in ((torch.float32, 1), (torch.bfloat16, 1), (torch.bfloat16, 2)):
        b, t, d = 2, 67, 2560
        rng = np.random.default_rng(off)
        x, dout = (torch.from_numpy(rng.standard_normal(b * t * d + off).astype(np.float32))
                   .to(cuda, dtype)[off:].view(b, t, d) for _ in range(2))
        w = torch.from_numpy((rng.standard_normal((4, d)) * 0.1).astype(np.float32)).to(cuda, dtype)
        want = TS_K.token_shift_bwd_ref(x, w, dout)
        plans = TS_K.shift_bwd_plans(b, t, d, 4, dtype, common.pointer_alignment(x, w, dout))
        assert not any(p.vec for p in plans)
        for plan in plans + [None]:
            got = (TS_K.token_shift_bwd_cuda(x, w, dout) if plan is None
                   else TS_K.launch_bwd_plan(x, w, dout, plan=plan))
            assert torch.equal(got[0], want[0]), plan
            _grad_close([got[1]], want[1:], dtype)
        with pytest.raises(RuntimeError, match="cudaError"):
            TS_K._launch_bwd(x, w, dout, dataclasses.replace(plans[0], vec=True))
    for plan in TS_K.shift_bwd_plans(1, 4096, 2560, 4, torch.bfloat16) + plans:
        for taps in range(2, TS_K.MAX_TAPS + 1):
            for dtype in (torch.float32, torch.bfloat16):
                assert lib.token_shift_bwd_smem(plan.groups, taps, plan.cols,
                                                common.DTYPE_CODE[dtype]) == \
                    TS_K.bwd_smem_bytes(plan, taps, dtype)


def _card_and_cpu_grads(fn, args, cots):
    grads = {}
    for dev in ("cuda", "cpu"):
        xs = [a.detach().to(dev).requires_grad_(True) for a in args]
        out = fn(*xs)
        outs = out if isinstance(out, tuple) else (out,)
        loss = sum((o.float() * c.to(dev).float()).sum() for o, c in zip(outs, cots))
        grads[dev] = [g.cpu() for g in torch.autograd.grad(loss, xs)]
    return grads["cuda"], grads["cpu"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_functions_card_match_cpu(cuda, dtype):
    """Each training Function on the card against the same Function on CPU
    copies (the plain versions): flash attention, the scan (chunked and a
    window), the token shift, the WKV decode window (K = 1 and 8)."""
    from repro_torch.kernels.elevator_scan.vjp import ElevatorScanFunction
    from repro_torch.kernels.local_attention.vjp import FlashAttentionFunction
    from repro_torch.kernels.token_shift.vjp import TokenShiftFunction
    from repro_torch.kernels.wkv import ops as WO

    q, k, v = _qkv(1, 4, 1, 256, 256, 256, 7, cuda, dtype)
    cot = _qkv(1, 4, 4, 256, 256, 256, 8, cuda, dtype)[0]
    _grad_close(*_card_and_cpu_grads(
        lambda *a: FlashAttentionFunction.apply(*a, True, 64, None), (q, k, v), (cot,)), dtype)
    # The scan's Function takes f32 only: the model scans f32 inputs.
    for t, decode in ((256, False), (8, True)) if dtype == torch.float32 else ():
        a, x, h0 = _scan_inputs(4, t, 2560, t, cuda, dtype)
        got, want = _card_and_cpu_grads(
            lambda *z, d=decode: ElevatorScanFunction.apply(*z, d), (a, x, h0), (x,))
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    x = _scan_inputs(2, 259, 2560, 9, cuda, dtype)[1]
    w = _scan_inputs(1, 4, 2560, 10, cuda, dtype)[1][0] * 0.1
    got, want = _card_and_cpu_grads(TokenShiftFunction.apply, (x, w), (x,))
    assert torch.equal(got[0], want[0])
    for kw in (1, 8):
        args = _inputs(2, 4, kw, kw, cuda, dtype)
        cots = (args[0], torch.ones((2, 4, 64, 64), device=cuda))
        got, want = _card_and_cpu_grads(lambda *z: WO.wkv_fused(*z, decode=True), args, cots)
        assert _scaled_ratio(got, want, 1e-4 if dtype == torch.float32 else BF16_RTOL) <= 1.0


@pytest.mark.parametrize("name", ["gemma3-1b", "recurrentgemma-2b"])
def test_reduced_attention_train_step_card_matches_cpu(cuda, name):
    """One train step of the reduced f32 model through the backward kernels
    against the same step on the CPU: loss, grad norm, each gradient leaf
    (AdamW's first moment), parameters."""
    cfg = get_config(name).reduced()
    params = TS.init_train_state(cfg, 1, device="cpu").params
    batch = make_batch(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                  global_batch=2 * cfg.microbatch, seed=2), 0, device="cpu")
    out = {}
    for dev in ("cpu", "cuda"):
        moved = tree_map(lambda p: p.detach().to(dev, copy=True).requires_grad_(True), params)
        state = TS.TrainState(moved, adamw.init_state(moved), None)
        state, m = TS.make_train_step(cfg)(state, {k: v.to(dev) for k, v in batch.items()})
        out[dev] = (float(m["loss"]), float(m["grad_norm"]),
                    [p.detach().cpu() for p in tree_leaves(state.params)],
                    tree_leaves(state.opt.mu))
    assert out["cuda"][0] == pytest.approx(out["cpu"][0], rel=1e-5)
    assert out["cuda"][1] == pytest.approx(out["cpu"][1], rel=1e-4)
    _first_moments_close(out["cuda"][3], out["cpu"][3])
    assert max(float((a - b).abs().max()) for a, b in zip(out["cuda"][2], out["cpu"][2])) <= 1e-5


def test_backward_wrappers_refuse_grad_and_bad_args(cuda):
    from repro_torch.kernels.elevator_scan.vjp import ElevatorScanFunction

    q, k, v = _qkv(1, 4, 1, 8, 8, 64, 0, cuda, torch.bfloat16)
    o, lse = FA.flash_attention_cuda(q, k, v, lse=True)
    with pytest.raises(ValueError, match="grad"):
        FA.flash_attention_bwd_cuda(q.clone().requires_grad_(True), k, v, o, lse, o)
    with pytest.raises(ValueError, match="lse"):
        FA.flash_attention_bwd_cuda(q, k, v, o, lse.bfloat16(), o)
    a, x, h = _scan_inputs(1, 4, 64, 0, cuda)
    with pytest.raises(ValueError, match="must be float32"):
        EK.elevator_scan_bwd_cuda(a, x.bfloat16(), x, h)
    with pytest.raises(ValueError, match="must be float32"):
        EK.elevator_scan_bwd_cuda(a.bfloat16(), x, x.bfloat16(), h)
    with pytest.raises(ValueError, match="float32 under grad"):
        ElevatorScanFunction.apply(a.bfloat16(), x.bfloat16(), h, False)
    with pytest.raises(ValueError, match="dout"):
        TS_K.token_shift_bwd_cuda(x, torch.ones(4, 64, device=cuda), x.bfloat16())


#: Faults planted in copies of the backward kernels' sources: (library,
#: check case, dtype the faulty kernel serves, edits: (anchor, replacement)
#: pairs applied in turn).
BWD_FAULTS = {
    # dK/dV blocks skip the last tile of queries their keys see.
    "flash_skip_last_query_tile": (
        "flash_attention_bwd", "flash_bwd", torch.bfloat16, ((
            "  const int n_qt = qhi > qlo ? (qhi - qt_first + BQ - 1) / BQ : 0;\n",
            "  const int n_qt = qhi > qlo ? (qhi - qt_first - 1) / BQ : 0;\n"),)),
    # No per-element mask in dK/dV: the band's cut tiles count every pair.
    "flash_unmasked_tiles": (
        "flash_attention_bwd", "flash_bwd", torch.bfloat16, ((
            "      const bool whole = mask.all_visible(q0, q0 + BQ, k0, k0 + BKV);\n",
            "      const bool whole = true;\n"),)),
    # dQ takes the upper row's delta for the lower 8 rows of each warp.
    "flash_dq_wrong_delta": (
        "flash_attention_bwd", "flash_bwd", torch.bfloat16, ((
            "      dl[h] = delta[(size_t)bh * Tp + row0 + 8 * h];\n",
            "      dl[h] = delta[(size_t)bh * Tp + row0];\n"),)),
    # The dK/dV consumers release a ring stage as soon as it has landed,
    # before their products read it: the producer refills it under them.
    "flash_ring_released_early": (
        "flash_attention_bwd", "flash_bwd_ring", torch.bfloat16, (
            ("      sm90::mbar_wait(&full[stage], phase);\n      // S^T = K Q^T",
             "      sm90::mbar_wait(&full[stage], phase);\n"
             "      if (lane == 0) sm90::mbar_arrive(&empty[stage]);\n      // S^T = K Q^T"),
            ("      sm90::fence_regs(dk_acc);\n      if (lane == 0) sm90::mbar_arrive(&empty[stage]);\n",
             "      sm90::fence_regs(dk_acc);\n"))),
    # The f32 dK leaves out the softmax scale.
    "flash_f32_dk_unscaled": (
        "flash_attention_bwd", "flash_bwd", torch.float32, ((
            "      dk[at] = ak[j][c] * scale;\n", "      dk[at] = ak[j][c];\n"),)),
    # The scan's backward loads each odd register group one row late.
    "scan_group_off_by_one": (
        "elevator_scan", "elevator_bwd", torch.float32, ((
            "        at = (r0 - GROUP) * LANES;\n", "        at = (r0 - GROUP + 1) * LANES;\n"),)),
    # The scan's chain warp releases a ring stage as soon as it has landed,
    # before it reads the stage's rows.
    "scan_ring_released_early": (
        "elevator_scan", "elevator_bwd_ring", torch.float32, (
            ("    sm90::mbar_wait(&full[s], (m / ns) & 1);\n",
             "    sm90::mbar_wait(&full[s], (m / ns) & 1);\n"
             "    if (lane == 0) sm90::mbar_arrive(&empty[s]);\n"),
            ("    __syncwarp();                               // the stage is read: release it\n"
             "    if (lane == 0) sm90::mbar_arrive(&empty[s]);\n", ""))),
    # The token shift's dw drops the first cluster rank's partial.
    "shift_dw_drops_a_partial": (
        "token_shift", "shift_bwd", torch.float32, ((
            "    float acc = sm90::ld_cluster_f32(sm90::mapa(at + 4 * e, 0));\n",
            "    float acc = 0.f;\n"),)),
    # The token shift carries x's rows into the next sub-tile's dout window.
    "shift_window_from_x": (
        "token_shift", "shift_bwd", torch.bfloat16, ((
            "    gw[k] = SUB + k < HALO ? gw[SUB + k] : at[2 * (SUB + k - HALO) * blockDim.x];\n",
            "    gw[k] = SUB + k < HALO ? gw[SUB + k] : at[(2 * (SUB + k - HALO) + 1) * blockDim.x];\n"),)),
}


@pytest.fixture(scope="module")
def bwd_mutants(tmp_path_factory):
    """Each planted fault compiled into its own copy of its library; the
    value is the shared object's path (loaded only by the check's process)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels are CUDA C++ for sm_90a")
    out = tmp_path_factory.mktemp("bwd_mutants")
    paths = {}
    for lib in {e[0] for e in BWD_FAULTS.values()}:
        faults = {f: e[3] for f, e in BWD_FAULTS.items() if e[0] == lib}
        _compile_mutants(lib, faults, out / lib)
        paths.update({f: out / lib / f"{f}.so" for f in faults})
    return paths


@pytest.mark.parametrize("fault", list(BWD_FAULTS))
def test_backward_check_rejects_planted_fault(cuda, bwd_mutants, fault):
    """Each faulty backward launch and its check (the plain version's
    tolerance of its dtype; the scan's bit for bit) in a process of its
    own.  The good kernels pass the same checks here."""
    lib, case, dtype = BWD_FAULTS[fault][:3]
    tol = (0.0 if case.startswith("elevator_bwd") else
           (1e-4 if dtype == torch.float32 else GRAD_RTOL[dtype]))
    what, rejected = _fault_outcome(lib, bwd_mutants[fault], dtype, tol, case)
    print(f"[bwd-fault] {fault} {dtype}: {what}")
    assert rejected, f"{fault} {dtype}: the check passed the faulty kernel ({what})"
    from repro_torch.kernels import common

    what, rejected = _fault_outcome(lib, common.build_libraries()[lib], dtype, tol, case)
    assert not rejected, f"the good {lib} fails the same check ({what})"


# ---------------------------------------------------------------------------
# Launch declarations: the C's own answers against the Python mirrors, every
# plan of the stencil, and the card's blocks an SM for every declared launch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", STENCIL_CASES, ids=lambda c: f"{c[0]}x{c[1]}-b{c[3]}")
def test_stencil2d_every_plan_bit_for_bit(cuda, dtype, case):
    """Every rows-a-thread tile gives the planner's output bit for bit, and
    the plain version's; ``launch_plan`` counts no launch."""
    h, w, coeffs, boundary = case
    rng = np.random.default_rng(h * 3 + w)
    x = torch.from_numpy(rng.standard_normal((h, w)).astype(np.float32)).to(cuda, dtype)
    c = torch.tensor(coeffs, device=cuda)
    planned = ST.stencil2d_cuda(x, c, boundary=boundary)
    n = ST.stencil2d_cuda.launches
    for rows in ST.ROW_TILES:
        assert torch.equal(ST.launch_plan(x, c, rows=rows, boundary=boundary), planned), rows
    assert ST.stencil2d_cuda.launches == n
    assert torch.equal(planned, ST.stencil2d_ref(x, c, boundary))


def test_flash_fwd_smem_matches_the_mirror(cuda):
    from repro_torch.kernels import common

    lib = common.load_library("flash_attention")
    for d in (32, 64, 128, 256):
        assert lib.flash_fwd_smem(d, 1) == FA.fwd_smem_bytes(d, torch.bfloat16), d
    for d in FA.F32_HEAD_DIMS:
        assert lib.flash_fwd_smem(d, 0) == FA.fwd_smem_bytes(d, torch.float32), d
    assert lib.flash_fwd_smem(96, 1) == -1 and lib.flash_fwd_smem(48, 0) == -1


def test_matmul_smem_matches_the_mirror(cuda):
    from repro_torch.kernels import common

    lib = common.load_library("matmul_fwd")
    for variant, (code, _, _, tiles) in MM.VARIANTS.items():
        for tm, tn in tiles:
            assert lib.matmul_smem(code, tm, tn) == MM.smem_bytes(variant, tm, tn), (variant, tm)
    assert lib.matmul_smem(2, 64, 64) == -1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_elevator_smem_matches_the_mirrors(cuda, dtype):
    """The scan's, the window's and the backward's shared memory, in every
    plan at the main path's shapes and at ragged ones, equal the source's
    ``elevator_scan_smem``, ``elevator_window_smem`` and
    ``elevator_scan_bwd_smem`` (which the launchers use)."""
    from repro_torch.kernels import common

    lib = common.load_library("elevator_scan")
    code = common.DTYPE_CODE[dtype]
    for b, t, d in ((4, 256, 2560), (1, 4096, 2560), (2, 1024, 2560), (3, 100, 72),
                    (1, 5, 2562)):
        for align in (16, 4):
            for plan in EK.scan_plans(b, t, d, dtype, align):
                mode = EK.SCAN_MODES[plan.mode]
                assert lib.elevator_scan_smem(t, code, plan.cols, plan.stages, mode) == \
                    EK.scan_smem_bytes(plan, t, dtype), (b, t, d, plan)
            for plan in EK.scan_bwd_plans(b, t, d, align):
                mode = EK.SCAN_MODES[plan.mode]
                assert lib.elevator_scan_bwd_smem(t, plan.cols, plan.stages, mode) == \
                    EK.scan_bwd_smem_bytes(plan, t), (b, t, d, plan)
        for k in (1, 8, 37, 64):
            for plan in ED.window_plans(b, k, d, dtype):
                mode = ED.WINDOW_MODES[plan.mode]
                assert lib.elevator_window_smem(k, code, plan.threads, mode) == \
                    ED.window_smem_bytes(plan, k, dtype), (b, k, d, plan)


def test_token_shift_fwd_rows_match_the_mirror(cuda):
    from repro_torch.kernels import common

    lib = common.load_library("token_shift")
    sms = common.sm_count(torch.device("cuda"))
    for dtype in (torch.float32, torch.bfloat16):
        code = common.DTYPE_CODE[dtype]
        for b, t, d in ((4, 4, 2560), (4, 259, 2560), (1, 4096, 2560), (2, 1024, 2560),
                        (1, 1, 8), (7, 33, 1000)):
            for n in (sms, 16, 1):
                assert lib.token_shift_fwd_rows(b, t, d, code, n) == \
                    TS_K.fwd_rows(b, t, d, dtype, n), (b, t, d, n)


def test_every_declared_launch_fits_the_card(cuda):
    """For every arch's declared launches at the card's SM count: each C
    query equals its mirror, and the card reports at least one block an SM
    for the instantiation each launch takes (as ``chip_smoke.py`` phase
    1b)."""
    from repro_torch.analysis import resources
    from repro_torch.configs.registry import list_archs
    from repro_torch.kernels import common

    sms = common.sm_count(torch.device("cuda"))
    seen = {}
    for arch in list_archs():
        for launch in resources.launches(get_config(arch), sms):
            lib = common.load_library(launch.library)
            for entry, args, want in launch.queries:
                assert getattr(lib, entry)(*args) == want, (arch, launch.shape, entry)
            key = (launch.library, launch.occupancy)
            if key not in seen:
                args = tuple(launch.occupancy) + (0,) * (6 - len(launch.occupancy))
                seen[key] = getattr(lib, common.occupancy_entry(launch.library))(*args)
            assert seen[key] >= 1, (arch, launch.kernel, launch.shape, seen[key])
    assert len(seen) >= 30


# --------------------------------------------------------------------------
# The one-card dry run held against the card (chip_smoke.py phase 3o, at
# the reduced archs' widths): what a meta trace records is what the card
# launches and counts.
# --------------------------------------------------------------------------

def _all_counters():
    from repro_torch.kernels.elevator_scan import decode as ED
    from repro_torch.kernels.elevator_scan import kernel as EK
    from repro_torch.kernels.local_attention import kernel as FA
    from repro_torch.kernels.token_shift import kernel as TSK

    fns = (K.wkv_cuda, D.wkv_decode_cuda, D.wkv_decode_window_cuda, K.wkv_train_cuda,
           BW.wkv_bwd_cuda, K.wkv_summary_cuda, K.wkv_train_summary_cuda,
           EK.elevator_scan_cuda, ED.elevator_decode_window_cuda, EK.elevator_scan_bwd_cuda,
           TSK.token_shift_cuda, TSK.token_shift_bwd_cuda, FA.flash_attention_cuda,
           FA.flash_attention_bwd_cuda)
    return {fn.__name__: fn for fn in fns}


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "recurrentgemma-2b", "gemma3-1b",
                                  "qwen2-0.5b", "qwen3-moe-235b-a22b",
                                  "seamless-m4t-large-v2"])
def test_dry_run_trace_matches_the_card(cuda, arch, kind):
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.lowering import cost_counting
    from repro_torch.launch import dryrun

    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="bfloat16")
    n = max(1, cfg.microbatch)
    shape = {"prefill": ShapeConfig("p", 96, max(2, cfg.prefill_chunks), "prefill"),
             "decode": ShapeConfig("d", 96, 4, "decode"),
             "train": ShapeConfig("t", 96, n, "train")}[kind]
    with cost_counting() as c:
        meta_out = dryrun.make_cell(cfg, shape, device="meta").run()
    cell = dryrun.make_cell(cfg, shape, device=cuda, seed=3)
    counters = _all_counters()
    for fn in counters.values():
        fn.launches = 0
    with FlopCounterMode(display=False) as fc:
        out = cell.run()
    torch.cuda.synchronize()
    assert {k: fn.launches for k, fn in counters.items() if fn.launches} == c.launches()
    assert fc.get_total_flops() == sum(c.aten_flops.values())
    first = (lambda o: o[1]["loss"]) if kind == "train" else (
        lambda o: o[0] if kind == "decode" else o)
    assert first(out).shape == first(meta_out).shape and first(out).dtype == first(meta_out).dtype
    assert bool(torch.isfinite(first(out)).all())


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "recurrentgemma-2b", "qwen2-0.5b",
                                  "qwen3-moe-235b-a22b"])
@pytest.mark.parametrize("fsdp", [False, True], ids=["move-activations", "gather-weights"])
def test_sharded_reduced_step_on_a_mesh_of_the_card_matches_unsharded(cuda, arch, fsdp):
    """One train step of the reduced f32 model, sharded on a (2, 4) mesh of
    the card, against the same step unsharded on the card: loss, grad norm,
    each gradient leaf (AdamW's first moment) and parameters, with each
    shard's kernels launched on its own heads and channels."""
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.model import sharding as S

    cfg = dataclasses.replace(get_config(arch).reduced(), microbatch=2,
                              fsdp_gather_weights=fsdp)
    params = TS.init_train_state(cfg, 1, device="cpu").params
    batch = make_batch(DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=8,
                                  seed=2), 0, device="cuda")
    moved = tree_map(lambda p: p.detach().to(cuda, copy=True).requires_grad_(True), params)
    state, m = TS.make_train_step(cfg)(TS.TrainState(moved, adamw.init_state(moved), None),
                                       batch)
    want = (float(m["loss"]), float(m["grad_norm"]),
            [p.detach().cpu() for p in tree_leaves(state.params)], tree_leaves(state.opt.mu))
    mesh = make_debug_mesh(2, 4)
    rules = S.make_rules(mesh, "train")
    counters = _all_counters()
    with S.sharding_context(mesh, rules):
        sharded = TS.shard_train_state(
            TS.TrainState(tree_map(lambda p: p.detach().to(cuda, copy=True), params),
                          adamw.init_state(tree_map(lambda p: p.to(cuda), params)), None),
            cfg, mesh, rules)
        for fn in counters.values():
            fn.launches = 0
        sharded, m = TS.make_train_step(cfg)(sharded, batch)
        torch.cuda.synchronize()
    launched = {k: fn.launches for k, fn in counters.items() if fn.launches}
    assert launched, "the sharded step launched no kernel"
    assert float(m["loss"]) == pytest.approx(want[0], rel=1e-5)
    assert float(m["grad_norm"]) == pytest.approx(want[1], rel=1e-4)
    _first_moments_close([S.to_global(x) for x in tree_leaves(sharded.opt.mu)], want[3])
    got = [S.to_global(p).detach().cpu() for p in tree_leaves(sharded.params)]
    assert max(float((a - b).abs().max()) for a, b in zip(got, want[2])) <= 1e-5


def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _chip_smoke()
#: The archs whose decode launches a kernel: each shard launches it on its
#: own heads or channels (flash for seamless's cross-attention).
DECODE_KERNELS = {"rwkv6-1.6b": "wkv_decode_cuda", "recurrentgemma-2b":
                  "elevator_decode_window_cuda", "seamless-m4t-large-v2": "flash_attention_cuda"}


@pytest.mark.parametrize("mode", ["decode", "decode_long"])
@pytest.mark.parametrize("arch", SMOKE.DECODE_REDUCED_ARCHS)
def test_sharded_decode_reduced_on_a_mesh_of_the_card_matches_cpu_shards(cuda, arch, mode):
    """The reduced f32 model decoding under ``decode`` / ``decode_long``
    rules on a (2, 4) mesh of the card against the same mesh of ``cpu``
    shards (``chip_smoke.py`` phase 3s's run): every call's logits and the
    final state within 1e-4 of the largest, each kernel of the path
    launched by every shard."""
    from repro_torch.launch.mesh import make_debug_mesh

    cfg = SMOKE._decode_reduced_cfg(arch)
    params = M.init_params(cfg, 1, device="cpu")
    inputs = SMOKE._decode_reduced_inputs(torch, cfg)
    want, want_state = SMOKE._decode_reduced_on_mesh(
        torch, cfg, params, make_debug_mesh(*SMOKE.DECODE_MESH, device="cpu"), mode, inputs)
    counters = _all_counters()
    for fn in counters.values():
        fn.launches = 0
    got, got_state = SMOKE._decode_reduced_on_mesh(
        torch, cfg, params, make_debug_mesh(*SMOKE.DECODE_MESH), mode, inputs)
    torch.cuda.synchronize()
    for a, b in zip(got + got_state, want + want_state, strict=True):
        a, b = a.float(), b.float()
        assert float((a - b).abs().max()) <= 1e-4 * max(1.0, float(b.abs().max()))
    if arch in DECODE_KERNELS:
        n = counters[DECODE_KERNELS[arch]].launches
        assert n > 0 and n % 8 == 0, n
