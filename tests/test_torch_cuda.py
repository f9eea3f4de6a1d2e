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
    """Each planted fault compiled into its own copy of library ``name``
    (nvcc in parallel, the build's flags); returns fault -> loaded library,
    its entry points bound as the build binds them."""
    import subprocess

    from repro_torch.kernels import common

    src = common.KERNEL_SOURCES[name].read_text()
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for fault, (anchor, repl) in faults.items():
        assert src.count(anchor) == 1, fault
        cu = out / f"{fault}.cu"
        cu.write_text(src.replace(anchor, repl))
        procs[fault] = subprocess.Popen(
            [common._nvcc(), *common._NVCC_FLAGS, "-o", str(out / f"{fault}.so"), str(cu)],
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
