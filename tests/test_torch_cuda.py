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


# ---------------------------------------------------------------------------
# RecurrentGemma's kernels: the elevator scan and its decode window, the
# token shift and flash attention.
# ---------------------------------------------------------------------------

from repro_torch.kernels.elevator_scan import decode as ED  # noqa: E402
from repro_torch.kernels.elevator_scan import kernel as EK  # noqa: E402
from repro_torch.kernels.local_attention import kernel as FA  # noqa: E402
from repro_torch.kernels.token_shift import kernel as TS_K  # noqa: E402

# bf16 attention is held per element, scaled to the element and to the RMS
# of its output row (over D):
#   |got - want| <= ATTN_BF16_ULP * |want| + ATTN_BF16_ROW * rms(want row).
# Both versions round the output to bf16, so the two may sit one bf16 ulp
# apart (at most 2**-7 of the value).  The kernel also rounds P to bf16
# before the P.V product: 2**-9 relative per term, summed over the row's
# keys as a random walk that stays several times under 2**-5 of the row's
# RMS.  A fault that moves whole late rows by a few percent (a skipped K
# tile, a missed rescale) exceeds the row term; a fully masked row must be 0.
ATTN_BF16_ULP = 2.0 ** -7
ATTN_BF16_ROW = 2.0 ** -5


def _attn_bf16_ratio(got, want):
    """max over elements of |got - want| / tolerance (<= 1 passes)."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    tol = ATTN_BF16_ULP * w.abs() + ATTN_BF16_ROW * w.pow(2).mean(-1, keepdim=True).sqrt()
    ratio = torch.where(tol > 0, err / tol.clamp_min(1e-30), err * float("inf"))
    return float(ratio.nan_to_num(0.0).max())


def _attn_close(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    if got.dtype == torch.float32:
        _close([got], [want], F32_TOL)
    else:
        ratio = _attn_bf16_ratio(got, want)
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
    a, x, h = _scan_inputs(b, t, d, t + d, cuda, dtype, h0)
    got = EK.elevator_scan_cuda(a, x, h)
    assert got.dtype == dtype and got.shape == (b, t, d)
    _close([got], [EK.elevator_scan_ref(a, x, h)],
           F32_TOL if dtype == torch.float32 else BF16_RTOL)


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
@pytest.mark.parametrize("d", [32, 256])
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
FLASH_FAULTS = {
    # Skip the first K tile of every block whose key range spans more than
    # 16 tiles (the rows from about 960 on).
    "skip_first_tile": ("    // S = Q K^T: 16 rows x BK keys per warp.\n",
                        "    if (kb == (lo / BK) * BK && hi - lo > 16 * BK) continue;\n"
                        "    // S = Q K^T: 16 rows x BK keys per warp.\n"),
    # The same, only where the window has slid past key 0 (rows >= 2048):
    # late rows move by a few percent, under the old whole-output bound.
    "skip_first_tile_late": ("    // S = Q K^T: 16 rows x BK keys per warp.\n",
                             "    if (kb == (lo / BK) * BK && lo > 0) continue;\n"
                             "    // S = Q K^T: 16 rows x BK keys per warp.\n"),
    # Leave the online-softmax rescale off the lower half of each warp's rows.
    "alpha_off_row_half": ("      acc[n][2] *= alpha[1];\n      acc[n][3] *= alpha[1];\n", ""),
    # Reduce the row sum over only half the row's threads for that half.
    "l_sum_half": ("    l += __shfl_xor_sync(0xffffffffu, l, 2);\n",
                   "    if (i == 0) l += __shfl_xor_sync(0xffffffffu, l, 2);\n"),
}


@pytest.fixture(scope="module")
def flash_mutants(tmp_path_factory):
    """Each planted fault compiled into its own library (nvcc in parallel)."""
    import ctypes
    import subprocess

    from repro_torch.kernels import common

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels are CUDA C++ for sm_90a")
    src = common.KERNEL_SOURCES["flash_attention"].read_text()
    out, procs = tmp_path_factory.mktemp("flash_mutants"), {}
    for name, (anchor, repl) in FLASH_FAULTS.items():
        assert src.count(anchor) == 1, name
        cu = out / f"{name}.cu"
        cu.write_text(src.replace(anchor, repl))
        procs[name] = subprocess.Popen(
            [common._nvcc(), *common._NVCC_FLAGS, "-o", str(out / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        report, _ = proc.communicate()
        assert proc.returncode == 0, report
    return {name: ctypes.CDLL(str(out / f"{name}.so")) for name in FLASH_FAULTS}


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
              f"ratio {_attn_bf16_ratio(got, want):.3f}")
    assert _attn_bf16_ratio(good, want) <= 1.0
    assert _attn_bf16_ratio(bad, want) > 1.0


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
from repro_torch.kernels import card_checks as CC  # noqa: E402
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

from repro_torch.kernels import card_checks as CC  # noqa: E402
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
