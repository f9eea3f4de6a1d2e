"""The port's RG-LRU kernels' plain versions and its RG-LRU block against
the reference, on the CPU.

Inputs come from numpy with a fixed seed and go through both frameworks;
the reference's Pallas kernels run in interpret mode, as its own tests run
them.  Tolerances, f32: the plain scan and token shift repeat the
reference's arithmetic in the same order (errors measured at or below
1e-6), and the Pallas scan solves each chunk by doubling, another order,
which its own tests hold to 1e-5; 2e-5 is stated for the kernels.  bf16:
both sides round the output to bf16, one ulp at the values of these
inputs, 2e-2 as in the reference's tests.  The block (gates, conv, scan
and projections) is held to 1e-4, the port's model tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.kernels.elevator_scan.decode import elevator_decode_window_pallas
from repro.kernels.elevator_scan.kernel import elevator_scan_pallas
from repro.kernels.elevator_scan.ref import elevator_scan_ref as jax_scan_ref
from repro.kernels.token_shift.kernel import token_shift_pallas
from repro.kernels.token_shift.ref import token_shift_ref as jax_shift_ref
from repro.model import model as JM
from repro.model import recurrent as JR
from repro_torch.configs.registry import get_config
from repro_torch.kernels.elevator_scan import decode as ED
from repro_torch.kernels.elevator_scan import kernel as EK
from repro_torch.kernels.elevator_scan import ops as EO
from repro_torch.kernels.token_shift import kernel as TK
from repro_torch.kernels.token_shift import ops as TO
from repro_torch.model import convert
from repro_torch.model import recurrent as R

jax.config.update("jax_platform_name", "cpu")
# Tiny tensors: one intra-op thread, so parallel test workers do not
# oversubscribe the cores.
torch.set_num_threads(1)

TOL = 2e-5
BF16_TOL = 2e-2
BLOCK_TOL = 1e-4


def _np(x):
    return np.asarray(x, np.float32)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(np.asarray(a, np.float32)).astype(dtype)


def _scan_inputs(shape, seed, h0=False):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 1.0, shape).astype(np.float32)     # the RG-LRU regime
    x = rng.standard_normal(shape).astype(np.float32)
    h = rng.standard_normal((shape[0], shape[2])).astype(np.float32) if h0 else None
    return a, x, h


# ---------------------------------------------------------------------------
# Elevator scan
# ---------------------------------------------------------------------------

SHAPES = [(1, 8, 128), (2, 64, 128), (1, 256, 256), (3, 128, 384), (2, 512, 128)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_scan_plain_matches_pallas(shape, bf16):
    a, x, _ = _scan_inputs(shape, sum(shape))
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)
    want = elevator_scan_pallas(_j(a, jdt), _j(x, jdt), chunk=min(shape[1], 64),
                                interpret=True)
    got = EK.elevator_scan_cuda(_t(a, tdt), _t(x, tdt))      # CPU: the plain version
    assert got.dtype == tdt
    tol = BF16_TOL if bf16 else TOL
    np.testing.assert_allclose(_np(got.float()), _np(want), rtol=tol, atol=tol)


def test_scan_h0_and_chunk_invariance():
    a, x, h = _scan_inputs((2, 128, 128), 3, h0=True)
    got = _np(EK.elevator_scan_ref(_t(a), _t(x), _t(h)))
    np.testing.assert_allclose(got, _np(jax_scan_ref(_j(a), _j(x), _j(h))), rtol=1e-6, atol=1e-6)
    for chunk in (8, 32, 128):
        want = elevator_scan_pallas(_j(a), _j(x), _j(h), chunk=chunk, interpret=True)
        np.testing.assert_allclose(got, _np(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("k", [1, 5, 37, 64])
def test_window_plain_matches_pallas(k):
    a, x, h = _scan_inputs((2, k, 256), k, h0=True)
    want = elevator_decode_window_pallas(_j(a), _j(x), _j(h), interpret=True)
    out, h_last = ED.elevator_decode_window_cuda(_t(a), _t(x), _t(h))
    # One multiply and one add per step in both: equal up to f32 rounding.
    np.testing.assert_allclose(_np(out), _np(want), rtol=1e-6, atol=1e-6)
    assert torch.equal(h_last, out[:, -1])


def test_window_carry_across_windows():
    a, x, h = _scan_inputs((2, 40, 128), 7, h0=True)
    hj, ht = _j(h), _t(h)
    outs_j, outs_t = [], []
    for lo, hi in ((0, 1), (1, 9), (9, 40)):
        oj = elevator_decode_window_pallas(_j(a[:, lo:hi]), _j(x[:, lo:hi]), hj, interpret=True)
        ot, ht = ED.elevator_decode_window_cuda(_t(a[:, lo:hi]), _t(x[:, lo:hi]), ht)
        hj = oj[:, -1]
        outs_j.append(_np(oj))
        outs_t.append(_np(ot))
    np.testing.assert_allclose(np.concatenate(outs_t, 1), np.concatenate(outs_j, 1),
                               rtol=1e-6, atol=1e-6)
    # Chained windows equal one sweep over the whole span.
    whole = _np(EK.elevator_scan_ref(_t(a), _t(x), _t(h)))
    np.testing.assert_array_equal(np.concatenate(outs_t, 1), whole)


@pytest.mark.parametrize("t,decode,h0", [(1, None, True), (1, None, False), (40, True, True),
                                         (64, True, False), (65, True, True), (40, False, True)])
def test_ops_dispatch_matches_reference_op(t, decode, h0):
    from repro.kernels.elevator_scan.ops import elevator_scan as jax_op

    a, x, h = _scan_inputs((2, t, 128), t, h0=h0)
    want = jax_op(_j(a), _j(x), None if h is None else _j(h), decode=decode)
    got = EO.elevator_scan(_t(a), _t(x), None if h is None else _t(h), decode=decode)
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("t,decode", [(1, None), (40, True), (65, True), (40, False)])
def test_ops_on_cpu_tensors_never_reach_a_kernel(monkeypatch, t, decode):
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA wrapper was called on CPU tensors")

    for name in ("elevator_scan_cuda", "elevator_decode_window_cuda"):
        monkeypatch.setattr(EO, name, refuse)
    monkeypatch.setattr(TO, "token_shift_cuda", refuse)
    a, x, h = _scan_inputs((1, t, 8), t, h0=True)
    EO.elevator_scan(_t(a), _t(x), _t(h), decode=decode)
    TO.token_shift(_t(x), torch.ones(4, 8))


# ---------------------------------------------------------------------------
# Token shift
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t", [8, 64, 256])
@pytest.mark.parametrize("taps", [2, 4, 8])
def test_token_shift_plain_matches_pallas(t, taps):
    rng = np.random.default_rng(t * 10 + taps)
    x = rng.standard_normal((2, t, 128)).astype(np.float32)
    w = rng.standard_normal((taps, 128)).astype(np.float32)
    want = token_shift_pallas(_j(x), _j(w), interpret=True)
    got = TK.token_shift_cuda(_t(x), _t(w))
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("t", [4, 11, 67, 259])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_token_shift_any_length_matches_ref(t, bf16):
    # The stateful calls' lengths (taps - 1 + window): the Pallas wrapper
    # refuses T = 259 (min(256, T) must divide T), the reference's plain
    # function takes it.
    rng = np.random.default_rng(t)
    x = rng.standard_normal((3, t, 96)).astype(np.float32)
    w = rng.standard_normal((4, 96)).astype(np.float32)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)
    want = jax_shift_ref(_j(x, jdt), _j(w, jdt))
    got = TO.token_shift(_t(x, tdt), _t(w, tdt))
    tol = BF16_TOL if bf16 else 1e-6
    np.testing.assert_allclose(_np(got.float()), _np(want), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# The RG-LRU block
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def block():
    cfg_j = jax_config("recurrentgemma-2b").reduced()
    cfg = get_config("recurrentgemma-2b").reduced()
    params_j = JM.init_params(cfg_j, jax.random.key(0))["decoder"]["scanned"][0]["rec"]
    params_j = jax.tree.map(lambda a: a[0], params_j)           # period 0, layer 0
    params_t = convert.params_from_jax(jax.tree.map(np.asarray, params_j))
    return cfg_j, cfg, params_j, params_t


def test_block_forward_matches_reference(block):
    cfg_j, cfg, pj, pt = block
    x = np.random.default_rng(0).standard_normal((2, 50, cfg.d_model)).astype(np.float32)
    want, _ = JR.apply_rglru_block(pj, _j(x), cfg_j)
    got, st = R.apply_rglru_block(pt, _t(x), cfg)
    assert st is None
    np.testing.assert_allclose(_np(got), _np(want), rtol=BLOCK_TOL, atol=BLOCK_TOL)


@pytest.mark.parametrize("t", [1, 6, 70])
def test_block_stateful_masked_matches_reference(block, t):
    cfg_j, cfg, pj, pt = block
    rng = np.random.default_rng(t)
    b, dr = 3, cfg.d_rnn
    x = rng.standard_normal((b, t, cfg.d_model)).astype(np.float32)
    h = rng.standard_normal((b, dr)).astype(np.float32)
    conv = rng.standard_normal((b, cfg.conv_width - 1, dr)).astype(np.float32)
    mask = np.ones((b, t), bool)
    mask[1, max(1, t // 2):] = False          # ragged
    mask[2] = False                           # frozen slot
    want, st_j = JR.apply_rglru_block(pj, _j(x), cfg_j, state=JR.RecState(_j(h), _j(conv)),
                                      token_mask=jnp.asarray(mask))
    got, st_t = R.apply_rglru_block(pt, _t(x), cfg, state=R.RecState(_t(h), _t(conv)),
                                    token_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(_np(got), _np(want), rtol=BLOCK_TOL, atol=BLOCK_TOL)
    for a, w in zip(st_t, st_j):
        np.testing.assert_allclose(_np(a), _np(w), rtol=BLOCK_TOL, atol=BLOCK_TOL)
    # The frozen slot's state is bit-identical.
    assert np.array_equal(_np(st_t.h[2]), h[2]) and np.array_equal(_np(st_t.conv[2]), conv[2])
