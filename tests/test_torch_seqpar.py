"""The port's sequence-parallel WKV path against the reference's, on the CPU.

* the summary ops' plain versions against the reference's Pallas kernels
  in interpret mode, and ``WKVSummaryFunction``'s grads against
  ``jax.grad`` of the reference's ``wkv_fused_summary``;
* the device-space primitives (``device_shift``, ``ring_pass``,
  ``halo_exchange``, ``seq_carry_scan``, ``device_linear_scan_carry``,
  ``pipeline_apply``) and ``wkv_seqshard`` (forward and grads) against the
  reference's own on 8 fake host devices, computed once in a subprocess
  (the main process stays one-device), and ``wkv_seqshard`` against the
  single-device ``wkv_fused``;
* the collective budget: only O(Dh²) summaries cross the seq axis, hop
  counts as the cost model's, and a planted token-sized hop is caught;
* ``apply_rwkv_block`` under ``prefill_seq`` rules, the seq prefill step
  and ``ServeEngine(mesh=...)`` against the reference.

The port's mesh here is 8 (or 2 x 4, or 4) "cpu" shards in one process.

Tolerances: the reference holds its own seq path to its single-device one
at 3e-4 (forward) and 3e-3 (grads), its seq prefill at 2e-3 and its block
grads at 5e-3; the port is held to the same.  The summary ops are held to
the Pallas kernels at 5e-4 of the largest value (as in
test_torch_wkv_grad.py); ``a_seg`` is a product of up to 384 decays in
another order (the Pallas carry multiplies per-chunk exponentials, the
plain version takes one exponential of the sum), held at 1e-5 relative.
The primitives move values without arithmetic or compose them in the
reference's order: held at 1e-6.
"""

import inspect
import math
import os
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.kernels.wkv.kernel import wkv_pallas_train_summary
from repro.kernels.wkv.ops import wkv_fused_summary as jax_fused_summary
from repro.model import model as JM
from repro.model import recurrent as jrec
from repro.serve import engine as JE
from repro_torch.configs.registry import get_config
from repro_torch.core import (
    DIAG_STATE,
    ELEMENTWISE,
    cost_model,
    device_comm,
    device_linear_scan_carry,
    device_shift,
    halo_exchange,
    pipeline_apply,
    ring_pass,
    seq_carry_scan,
)
from repro_torch.core.device_comm import record_hops
from repro_torch.kernels.wkv import bwd as BW
from repro_torch.kernels.wkv import kernel as K
from repro_torch.kernels.wkv import ops, seqpar, vjp
from repro_torch.launch.mesh import make_debug_mesh, make_seq_mesh
from repro_torch.model import convert
from repro_torch.model import recurrent as rec
from repro_torch.model.sharding import make_rules, sharding_context
from repro_torch.serve import engine as E

jax.config.update("jax_platform_name", "cpu")
# Tiny tensors: one intra-op thread, so parallel test workers do not
# oversubscribe the cores.
torch.set_num_threads(1)

SRC = str(Path(__file__).resolve().parents[1] / "src")
TOL = 5e-4
BF16_RTOL = 2.0 ** -7
SEQ_FWD_TOL, SEQ_GRAD_TOL = 3e-4, 3e-3
MOVE_TOL = 1e-6

#: The reference's side, run once with 8 fake host devices: it reads the
#: inputs from argv[1] and writes its outputs to argv[2].
REFERENCE_SCRIPT = textwrap.dedent(
    """
    import os
    import sys

    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, PartitionSpec as P

    from repro.core import (
        DIAG_STATE, device_linear_scan_carry, device_shift, halo_exchange,
        pipeline_apply, ring_pass, seq_carry_scan,
    )
    from repro.kernels.common import shard_map_norep
    from repro.kernels.wkv.seqpar import wkv_seqshard

    assert len(jax.devices()) == 8, jax.devices()
    inp = dict(np.load(sys.argv[1]))
    res = {}
    mesh = Mesh(np.array(jax.devices()), ("x",))


    def sm(fn, in_specs, out_specs, *args):
        return np.asarray(jax.jit(shard_map_norep(
            fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs))(*args))


    for name, delta, fill in (("shift_p1", 1, -1.0), ("shift_m2", -2, 9.0),
                              ("shift_p3", 3, 0.5)):
        res[name] = sm(lambda v: device_shift(v, "x", delta, fill=fill),
                       P("x"), P("x"), inp["x"])
    for name, delta in (("ring_p1", 1), ("ring_m3", -3)):
        res[name] = sm(lambda v: ring_pass(v, "x", delta), P("x"), P("x"), inp["x"])
    res["halo"] = sm(
        lambda v: halo_exchange(v, "x", left=2, right=1, fill=-2.0).reshape(1, -1),
        P("x"), P("x", None), inp["seq"])

    for tag in ("elem", "diag"):
        a, b = inp["a_" + tag], inp["b_" + tag]
        kw = {"monoid": DIAG_STATE} if tag == "diag" else {}
        extra = (None,) * (b.ndim - 1)
        for rev in (0, 1):
            def carry(a_, b_):
                ca, cb = device_linear_scan_carry(a_[0], b_[0], "x",
                                                  reverse=bool(rev), **kw)
                return ca[None], cb[None]
            ca, cb = jax.jit(shard_map_norep(
                carry, mesh=mesh, in_specs=(P("x", None), P("x", *extra)),
                out_specs=(P("x", None), P("x", *extra))))(a, b)
            res[f"ca_{tag}_{rev}"], res[f"cb_{tag}_{rev}"] = np.asarray(ca), np.asarray(cb)


    def chunk_fn(carry, v):
        s = carry + v.sum()
        return s, jnp.zeros_like(v) + s


    for rev in (0, 1):
        def run_seq(v):
            c, y = seq_carry_scan(chunk_fn, jnp.asarray(0.5), v, "x", reverse=bool(rev))
            return c.reshape(1), y
        c, y = jax.jit(shard_map_norep(run_seq, mesh=mesh, in_specs=P("x"),
                                       out_specs=(P("x"), P("x"))))(inp["vals"])
        res[f"scan_c_{rev}"], res[f"scan_y_{rev}"] = np.asarray(c), np.asarray(y)


    def run_pipe(w_all, x_all):
        out = pipeline_apply(lambda wi, xi: jnp.tanh(xi @ wi), w_all[0], x_all, "x")
        last = jax.lax.axis_index("x") == 7
        return jax.lax.psum(jnp.where(last, out, 0.0), "x")


    res["pipe"] = sm(run_pipe, (P("x"), P()), P(), inp["pipe_w"], inp["pipe_x"])

    seq_mesh = Mesh(np.array(jax.devices()), ("seq",))
    prims = [jnp.asarray(inp[n]) for n in ("r", "k", "v", "w", "u", "h0")]


    def shard(*a):
        return wkv_seqshard(*a, mesh=seq_mesh, seq_axis="seq", chunk=8, use_kernel=False)


    def loss(*a):
        o_, s_ = shard(*a)
        return (o_ * inp["co"]).sum() + (s_ * inp["cs"]).sum()


    o, s = jax.jit(shard)(*prims)
    res["wkv_out"], res["wkv_s"] = np.asarray(o), np.asarray(s)
    grads = jax.jit(jax.grad(loss, argnums=tuple(range(6))))(*prims)
    for n, g in zip(("r", "k", "v", "w", "u", "h0"), grads):
        res["wkv_g" + n] = np.asarray(g)
    np.savez(sys.argv[2], **res)
    print("REFERENCE_OK")
    """
)

# The 8-device inputs: B, H, T, Dh of the wkv_seqshard case (the reference
# test's).
WB, WH, WT, WDH = 2, 2, 128, 8


def _mesh_inputs():
    rng = np.random.default_rng(0)
    f32 = np.float32
    inp = {
        "x": np.arange(8.0, dtype=f32),
        "seq": np.arange(32.0, dtype=f32),
        "a_elem": rng.uniform(0.6, 1.0, (8, 3)).astype(f32),
        "b_elem": rng.standard_normal((8, 3)).astype(f32),
        "a_diag": rng.uniform(0.5, 1.0, (8, 3)).astype(f32),
        "b_diag": rng.standard_normal((8, 3, 3)).astype(f32),
        "vals": np.arange(1.0, 9.0, dtype=f32),
        "pipe_w": (rng.standard_normal((8, 4, 4)) * 0.3).astype(f32),
        "pipe_x": rng.standard_normal((5, 2, 4)).astype(f32),
    }
    shape = (WB, WH, WT, WDH)
    for n in ("r", "k", "v", "co"):
        inp[n] = rng.standard_normal(shape).astype(f32)
    inp["w"] = rng.uniform(0.85, 0.999, shape).astype(f32)
    inp["u"] = rng.standard_normal((WH, WDH)).astype(f32)
    inp["h0"] = rng.standard_normal((WB, WH, WDH, WDH)).astype(f32)
    inp["cs"] = rng.standard_normal((WB, WH, WDH, WDH)).astype(f32)
    return inp


@pytest.fixture(scope="session")
def mesh_ref(tmp_path_factory):
    """(inputs, the reference's outputs on 8 fake devices)."""
    d = tmp_path_factory.mktemp("seqpar_ref")
    inp = _mesh_inputs()
    np.savez(d / "in.npz", **inp)
    env = {"PYTHONPATH": SRC, "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "HOME": str(d), "JAX_PLATFORMS": "cpu"}
    res = subprocess.run(
        [sys.executable, "-c", REFERENCE_SCRIPT, str(d / "in.npz"), str(d / "out.npz")],
        capture_output=True, text=True, env=env, timeout=600)
    assert res.returncode == 0 and "REFERENCE_OK" in res.stdout, res.stderr[-4000:]
    return inp, dict(np.load(d / "out.npz"))


def _shards(a):
    """Split a numpy array along dim 0 into 8 CPU shards."""
    return list(torch.from_numpy(np.ascontiguousarray(a)).chunk(8))


def _stack(xs):
    return torch.cat([x.reshape(1, *x.shape) if x.ndim == 0 else x[None] for x in xs]).numpy()


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol=TOL):
    for g, w in zip(got, want):
        g, w = _np(g), _np(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol * max(1.0, np.abs(w).max()))


# --------------------------------------------------------------------------
# The summary ops against the reference's Pallas kernels (interpret mode)
# --------------------------------------------------------------------------

def _np_inputs(b, h, t, dh, seed, zero_h0=False):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, h, t, dh)).astype(np.float32) for _ in range(3))
    w = rng.uniform(0.85, 0.999, (b, h, t, dh)).astype(np.float32)
    u = rng.standard_normal((h, dh)).astype(np.float32)
    h0 = (np.zeros((b, h, dh, dh), np.float32) if zero_h0
          else rng.standard_normal((b, h, dh, dh)).astype(np.float32))
    return [r, k, v, w, u, h0]


SUMMARY_CASES = [
    (2, 2, 64, 64, 16, False),     # the model's width and chunk, nonzero h0
    (1, 2, 96, 32, 32, True),
    (1, 1, 384, 16, 16, False),    # a long segment: a_seg near 1e-13
]


def _a_seg_close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=1e-5, atol=1e-30)


@pytest.mark.parametrize("b,h,t,dh,chunk,zero_h0", SUMMARY_CASES)
def test_summary_plain_matches_pallas(b, h, t, dh, chunk, zero_h0):
    prims = _np_inputs(b, h, t, dh, seed=t, zero_h0=zero_h0)
    want = jax_fused_summary(*map(jnp.asarray, prims), chunk=chunk, use_kernel=True)
    got = K.wkv_summary_plain(*map(torch.from_numpy, prims), chunk=chunk)
    assert got[2].shape == (b, h, dh) and got[2].dtype == torch.float32
    _close(got[:2], want[:2])
    _a_seg_close(got[2], want[2])
    # The CPU wrapper and the op are the plain version; nothing launches.
    n = K.wkv_summary_cuda.launches
    for a, c in zip(K.wkv_summary_cuda(*map(torch.from_numpy, prims), chunk=chunk), got):
        assert torch.equal(a, c)
    for a, c in zip(ops.wkv_fused_summary(*map(torch.from_numpy, prims), chunk=chunk), got):
        assert torch.equal(a, c)
    assert K.wkv_summary_cuda.launches == n


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,t,dh,chunk,zero_h0", SUMMARY_CASES[:2])
def test_train_summary_plain_matches_pallas(b, h, t, dh, chunk, zero_h0, dtype):
    prims = _np_inputs(b, h, t, dh, seed=t + 1, zero_h0=zero_h0)
    tp = [torch.from_numpy(a).to(dtype) for a in prims[:5]] + [torch.from_numpy(prims[5])]
    # Both sides get the same rounded inputs.
    jp = [jnp.asarray(x.float().numpy()).astype(jnp.bfloat16 if dtype == torch.bfloat16
                                                  else jnp.float32) for x in tp[:5]]
    want = wkv_pallas_train_summary(*jp, jnp.asarray(prims[5]), chunk=chunk, interpret=True)
    got = K.wkv_train_summary_plain(*tp, chunk=chunk)
    assert got[0].dtype == dtype and got[2].shape == (b, h, t // chunk, dh, dh)
    if dtype == torch.float32:
        _close(got[:3], want[:3])
    else:
        # out is rounded to bf16 on both sides: one ulp apart at most.
        _close(got[:1], want[:1], BF16_RTOL)
        _close(got[1:3], want[1:3])
    _a_seg_close(got[3], want[3])
    for a, c in zip(K.wkv_train_summary_cuda(*tp, chunk=chunk), got):
        assert torch.equal(a, c)


@pytest.mark.parametrize("b,h,t,dh,chunk", [(1, 2, 32, 16, 16), (2, 1, 48, 64, 16)])
def test_summary_function_grads_match_jax(b, h, t, dh, chunk):
    prims = _np_inputs(b, h, t, dh, seed=70 + t)
    rng = np.random.default_rng(t)
    co = rng.standard_normal((b, h, t, dh)).astype(np.float32)
    cs = rng.standard_normal((b, h, dh, dh)).astype(np.float32)
    ca = rng.standard_normal((b, h, dh)).astype(np.float32)

    def f(r, k, v, w, u, h0):
        out, s, a = jax_fused_summary(r, k, v, w, u, h0, chunk=chunk, use_kernel=True)
        return (out * co).sum() + (s * cs).sum() + (a * ca).sum() * 1e3

    want = jax.grad(f, argnums=tuple(range(6)))(*map(jnp.asarray, prims))
    args = [torch.from_numpy(a).requires_grad_(True) for a in prims]
    out, s, a = ops.wkv_fused_summary(*args, chunk=chunk)
    assert type(out.grad_fn).__name__ == "WKVSummaryFunctionBackward"
    loss = ((out * torch.from_numpy(co)).sum() + (s * torch.from_numpy(cs)).sum()
            + (a * torch.from_numpy(ca)).sum() * 1e3)
    got = torch.autograd.grad(loss, args, retain_graph=True)
    _close(got, want)
    # The a_seg cotangent reaches dw (the closed-form fold).
    without = torch.autograd.grad(loss - (a * torch.from_numpy(ca)).sum() * 1e3, args)
    assert float((got[3] - without[3]).abs().max()) > 1e-3


# --------------------------------------------------------------------------
# The device-space primitives against the reference's on 8 fake devices
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name,delta,fill", [("shift_p1", 1, -1.0), ("shift_m2", -2, 9.0),
                                             ("shift_p3", 3, 0.5)])
def test_device_shift_matches_reference(mesh_ref, name, delta, fill):
    inp, ref = mesh_ref
    with record_hops() as log:
        got = device_shift(_shards(inp["x"]), delta, fill=fill)
    np.testing.assert_array_equal(torch.cat(got).numpy(), ref[name])
    assert len(log) == 1 and log[0].elements == 1 and log[0].reverse == (delta < 0)


@pytest.mark.parametrize("name,delta", [("ring_p1", 1), ("ring_m3", -3)])
def test_ring_pass_matches_reference(mesh_ref, name, delta):
    inp, ref = mesh_ref
    np.testing.assert_array_equal(torch.cat(ring_pass(_shards(inp["x"]), delta)).numpy(),
                                  ref[name])


def test_halo_exchange_matches_reference(mesh_ref):
    inp, ref = mesh_ref
    with record_hops() as log:
        got = halo_exchange(_shards(inp["seq"]), left=2, right=1, fill=-2.0)
    np.testing.assert_array_equal(_stack(got), ref["halo"])
    # One hop per side, each moving only the halo.
    assert [h.elements for h in log] == [2, 1]


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
@pytest.mark.parametrize("tag", ["elem", "diag"])
def test_device_linear_scan_carry_matches_reference(mesh_ref, tag, reverse):
    inp, ref = mesh_ref
    a, b = inp[f"a_{tag}"], inp[f"b_{tag}"]
    monoid = DIAG_STATE if tag == "diag" else ELEMENTWISE
    ca, cb = device_linear_scan_carry(_shards(a), _shards(b), monoid=monoid, reverse=reverse)
    for got, want in ((ca, ref[f"ca_{tag}_{int(reverse)}"]), (cb, ref[f"cb_{tag}_{int(reverse)}"])):
        np.testing.assert_allclose(torch.cat(got).numpy(), want, rtol=MOVE_TOL, atol=MOVE_TOL)
    # With a nonzero h0 the entering state of every shard is the sequential
    # recurrence's (in sweep order).
    h0 = np.random.default_rng(1).standard_normal(b.shape[1:]).astype(np.float32)
    order = range(7, -1, -1) if reverse else range(8)
    prev = h0.copy()
    for i in order:
        enter = monoid.scale(ca[i][0], torch.from_numpy(h0)) + cb[i][0]
        np.testing.assert_allclose(enter.numpy(), prev, rtol=1e-5, atol=1e-5)
        prev = monoid.scale(torch.from_numpy(a[i]), torch.from_numpy(prev)).numpy() + b[i]


@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
def test_seq_carry_scan_matches_reference(mesh_ref, reverse):
    inp, ref = mesh_ref

    def chunk_fn(carry, v):
        s = carry + v.sum()
        return s, torch.zeros_like(v) + s

    carries, ys = seq_carry_scan(chunk_fn, 0.5, _shards(inp["vals"]), reverse=reverse)
    np.testing.assert_allclose(torch.cat(ys).numpy(), ref[f"scan_y_{int(reverse)}"],
                               rtol=MOVE_TOL)
    np.testing.assert_allclose(_stack(carries), ref[f"scan_c_{int(reverse)}"], rtol=MOVE_TOL)


def test_pipeline_apply_matches_reference(mesh_ref):
    inp, ref = mesh_ref
    stages = list(torch.from_numpy(inp["pipe_w"]).unbind(0))
    with record_hops() as log:
        out = pipeline_apply(lambda w, x: torch.tanh(x @ w), stages,
                             torch.from_numpy(inp["pipe_x"]))
    np.testing.assert_allclose(out.numpy(), ref["pipe"], rtol=1e-5, atol=1e-5)
    assert len(log) == 5 + 8 - 1          # one hand-off per tick


# --------------------------------------------------------------------------
# wkv_seqshard against the reference and the single-device path
# --------------------------------------------------------------------------

def _wkv_prims(inp, requires_grad=False):
    return [torch.from_numpy(inp[n]).requires_grad_(requires_grad)
            for n in ("r", "k", "v", "w", "u", "h0")]


def _seqshard(mesh, **kw):
    return lambda *a: seqpar.wkv_seqshard(*a, mesh=mesh, chunk=8, **kw)


def _wkv_loss(fn, args, inp):
    o, s = fn(*args)
    return (o * torch.from_numpy(inp["co"])).sum() + (s * torch.from_numpy(inp["cs"])).sum()


def test_wkv_seqshard_forward_matches_reference(mesh_ref):
    inp, ref = mesh_ref
    out, s = _seqshard(make_seq_mesh(8, device="cpu"), seq_axis="seq")(*_wkv_prims(inp))
    _close([out, s], [ref["wkv_out"], ref["wkv_s"]], SEQ_FWD_TOL)


def test_wkv_seqshard_grads_match_reference(mesh_ref):
    inp, ref = mesh_ref
    args = _wkv_prims(inp, requires_grad=True)
    loss = _wkv_loss(_seqshard(make_seq_mesh(8, device="cpu"), seq_axis="seq"), args, inp)
    got = torch.autograd.grad(loss, args)
    _close(got, [ref["wkv_g" + n] for n in ("r", "k", "v", "w", "u", "h0")], SEQ_GRAD_TOL)


@pytest.mark.parametrize("mesh_kw", [
    dict(mesh=(8,), seq_axis="seq"),
    dict(mesh=(2, 4), seq_axis="model", batch_axis="data"),
    dict(mesh=(2, 4), seq_axis="data", batch_axis="model"),
], ids=["seq8", "data2-model4", "model-batch"])
def test_wkv_seqshard_matches_single_device(mesh_kw):
    inp = _mesh_inputs()
    shape = mesh_kw.pop("mesh")
    if mesh_kw.get("batch_axis") == "model":
        # B=2 does not split over 4 batch groups: the shapes are refused.
        mesh = make_debug_mesh(*shape, device="cpu")
        with pytest.raises(ValueError, match="does not split"):
            _seqshard(mesh, **mesh_kw)(*_wkv_prims(inp))
        return
    mesh = make_seq_mesh(*shape, device="cpu") if len(shape) == 1 else \
        make_debug_mesh(*shape, device="cpu")
    args = _wkv_prims(inp, requires_grad=True)
    single = lambda *a: ops.wkv_fused(*a, chunk=8)  # noqa: E731
    _close(_seqshard(mesh, **mesh_kw)(*args), single(*args), SEQ_FWD_TOL)
    want = torch.autograd.grad(_wkv_loss(single, args, inp), args)
    got = torch.autograd.grad(_wkv_loss(_seqshard(mesh, **mesh_kw), args, inp), args)
    _close(got, want, SEQ_GRAD_TOL)


@pytest.mark.parametrize("mesh_kw", [
    dict(mesh=(8,), seq_axis="seq"),
    dict(mesh=(2, 4), seq_axis="model", batch_axis="data"),
], ids=["seq8", "data2-model4"])
def test_wkv_seqshard_hands_shards_over_in_place(monkeypatch, mesh_kw):
    """Under autograd each shard's r/k/v/w reach the training summary sweep
    and the reverse sweep as views of the caller's tensors (the T-windows
    the kernels read in place), never as copies."""
    seen = []

    def spy(fn):
        def wrapped(r, k, v, w, *a, **kw):
            seen.append((fn.__name__, {x.untyped_storage().data_ptr() for x in (r, k, v, w)}))
            return fn(r, k, v, w, *a, **kw)
        return wrapped

    monkeypatch.setattr(vjp, "wkv_train_summary_plain", spy(K.wkv_train_summary_plain))
    monkeypatch.setattr(vjp, "wkv_bwd_plain", spy(BW.wkv_bwd_plain))
    inp = _mesh_inputs()
    shape = mesh_kw.pop("mesh")
    mesh = make_seq_mesh(*shape, device="cpu") if len(shape) == 1 else \
        make_debug_mesh(*shape, device="cpu")
    args = _wkv_prims(inp, requires_grad=True)
    torch.autograd.grad(_wkv_loss(_seqshard(mesh, **mesh_kw), args, inp), args)
    assert [n for n, _ in seen] == ["wkv_train_summary_plain"] * 8 + ["wkv_bwd_plain"] * 8
    want = {x.untyped_storage().data_ptr() for x in args[:4]}
    assert all(ptrs <= want and len(ptrs) == 4 for _, ptrs in seen)


def test_row_stride_takes_contiguous_tensors_and_t_windows():
    # The layout check of the kernels that read a shard in place (pure
    # stride arithmetic, so it runs on CPU tensors).
    x = torch.zeros(2, 3, 40, 64)
    assert K.row_stride("f", x, x, x, x) == 40
    win = x[:, :, 8:24]
    assert K.row_stride("f", win, win, win, win) == 40
    assert K.row_stride("f", *(x.split(10, dim=2)[1],) * 4) == 40
    one = torch.zeros(1, 1, 40, 64)[:, :, 8:24]
    assert K.row_stride("f", one, one, one, one) == 16
    with pytest.raises(ValueError, match="T-windows"):
        K.row_stride("f", win, torch.zeros(2, 3, 48, 64)[:, :, :16], win, win)
    bad = x.transpose(0, 1)[:, :, 8:24]
    with pytest.raises(ValueError, match="T-windows"):
        K.row_stride("f", bad, bad, bad, bad)
    with pytest.raises(ValueError, match="T-windows"):
        K.row_stride("f", *(x[..., :32],) * 4)


# --------------------------------------------------------------------------
# The collective budget (the reference's analysis/collectives.py check)
# --------------------------------------------------------------------------

def _over_budget(hops, budget):
    """Hops that move more than ``budget`` elements from a shard."""
    return [h for h in hops if h.elements > budget]


def _traced_hops(fn, b, h, t, dh, n, grad=False, seed=5):
    """The hops of one call of ``fn`` (a ``wkv_seqshard``) over an n-shard
    seq mesh, and of its backward when ``grad``."""
    prims = [torch.from_numpy(a) for a in _np_inputs(b, h, t, dh, seed)]
    args = [a.requires_grad_(grad) for a in prims]
    with record_hops() as fwd:
        out, s = fn(*args, mesh=make_seq_mesh(n, device="cpu"), seq_axis="seq", chunk=8)
    if not grad:
        return fwd, None
    with record_hops() as bwd:
        torch.autograd.grad(out.sum() + s.sum(), args)
    return fwd, bwd


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_forward_hops_stay_summary_sized(n):
    b, h, t, dh = 2, 2, 192, 8
    hops, _ = _traced_hops(seqpar.wkv_seqshard, b, h, t, dh, n)
    assert not _over_budget(hops, b * h * dh * dh)
    per_tensor = math.ceil(math.log2(n)) + 1
    assert [x.elements for x in hops].count(b * h * dh) == per_tensor       # a_seg
    assert [x.elements for x in hops].count(b * h * dh * dh) == per_tensor  # S
    assert len(hops) == 2 * per_tensor
    # The cost model's fabric bytes, less its masked psum of the final state
    # (the single controller reads S_out off the last shard instead).
    direct = cost_model.wkv_seqshard_traffic(b, h, t, dh, n)[2].traffic
    counted = sum(x.elements for x in hops) * n * 4
    assert counted == direct.fabric_bytes - b * h * n * dh * dh * 4


@pytest.mark.parametrize("n", [2, 8])
def test_backward_hops_run_in_reverse(n):
    b, h, t, dh = 2, 2, 192, 8
    fwd, bwd = _traced_hops(seqpar.wkv_seqshard, b, h, t, dh, n, grad=True)
    assert not _over_budget(fwd + bwd, b * h * dh * dh)
    assert len(bwd) == len(fwd) and all(x.reverse for x in bwd)
    assert not any(x.reverse for x in fwd)


def test_budget_check_catches_a_token_sized_hop():
    # A copy of seqpar with a planted hop of the shards' tokens, the
    # (B, H, T/n, Dh) re-gather the protocol exists to avoid.
    src = inspect.getsource(seqpar)
    anchor = "    carry_a, carry_b = device_linear_scan_carry(a_seg, s0, monoid=DIAG_STATE)\n"
    assert src.count(anchor) == 1
    planted = src.replace(anchor, anchor + "    device_comm.device_shift(r, 1)\n")
    mutant = types.ModuleType("seqpar_planted")
    mutant.__dict__["device_comm"] = device_comm
    exec(compile(planted, "seqpar_planted", "exec"), mutant.__dict__)
    b, h, t, dh, n = 2, 2, 192, 8, 4
    budget = b * h * dh * dh
    hops, _ = _traced_hops(mutant.wkv_seqshard, b, h, t, dh, n)
    assert [x.elements for x in _over_budget(hops, budget)] == [b * h * (t // n) * dh]
    hops, _ = _traced_hops(seqpar.wkv_seqshard, b, h, t, dh, n)
    assert not _over_budget(hops, budget)


# --------------------------------------------------------------------------
# Model level: apply_rwkv_block, the seq prefill step, the serve engine
# --------------------------------------------------------------------------

D_BLOCK = 128


def _block_params(seed=0):
    rng = np.random.default_rng(seed)
    d = D_BLOCK

    def mk(shape, scale=0.1):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return {
        "mu": mk((5, d)), "w_r": mk((d, d)), "w_k": mk((d, d)), "w_v": mk((d, d)),
        "w_g": mk((d, d)), "w_decay_base": mk((d,)), "w_decay_lora_a": mk((d, 64)),
        "w_decay_lora_b": mk((64, d)), "u_bonus": mk((d,)), "w_o": mk((d, d)),
        "out_norm": {"scale": np.ones((d,), np.float32)},
    }


_JCFG = types.SimpleNamespace(fsdp_gather_weights=False, norm_eps=1e-6)
_TCFG = types.SimpleNamespace(norm_eps=1e-6, name="rwkv-block")


def _mesh2_rules():
    mesh = make_debug_mesh(2, 4, device="cpu")
    rules = make_rules(mesh, "prefill_seq")
    assert rules["seq"] == "model" and rules["batch"] == "data"
    return mesh, rules


def test_block_under_prefill_seq_matches_reference():
    params = _block_params()
    x = np.random.default_rng(1).standard_normal((2, 64, D_BLOCK)).astype(np.float32)
    mesh, rules = _mesh2_rules()

    def jloss(p, x_):
        out, _ = jrec.apply_rwkv_block(p, x_, _JCFG, chunk=16)
        return (out * out).sum()

    jp = jax.tree.map(jnp.asarray, params)
    want_out, _ = jax.jit(lambda p, x_: jrec.apply_rwkv_block(p, x_, _JCFG, chunk=16))(
        jp, jnp.asarray(x))
    want_g = jax.jit(jax.grad(jloss))(jp, jnp.asarray(x))
    tp = convert.params_from_jax(params)
    leaves = [tp[k] if k != "out_norm" else tp[k]["scale"] for k in sorted(tp)]
    for leaf in leaves:
        leaf.requires_grad_(True)
    with sharding_context(mesh, rules), record_hops() as log:
        out, _ = rec.apply_rwkv_block(tp, torch.from_numpy(x), _TCFG)
        got_g = torch.autograd.grad((out * out).sum(), leaves)
    # 2 batch groups x (3 + 3) forward hops, and as many back.
    assert sum(not h.reverse for h in log) == 12 and sum(h.reverse for h in log) == 12
    _close([out], [want_out], SEQ_FWD_TOL)
    want_leaves = [want_g[k] if k != "out_norm" else want_g[k]["scale"] for k in sorted(tp)]
    worst = max(float(np.abs(g.numpy() - np.asarray(w)).max())
                for g, w in zip(got_g, want_leaves))
    assert worst < 5e-3


def test_stateful_block_under_prefill_seq_matches_reference():
    # The cache-fill form: an entering state h0, a conv tail and a ragged
    # prefix mask (masked tokens enter as w=1, k=0).
    params = _block_params(2)
    rng = np.random.default_rng(3)
    b, t, d = 2, 64, D_BLOCK
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    h = rng.standard_normal((b, d // 64, 64, 64)).astype(np.float32) * 0.1
    conv = rng.standard_normal((b, 1, d)).astype(np.float32)
    mask = np.arange(t)[None, :] < np.array([[t], [37]])
    mesh, rules = _mesh2_rules()
    jp = jax.tree.map(jnp.asarray, params)
    want_out, want_state = jrec.apply_rwkv_block(
        jp, jnp.asarray(x), _JCFG, state=jrec.RecState(h=jnp.asarray(h), conv=jnp.asarray(conv)),
        token_mask=jnp.asarray(mask), chunk=16)
    tp = convert.params_from_jax(params)
    with sharding_context(mesh, rules), record_hops() as log:
        out, state = rec.apply_rwkv_block(
            tp, torch.from_numpy(x), _TCFG,
            state=rec.RecState(h=torch.from_numpy(h), conv=torch.from_numpy(conv)),
            token_mask=torch.from_numpy(mask))
    assert len(log) == 12
    _close([out, state.h, state.conv], [want_out, want_state.h, want_state.conv],
           SEQ_FWD_TOL)


@pytest.fixture(scope="module")
def reduced():
    cfg_j = jax_config("rwkv6-1.6b").reduced()
    cfg = get_config("rwkv6-1.6b").reduced()
    pj = JM.init_params(cfg_j, jax.random.key(0))
    pt = convert.params_from_jax(jax.tree.map(np.asarray, pj))
    return cfg_j, cfg, pj, pt


def test_seq_prefill_step_matches_reference(reduced):
    cfg_j, cfg, pj, pt = reduced
    tokens = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 64)).astype(np.int32)
    want = JE.make_prefill_step(cfg_j)(pj, jnp.asarray(tokens))
    mesh, _ = _mesh2_rules()
    step = E.make_seq_prefill_step(cfg, mesh, min_len=32)
    with record_hops() as log, torch.no_grad():
        got = step(pt, torch.from_numpy(tokens).long())
    # Every layer of each of the 2 batch groups: 3 + 3 hops.
    assert len(log) == cfg.num_layers * 2 * 6
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3, atol=2e-3)


def test_short_prompt_stays_on_the_plain_rules(reduced):
    cfg_j, cfg, pj, pt = reduced
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    want = JE.make_prefill_step(cfg_j)(pj, jnp.asarray(tokens))
    mesh, _ = _mesh2_rules()
    n = K.wkv_summary_cuda.launches
    with record_hops() as log, torch.no_grad():
        got = E.make_seq_prefill_step(cfg, mesh, min_len=32)(pt, torch.from_numpy(tokens).long())
    assert log == [] and K.wkv_summary_cuda.launches == n
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3, atol=2e-3)


def test_rules_route_by_prompt_length():
    mesh = make_seq_mesh(4, device="cpu")
    assert make_rules(mesh, "prefill_seq")["seq"] == "seq"
    assert make_rules(mesh, "prefill")["seq"] is None
    # With a model axis the reference's rule holds: seq goes over it.
    assert make_rules(make_debug_mesh(1, 2, device="cpu"), "prefill_seq")["seq"] == "model"


LONG_P = E.SEQ_PREFILL_MIN_T


def test_generate_on_a_seq_mesh_equals_reference(reduced):
    cfg_j, cfg, pj, pt = reduced
    prompts = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, LONG_P)).astype(np.int32)
    want = JE.ServeEngine(cfg_j, pj, max_len=LONG_P + 16, decode_window=4).generate(
        jnp.asarray(prompts), 6)
    eng = E.ServeEngine(cfg, pt, max_len=LONG_P + 16, decode_window=4, device="cpu",
                        mesh=make_seq_mesh(4, device="cpu"))
    with record_hops() as log:
        got = eng.generate(prompts, 6)
    # Only the prefill runs sharded: per layer 3 + 3 hops over 4 shards.
    assert len(log) == cfg.num_layers * 6
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_serve_admits_a_long_prompt_through_the_seq_rules(reduced):
    cfg_j, cfg, pj, pt = reduced
    rng = np.random.default_rng(7)
    reqs = [(rng.integers(0, cfg.vocab_size, (LONG_P - 24,)).astype(np.int32), 5),
            (rng.integers(0, cfg.vocab_size, (9,)).astype(np.int32), 4)]
    want = JE.ServeEngine(cfg_j, pj, max_len=LONG_P + 16, decode_window=2).serve(
        [JE.Request(tokens=t, max_new_tokens=n) for t, n in reqs], slots=2)
    eng = E.ServeEngine(cfg, pt, max_len=LONG_P + 16, decode_window=2, device="cpu",
                        mesh=make_seq_mesh(4, device="cpu"))
    with record_hops() as log:
        got = eng.serve([E.Request(tokens=t, max_new_tokens=n) for t, n in reqs], slots=2)
    # One admission round with a 1024-token bucket: every layer sharded.
    assert eng.last_serve_stats["admissions"] == 1 and len(log) == cfg.num_layers * 6
    for w, g, (_, n) in zip(want, got, reqs):
        assert g.outcome == w.outcome == "ok" and g.size == n
        assert np.array_equal(np.asarray(g), np.asarray(w))


def test_engine_refuses_a_mesh_on_another_device_type(reduced):
    _, cfg, _, pt = reduced
    mesh = make_seq_mesh(2, device=["cpu", "meta"])
    with pytest.raises(ValueError, match="device type"):
        E.ServeEngine(cfg, pt, device="cpu", mesh=mesh)


def test_meshes_lay_out_their_devices():
    mesh = make_debug_mesh(2, 3, device="cpu")
    assert mesh.shape == {"data": 2, "model": 3}
    assert mesh.device_grid("model", "data") == [[torch.device("cpu")] * 3] * 2
    spread = make_seq_mesh(4, device=["cpu", "meta"])
    assert [d.type for d in spread.devices] == ["cpu", "meta", "cpu", "meta"]
    assert device_comm.axis_size(spread, "seq") == 4
    with pytest.raises(ValueError):
        make_seq_mesh(0, device="cpu")
