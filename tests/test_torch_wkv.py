"""The port's WKV functions against the reference's.

The plain PyTorch versions (``repro_torch.kernels.wkv``) against the
Pallas kernels in interpret mode and against ``wkv_fused``'s jnp path, on
the same numpy inputs.  The CUDA kernels against the plain versions are in
tests/test_torch_cuda.py.

Tolerances, measured on this tree: the plain versions agree with the
Pallas kernels to about 1e-6 in f32 (different summation orders of the
same f32 math); 1e-4 leaves room for T=256 sweeps.  bf16 outputs are
rounded to bf16 by both sides: one bf16 ulp of the output, 2**-7 relative.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.wkv import ops as jops
from repro.kernels.wkv.decode import wkv_decode_pallas, wkv_decode_window_pallas
from repro.kernels.wkv.kernel import wkv_pallas
from repro_torch.kernels.wkv import decode as D
from repro_torch.kernels.wkv import kernel as K
from repro_torch.kernels.wkv import ops
from repro_torch.kernels.wkv.ref import wkv_chunked_ref, wkv_sequential_ref

jax.config.update("jax_platform_name", "cpu")
# Tiny tensors: one intra-op thread, so parallel test workers do not
# oversubscribe the cores.
torch.set_num_threads(1)

F32_TOL = 1e-4
BF16_RTOL = 2.0 ** -7


def _np_inputs(b, h, t, dh, seed=0, zero_h0=False):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, h, t, dh)).astype(np.float32) for _ in range(3))
    # Decay in the Finch regime (|log w| small enough for the ratio trick).
    w = rng.uniform(0.85, 0.999, (b, h, t, dh)).astype(np.float32)
    u = rng.standard_normal((h, dh)).astype(np.float32)
    h0 = (np.zeros((b, h, dh, dh), np.float32) if zero_h0
          else rng.standard_normal((b, h, dh, dh)).astype(np.float32))
    return r, k, v, w, u, h0


def _jax(args):
    return [jnp.asarray(a) for a in args]


def _torch(args):
    return [torch.from_numpy(a) for a in args]


def _close(got, want, tol=F32_TOL):
    for g, w in zip(got, want):
        g = g.float().numpy() if isinstance(g, torch.Tensor) else np.asarray(g, np.float32)
        np.testing.assert_allclose(g, np.asarray(w, np.float32), rtol=tol, atol=tol)


class TestPlainAgainstPallas:
    @pytest.mark.parametrize("b,h,t,dh,chunk,zero_h0", [
        (2, 2, 64, 64, 16, False),     # nonzero h0, the model's chunk
        (1, 2, 96, 32, 32, True),
        (2, 1, 17, 16, 1, False),      # T=17: the only divisor below 16 is 1
    ])
    def test_chunked(self, b, h, t, dh, chunk, zero_h0):
        args = _np_inputs(b, h, t, dh, seed=t, zero_h0=zero_h0)
        want = wkv_pallas(*_jax(args), chunk=chunk, interpret=True)
        _close(K.wkv_plain(*_torch(args), chunk=chunk), want)
        _close(wkv_sequential_ref(*_torch(args)), want)

    def test_chunk_invariance(self):
        args = _torch(_np_inputs(1, 2, 128, 32, seed=3))
        outs = [wkv_chunked_ref(*args, chunk=c) for c in (8, 32, 128)]
        for got in outs[1:]:
            _close(got, [o.numpy() for o in outs[0]], tol=5e-5)

    def test_chunked_rejects_non_divisor(self):
        with pytest.raises(ValueError):
            wkv_chunked_ref(*_torch(_np_inputs(1, 1, 96, 16)), chunk=64)

    def test_decode_step(self):
        args = _np_inputs(2, 2, 1, 64, seed=1)
        want = wkv_decode_pallas(*_jax(args), interpret=True)
        _close(D.wkv_decode_cuda(*_torch(args)), want)

    @pytest.mark.parametrize("kw", [1, 5, 37])
    def test_decode_window(self, kw):
        args = _np_inputs(2, 2, kw, 64, seed=kw)
        want = wkv_decode_window_pallas(*_jax(args), interpret=True)
        _close(D.wkv_decode_window_cuda(*_torch(args)), want)

    @pytest.mark.parametrize("path", ["chunked", "window"])
    def test_bf16_io(self, path):
        args = _np_inputs(1, 2, 32, 64, seed=9)
        bf = [a.astype(jnp.bfloat16) for a in _jax(args[:5])] + [jnp.asarray(args[5])]
        tb = [t.to(torch.bfloat16) for t in _torch(args[:5])] + [torch.from_numpy(args[5])]
        if path == "chunked":
            want = wkv_pallas(*bf, chunk=16, interpret=True)
            got = K.wkv_plain(*tb, chunk=16)
        else:
            want = wkv_decode_window_pallas(*bf, interpret=True)
            got = D.wkv_decode_window_cuda(*tb)
        assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
        out_w = np.asarray(want[0], np.float32)
        np.testing.assert_allclose(got[0].float().numpy(), out_w,
                                   rtol=BF16_RTOL, atol=BF16_RTOL)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   rtol=F32_TOL, atol=F32_TOL)


class TestDispatch:
    @pytest.mark.parametrize("t,decode,zero_h0", [
        (1, None, False),      # decode inferred from T == 1
        (40, True, False),     # decode window
        (64, True, True),      # the largest window
        (100, True, False),    # stateful sweep longer than a window: chunked
        (80, None, False),     # stateless chunked forward
    ])
    def test_wkv_fused_matches_reference(self, t, decode, zero_h0):
        args = _np_inputs(2, 2, t, 64, seed=t, zero_h0=zero_h0)
        h0_j = None if zero_h0 else jnp.asarray(args[5])
        h0_t = None if zero_h0 else torch.from_numpy(args[5])
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = jops.wkv_fused(*_jax(args[:5]), h0_j, chunk=16,
                                  use_kernel=False, decode=decode)
            got = ops.wkv_fused(*_torch(args[:5]), h0_t, chunk=16,
                                decode=decode)
        assert got[0].dtype == torch.float32 and got[1].dtype == torch.float32
        _close(got, want)

    def test_resolve_chunk_warns_once_per_scope(self):
        ops.reset_chunk_warnings("scope-a")
        ops.reset_chunk_warnings("scope-b")
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            assert ops.resolve_chunk(100, 16, scope="scope-a") == 10
            assert ops.resolve_chunk(100, 16, scope="scope-a") == 10
            assert ops.resolve_chunk(100, 16, scope="scope-b") == 10
            assert ops.resolve_chunk(64, 16, scope="scope-a") == 16
        assert len(rec) == 2

    def test_chunk_warning_scope_and_reset_all_scopes(self):
        """The reference's tests/test_analysis.py:267 case on the port: the
        context manager scopes call sites that name no scope, a per-scope
        reset forgets one scope only, ``all_scopes`` every one."""
        ops.reset_chunk_warnings(all_scopes=True)
        try:
            with warnings.catch_warnings(record=True) as rec:
                warnings.simplefilter("always")
                assert ops.resolve_chunk(10, 4, scope="cfg-a") == 2
                ops.resolve_chunk(10, 4, scope="cfg-a")      # deduped
                ops.resolve_chunk(10, 4, scope="cfg-b")      # fresh scope
            assert len(rec) == 2, [str(w.message) for w in rec]
            with warnings.catch_warnings(record=True) as rec:
                warnings.simplefilter("always")
                with ops.chunk_warning_scope("cfg-c"):
                    ops.resolve_chunk(10, 4)
                    ops.resolve_chunk(10, 4)                 # deduped in scope
                ops.resolve_chunk(10, 4)                     # None scope: new
            assert len(rec) == 2, [str(w.message) for w in rec]
            ops.reset_chunk_warnings("cfg-a")
            with warnings.catch_warnings(record=True) as rec:
                warnings.simplefilter("always")
                ops.resolve_chunk(10, 4, scope="cfg-a")      # warns again
                ops.resolve_chunk(10, 4, scope="cfg-b")      # still deduped
            assert len(rec) == 1, [str(w.message) for w in rec]
            ops.reset_chunk_warnings(all_scopes=True)
            with warnings.catch_warnings(record=True) as rec:
                warnings.simplefilter("always")
                ops.resolve_chunk(10, 4, scope="cfg-b")      # every scope forgotten
            assert len(rec) == 1
        finally:
            ops.reset_chunk_warnings(all_scopes=True)

    def test_use_kernel_false_on_cpu_is_plain(self):
        args = _torch(_np_inputs(1, 1, 8, 64, seed=2))
        a = ops.wkv_fused(*args, use_kernel=False, decode=True)
        b = D.wkv_decode_plain(*args)
        assert all(torch.equal(x, y) for x, y in zip(a, b))

