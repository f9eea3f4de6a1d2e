"""The port's single-device communication primitives (``repro_torch.core``)
against the reference's ``repro.core``, on the CPU.

Inputs come from numpy with a fixed seed and go through both packages.
Tolerances: the elevator shifts, the cascades, ``from_thread_or_mem``
(index arithmetic in the port, an associative scan in the reference) and
``SharedBuffer`` move values only, so they are held bit for bit.  The
scans compose in another order than ``lax.associative_scan`` (Hillis–
Steele doubling against the reference's tree), so they are held to 2e-5
in f32, the tolerance the reference's own tests give its chunked scan.
The cost-model copies are pure Python and must equal the reference's
field for field.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

import repro.core as J
from repro.core import cost_model as JC
import repro_torch.core as T
from repro_torch.core import cost_model as TC

jax.config.update("jax_platform_name", "cpu")
# Tiny tensors: one intra-op thread, so parallel test workers do not
# oversubscribe the cores.
torch.set_num_threads(1)

SCAN_TOL = 2e-5

# The reference under jit: one compile per shape instead of one per
# primitive, which keeps this file to seconds.
_jit = {
    "const": jax.jit(J.from_thread_or_const, static_argnames=("delta", "const", "window", "axis")),
    "const_nd": jax.jit(J.from_thread_or_const_nd,
                        static_argnames=("deltas", "const", "axes", "windows")),
    "mem": jax.jit(J.from_thread_or_mem, static_argnames=("delta", "window", "const", "axis")),
    "scan": jax.jit(J.linear_scan, static_argnames=("axis",)),
    "chunked": jax.jit(J.chunked_linear_scan, static_argnames=("chunk", "axis", "monoid")),
}


def _same(got, want):
    """Bit-for-bit equality of a torch result and a JAX result."""
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def ref_elevator(x, delta, const, window=None):
    """Paper Fig. 4 pseudo-code, one thread at a time."""
    n = x.shape[0]
    out = np.full_like(x, const)
    for tid in range(n):
        src = tid - delta
        if 0 <= src < n and (window is None or tid // window == src // window):
            out[tid] = x[src]
    return out


def ref_eldst(mem, pred, delta, window=None, const=0):
    """The eLDST recurrence, one thread at a time (paper §4.2)."""
    n = mem.shape[0]
    win = window if window is not None else n
    out = np.full_like(mem, const)
    for t in range(n):
        if pred[t]:
            out[t] = mem[t]
        elif t - delta >= 0 and t // win == (t - delta) // win:
            out[t] = out[t - delta]
    return out


def ref_linear_scan(a, b, h0=0.0):
    h = np.zeros_like(b)
    prev = np.broadcast_to(np.asarray(h0, b.dtype), b.shape[1:]).copy()
    for t in range(b.shape[0]):
        prev = a[t] * prev + b[t]
        h[t] = prev
    return h


class TestElevator:
    @pytest.mark.parametrize("delta,const,window", [
        (1, -1.0, None),     # basic shift
        (-1, 0.0, None),     # conv reads tid+1 (paper Fig. 1c)
        (0, 9.0, None),      # identity
        (1, -1.0, 4),        # thread 4 must not receive from thread 3
        (3, 0.0, 8),
        (-5, 2.5, 3),
        (70, 1.0, None),     # |delta| beyond the axis: all const
    ])
    def test_matches_reference(self, delta, const, window):
        x = np.arange(16, dtype=np.float32) * 1.5 - 4
        got = T.from_thread_or_const(torch.from_numpy(x), delta, const, window=window)
        want = _jit["const"](jnp.asarray(x), delta=delta, const=const, window=window)
        _same(got, want)
        np.testing.assert_array_equal(got.numpy(), ref_elevator(x, delta, const, window))

    @given(
        n=st.integers(2, 64),
        delta=st.integers(-70, 70),
        window=st.one_of(st.none(), st.integers(1, 16)),
        seed=st.integers(0, 2**31 - 1),
    )
    @settings(max_examples=60, deadline=None)
    def test_matches_paper_pseudocode(self, n, delta, window, seed):
        x = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
        got = T.from_thread_or_const(torch.from_numpy(x), delta, 7.5, window=window)
        np.testing.assert_array_equal(got.numpy(), ref_elevator(x, delta, 7.5, window))

    @pytest.mark.parametrize("axis", [0, 1, -1])
    def test_multidim_values_and_axis(self, axis):
        x = np.random.default_rng(1).standard_normal((6, 5)).astype(np.float32)
        got = T.from_thread_or_const(torch.from_numpy(x), 2, 0.0, axis=axis, window=4)
        _same(got, _jit["const"](jnp.asarray(x), delta=2, const=0.0, axis=axis, window=4))

    def test_inf_constant_stays_inf(self):
        # pathfinder injects +inf at the edges: torch.where, never a mask
        # product (0 * inf is NaN).
        x = np.arange(6, dtype=np.float32)
        for delta in (1, -1):
            got = T.from_thread_or_const(torch.from_numpy(x), delta, np.inf)
            _same(got, _jit["const"](jnp.asarray(x), delta=delta, const=np.inf))
            assert not torch.isnan(got).any() and torch.isinf(got).sum() == 1

    @pytest.mark.parametrize("deltas,windows", [
        ((1, 0), None),                  # paper Fig. 2b
        ((1, 1), None),
        ((-1, 2), (None, 3)),
        ((0, -1), None),
    ])
    def test_2d_tid_space(self, deltas, windows):
        x = np.arange(48, dtype=np.float32).reshape(6, 8)
        got = T.from_thread_or_const_nd(torch.from_numpy(x), deltas, -1.0, windows=windows)
        _same(got, _jit["const_nd"](jnp.asarray(x), deltas=deltas, const=-1.0, windows=windows))

    def test_3d_tid_space_with_axes(self):
        x = np.random.default_rng(2).standard_normal((3, 4, 5)).astype(np.float32)
        got = T.from_thread_or_const_nd(torch.from_numpy(x), (1, -2), 0.5, axes=(2, 0))
        _same(got, _jit["const_nd"](jnp.asarray(x), deltas=(1, -2), const=0.5, axes=(2, 0)))

    def test_nd_length_mismatch_raises(self):
        with pytest.raises(ValueError):
            T.from_thread_or_const_nd(torch.zeros(3, 3), (1, 0), 0.0, axes=(0,))

    def test_tag_value_identity(self):
        x = torch.arange(4.0)
        assert T.tag_value(x, "sum") is x and T.tag_value(x) is x


class TestCascade:
    @pytest.mark.parametrize("delta", [18, -18, 5, 16, 17, 0, 100, 16 * 17])
    @pytest.mark.parametrize("token_buffer,max_nodes", [(16, 16), (8, 4)])
    def test_plan_matches_reference(self, delta, token_buffer, max_nodes):
        got = T.plan_cascade(delta, token_buffer=token_buffer, max_nodes=max_nodes)
        want = J.plan_cascade(delta, token_buffer=token_buffer, max_nodes=max_nodes)
        assert (got.delta, got.node_deltas, got.spilled, got.num_nodes) == (
            want.delta, want.node_deltas, want.spilled, want.num_nodes)

    def test_paper_example_delta18(self):
        # Paper Fig. 10a: delta 18, buffer 16 -> nodes [16, 2].
        assert T.plan_cascade(18).node_deltas == (16, 2)
        assert T.TOKEN_BUFFER_SIZE == J.TOKEN_BUFFER_SIZE == 16
        for delta in [1, 15, 16, 17, 31, 32, 33, 100]:
            assert T.plan_cascade(delta).num_nodes == math.ceil(delta / 16)

    @pytest.mark.parametrize("n,delta,window,token_buffer,max_nodes", [
        (64, 18, None, 16, 16),      # two nodes
        (40, -37, 12, 8, 16),
        (128, 90, None, 8, 16),
        (32, 20, 8, 4, 2),           # spills: the direct shift
        (16, 0, None, 16, 16),
    ])
    def test_cascade_equals_reference_and_single_shift(self, n, delta, window,
                                                       token_buffer, max_nodes):
        x = np.random.default_rng(n + delta).standard_normal(n).astype(np.float32)
        kw = dict(window=window, token_buffer=token_buffer, max_nodes=max_nodes)
        got, plan = T.cascaded_from_thread_or_const(torch.from_numpy(x), delta, 3.0, **kw)
        want, jplan = J.cascaded_from_thread_or_const(jnp.asarray(x), delta, 3.0, **kw)
        _same(got, want)
        assert (plan.node_deltas, plan.spilled) == (jplan.node_deltas, jplan.spilled)
        single = T.from_thread_or_const(torch.from_numpy(x), delta, 3.0, window=window)
        assert torch.equal(got, single)


class TestFromThreadOrMem:
    @pytest.mark.parametrize("n,delta,window,const,pattern", [
        (10, 1, None, 0.0, "first"),     # single loader broadcast chain
        (12, 1, 4, 0.0, "every4"),       # strided loaders: matmul tile pattern
        (8, 2, None, 0.0, "first2"),     # even and odd chains independent
        (4, 1, None, -9.0, "third"),     # const before the first producer
        (8, 1, 4, 0.0, "first"),         # the window resets forwarding
        (8, 1, 4, -1.0, "first_and_4"),
        (13, 3, 5, 2.0, "random"),       # window not a multiple of delta
        (30, 4, 7, -3.0, "random"),
    ])
    def test_matches_reference(self, n, delta, window, const, pattern):
        rng = np.random.default_rng(n * 7 + delta)
        mem = rng.standard_normal(n).astype(np.float32)
        pred = {
            "first": np.arange(n) == 0,
            "every4": np.arange(n) % 4 == 0,
            "first2": np.arange(n) < 2,
            "third": np.arange(n) == 2,
            "first_and_4": (np.arange(n) == 0) | (np.arange(n) == 4),
            "random": rng.random(n) < 0.3,
        }[pattern]
        got = T.from_thread_or_mem(torch.from_numpy(mem), torch.from_numpy(pred), delta,
                                   window=window, const=const)
        want = _jit["mem"](jnp.asarray(mem), jnp.asarray(pred), delta=delta,
                           window=window, const=const)
        _same(got, want)
        np.testing.assert_array_equal(got.numpy(), ref_eldst(mem, pred, delta, window, const))

    @given(
        n=st.integers(2, 48),
        delta=st.integers(1, 8),
        window=st.one_of(st.none(), st.integers(2, 12)),
        seed=st.integers(0, 2**31 - 1),
    )
    @settings(max_examples=60, deadline=None)
    def test_matches_recurrence(self, n, delta, window, seed):
        rng = np.random.default_rng(seed)
        mem = rng.standard_normal(n).astype(np.float32)
        pred = rng.random(n) < 0.3
        got = T.from_thread_or_mem(torch.from_numpy(mem), torch.from_numpy(pred), delta,
                                   window=window, const=5.0)
        np.testing.assert_array_equal(got.numpy(), ref_eldst(mem, pred, delta, window, 5.0))

    @pytest.mark.parametrize("axis", [0, 1])
    def test_vector_payload_and_axis(self, axis):
        rng = np.random.default_rng(4)
        mem = rng.standard_normal((6, 9) if axis == 0 else (3, 6, 2)).astype(np.float32)
        pred = np.array([True, False, False, True, False, False])
        got = T.from_thread_or_mem(torch.from_numpy(mem), torch.from_numpy(pred), 2,
                                   window=5, axis=axis)
        _same(got, _jit["mem"](jnp.asarray(mem), jnp.asarray(pred), delta=2,
                               window=5, axis=axis))

    def test_rejects_bad_delta_and_pred(self):
        with pytest.raises(ValueError):
            T.from_thread_or_mem(torch.arange(4.0), torch.ones(4, dtype=torch.bool), delta=0)
        with pytest.raises(ValueError):
            T.from_thread_or_mem(torch.arange(4.0), torch.ones(3, dtype=torch.bool), delta=1)

    def test_grad_flows_to_loaded_values(self):
        # d(sum(out))/d(mem) counts how many threads consume each load.
        mem = torch.arange(4.0, requires_grad=True)
        pred = torch.tensor([True, False, False, False])
        T.from_thread_or_mem(mem, pred, 1).sum().backward()
        np.testing.assert_array_equal(mem.grad.numpy(), [4.0, 0.0, 0.0, 0.0])

    def test_forward_stats_match_reference(self):
        # Paper §3.3: the A operand of a (4,5)x(5,6) matmul, one loader per row.
        pred = np.asarray([ty == 0 for tx in range(4) for ty in range(6)])
        got = T.forward_stats(torch.from_numpy(pred), delta=1)
        want = J.forward_stats(pred, delta=1)
        assert (got.loads_issued, got.loads_forwarded, got.loads_naive,
                got.traffic_reduction) == (want.loads_issued, want.loads_forwarded,
                                           want.loads_naive, want.traffic_reduction)
        assert got.loads_issued == 4 and got.loads_forwarded == 20


class TestLinearScan:
    def test_prefix_sum_is_special_case(self):
        # Paper Fig. 6: prefix sum == linear scan with a == 1.
        b = torch.arange(1.0, 9.0)
        np.testing.assert_allclose(T.linear_scan(torch.ones_like(b), b).numpy(),
                                   np.cumsum(b.numpy()), rtol=1e-6)

    @pytest.mark.parametrize("t,d,axis", [(1, 3, 0), (7, 3, 0), (32, 5, 0), (64, 8, 1)])
    def test_matches_reference(self, t, d, axis):
        rng = np.random.default_rng(t + d)
        shape = (t, d) if axis == 0 else (d, t)
        a = rng.uniform(0.5, 1.0, shape).astype(np.float32)
        b = rng.standard_normal(shape).astype(np.float32)
        got = T.linear_scan(torch.from_numpy(a), torch.from_numpy(b), axis=axis)
        want = _jit["scan"](jnp.asarray(a), jnp.asarray(b), axis=axis)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=SCAN_TOL, atol=SCAN_TOL)

    def test_bpnn_axis_1(self):
        # bpnn: the (64, 2048)-shaped chain over axis 1, at a smaller width.
        rng = np.random.default_rng(5)
        prod = (rng.standard_normal((8, 256)) * 0.05).astype(np.float32)
        got = T.linear_scan(torch.ones(8, 256), torch.from_numpy(prod), axis=1)
        want = _jit["scan"](jnp.ones((8, 256)), jnp.asarray(prod), axis=1)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=SCAN_TOL, atol=SCAN_TOL)

    def test_h0_fold_with_numpy_inputs(self):
        rng = np.random.default_rng(3)
        a = rng.uniform(0.5, 1.0, (6, 2)).astype(np.float32)
        b = rng.standard_normal((6, 2)).astype(np.float32)
        got = T.linear_scan(a, b, h0=2.5)
        np.testing.assert_allclose(got.numpy(), ref_linear_scan(a, b, 2.5),
                                   rtol=SCAN_TOL, atol=SCAN_TOL)
        np.testing.assert_allclose(got.numpy(), np.asarray(_jit["scan"](a, b, h0=2.5)),
                                   rtol=SCAN_TOL, atol=SCAN_TOL)
        assert torch.equal(T.linear_scan(torch.from_numpy(a), torch.from_numpy(b), h0=2.5),
                           got)

    @pytest.mark.parametrize("t,chunk", [(4, 2), (8, 4), (16, 8), (32, 2), (32, 32), (12, 4)])
    def test_chunked_matches_reference_and_flat(self, t, chunk):
        rng = np.random.default_rng(t * chunk)
        a = rng.uniform(0.5, 1.0, (t, 3)).astype(np.float32)
        b = rng.standard_normal((t, 3)).astype(np.float32)
        got = T.chunked_linear_scan(torch.from_numpy(a), torch.from_numpy(b), chunk=chunk)
        want = _jit["chunked"](jnp.asarray(a), jnp.asarray(b), chunk=chunk)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=SCAN_TOL, atol=SCAN_TOL)
        flat = T.linear_scan(torch.from_numpy(a), torch.from_numpy(b))
        np.testing.assert_allclose(got.numpy(), flat.numpy(), rtol=SCAN_TOL, atol=SCAN_TOL)

    def test_chunked_h0_injection(self):
        a = np.full((4,), 0.5, np.float32)
        b = np.ones((4,), np.float32)
        got = T.chunked_linear_scan(torch.from_numpy(a), torch.from_numpy(b), chunk=2, h0=8.0)
        want = _jit["chunked"](jnp.asarray(a), jnp.asarray(b), chunk=2, h0=8.0)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
        np.testing.assert_allclose(got.numpy(), ref_linear_scan(a, b, 8.0), rtol=1e-6)

    def test_chunked_rejects_ragged_length(self):
        with pytest.raises(ValueError, match="divisible"):
            T.chunked_linear_scan(torch.ones(6), torch.ones(6), chunk=4)

    def test_chunked_linear_scan_diag_state(self):
        # The WKV case: h_t = a_t[:, None] * h_{t-1} + b_t, a (Dh, Dh) state.
        rng = np.random.default_rng(9)
        t, dh = 8, 4
        a = rng.uniform(0.5, 1.0, (t, dh)).astype(np.float32)
        b = rng.standard_normal((t, dh, dh)).astype(np.float32)
        h0 = rng.standard_normal((dh, dh)).astype(np.float32)
        got = T.chunked_linear_scan(torch.from_numpy(a), torch.from_numpy(b), chunk=4,
                                    h0=torch.from_numpy(h0), monoid=T.DIAG_STATE)
        want = _jit["chunked"](jnp.asarray(a), jnp.asarray(b), chunk=4, h0=h0,
                              monoid=J.DIAG_STATE)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=SCAN_TOL, atol=SCAN_TOL)


class TestSegmentMonoid:
    @pytest.mark.parametrize("name", ["ELEMENTWISE", "DIAG_STATE"])
    def test_compose_and_apply_match_reference(self, name):
        rng = np.random.default_rng(7)
        dh = 4
        state = (dh,) if name == "ELEMENTWISE" else (dh, dh)
        segs = [(rng.uniform(0.5, 1.0, dh).astype(np.float32),
                 rng.standard_normal(state).astype(np.float32)) for _ in range(3)]
        h0 = rng.standard_normal(state).astype(np.float32)
        tm, jm = getattr(T, name), getattr(J, name)
        tc = tuple(map(torch.from_numpy, segs[0]))
        jc = tuple(map(jnp.asarray, segs[0]))
        for a, b in segs[1:]:
            tc = tm.compose(tc, (torch.from_numpy(a), torch.from_numpy(b)))
            jc = jm.compose(jc, (jnp.asarray(a), jnp.asarray(b)))
        # Elementwise products and sums in one order on both sides.
        _same(tc[0], jc[0])
        np.testing.assert_allclose(tc[1].numpy(), np.asarray(jc[1]), rtol=1e-6, atol=1e-6)
        got = tm.apply(tc, torch.from_numpy(h0))
        h = h0
        for a, b in segs:
            h = (a if name == "ELEMENTWISE" else a[:, None]) * h + b
        np.testing.assert_allclose(got.numpy(), h, rtol=1e-5, atol=1e-5)


class TestScratchpad:
    def test_barrier_returns_inputs_without_a_copy(self):
        x, y = torch.arange(4.0), torch.ones(2)
        assert T.barrier(x) is x
        bx, by = T.barrier(x, y)
        assert bx is x and by is y
        assert T.stage_through_memory(x) is x
        _same(T.barrier(x), J.barrier(jnp.arange(4.0)))

    def test_shared_buffer_flow_and_bytes(self):
        for buf, mk in ((T.SharedBuffer((4,)), torch.arange),
                        (J.SharedBuffer((4,)), jnp.arange)):
            buf.write(mk(4.0)).sync()
            np.testing.assert_array_equal(np.asarray(buf.read()), np.arange(4.0))
            buf.read(slice(1, 3))
            buf.read(2)
            assert (buf.bytes_written, buf.bytes_read) == (16, 16 + 8 + 4)

    def test_shared_buffer_casts_to_its_dtype(self):
        buf = T.SharedBuffer((3,), dtype=torch.bfloat16)
        buf.write(torch.tensor([1.0, 2.0, 3.0])).sync()
        assert buf.read().dtype == torch.bfloat16 and buf.bytes_written == 12

    def test_read_before_sync_raises(self):
        buf = T.SharedBuffer((4,))
        with pytest.raises(RuntimeError):
            buf.sync()
        buf.write(torch.arange(4.0))
        with pytest.raises(RuntimeError, match="before barrier"):
            buf.read()
        with pytest.raises(ValueError):
            buf.write(torch.arange(5.0))


def _cost_fields(costs):
    return [(c.name, c.variant, c.flops, c.traffic.dram_bytes, c.traffic.scratchpad_bytes,
             c.traffic.fabric_bytes, c.energy_pj, c.arithmetic_intensity()) for c in costs]


class TestCostModel:
    @pytest.mark.parametrize("fn,args", [
        ("matmul_traffic", (256, 256, 256)),
        ("matmul_traffic", (255, 1, 255)),
        ("matmul_traffic", (32, 48, 16, 2)),
        ("conv1d_traffic", (65536,)),
        ("conv1d_traffic", (1024, 5, 2)),
        ("scan_traffic", (65536,)),
        ("scan_traffic", (1,)),
        ("scan_traffic", (1000,)),
        ("stencil2d_traffic", (256, 512)),
        ("stencil2d_traffic", (1, 65536, 3)),
        ("reduce_traffic", (65536,)),
        ("reduce_traffic", (64 * 2048,)),
    ])
    def test_equals_reference_field_for_field(self, fn, args):
        assert _cost_fields(getattr(TC, fn)(*args)) == _cost_fields(getattr(JC, fn)(*args))

    def test_traffic_sum_and_energy_table(self):
        assert TC.PJ_PER_BYTE == JC.PJ_PER_BYTE
        t = TC.Traffic(1, 2, 3) + TC.Traffic(10, 20, 30)
        j = JC.Traffic(1, 2, 3) + JC.Traffic(10, 20, 30)
        assert (t.dram_bytes, t.scratchpad_bytes, t.fabric_bytes, t.energy_pj()) == (
            j.dram_bytes, j.scratchpad_bytes, j.fabric_bytes, j.energy_pj())


    @pytest.mark.parametrize("new_tokens,slots,window", [
        ([1, 50], 1, 4),                                  # budget-1 finishes at admission
        ([1, 1, 5], 2, 1),
        ([56, 8, 48, 12, 60, 10, 40, 16], 2, 4),          # ragged: continuous wins
        ([16, 16, 16, 16], 2, 4),                         # uniform: a wash
        ([9, 3, 14, 6, 11], 3, 4),                        # the chaos spec's budgets
    ])
    def test_serve_batch_steps_equal_reference(self, new_tokens, slots, window):
        assert (TC.serve_batch_steps(new_tokens, slots, window)
                == JC.serve_batch_steps(new_tokens, slots, window))

    @pytest.mark.parametrize("prompts,accepted,victim,window", [
        ([5, 12, 7], [3, 0, 9], 2, 4),
        ([5, 12, 7, 3], [9, 3, 14, 6], 0, 1),
        ([8], [0], 0, 2),
    ])
    def test_serve_recovery_steps_equal_reference(self, prompts, accepted, victim, window):
        assert (TC.serve_recovery_steps(prompts, accepted, victim, window)
                == JC.serve_recovery_steps(prompts, accepted, victim, window))

    @pytest.mark.parametrize("fn,args", [
        ("serve_batch_steps", ([], 1, 1)),
        ("serve_batch_steps", ([4], 0, 1)),
        ("serve_recovery_steps", ([1, 2], [1], 0)),
        ("serve_recovery_steps", ([1], [1], 1)),
    ])
    def test_serve_models_refuse_what_the_reference_refuses(self, fn, args):
        with pytest.raises(ValueError):
            getattr(JC, fn)(*args)
        with pytest.raises(ValueError):
            getattr(TC, fn)(*args)


def test_quickstart_matches_reference_script(capsys):
    # The reference quickstart is a script: run it and read its globals
    # (one device here, so it skips its mesh half, which the port leaves to
    # its multi-GPU slice).
    import runpy
    from pathlib import Path

    from repro_torch.examples import quickstart

    ref = runpy.run_path(str(Path(__file__).resolve().parents[1] / "examples" / "quickstart.py"))
    got = quickstart.main(["--device", "cpu"])
    for key in ("left_neighbor", "conv", "sums", "shared_load"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]), err_msg=key)
    assert got["plan"] == T.CascadePlan(18, (16, 2), False)
    assert (ref["plan"].node_deltas, ref["plan"].spilled) == ((16, 2), False)
    assert "forwarded:" in capsys.readouterr().out
