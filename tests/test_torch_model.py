"""The port's reduced RWKV6 model against the reference's, on the CPU.

Parameters come from the reference's ``init_params`` through
``convert.params_from_jax``; token inputs come from numpy with a fixed
seed.  Reduced config: 2 layers, d_model 128, two 64-wide WKV heads, f32.

Tolerances, measured on this tree: logits differ from the reference by at
most 2e-5 at a logit scale of about 4 (forward, T <= 80) and 4e-6 across
chained decode windows; decode states by at most 1e-5.  The reference
drifts from itself by about 1e-6 across batch shapes, so 1e-4 is stated
for logits and states alike.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.model import model as JM
from repro_torch.configs.registry import get_config
from repro_torch.model import convert
from repro_torch.model import model as M

jax.config.update("jax_platform_name", "cpu")
# Tiny tensors: one intra-op thread, so parallel test workers do not
# oversubscribe the cores.
torch.set_num_threads(1)

TOL = 1e-4


@pytest.fixture(scope="module")
def setup():
    cfg_j = jax_config("rwkv6-1.6b").reduced()
    cfg = get_config("rwkv6-1.6b").reduced()
    pj = JM.init_params(cfg_j, jax.random.key(0))
    pt = convert.params_from_jax(jax.tree.map(np.asarray, pj))
    return cfg_j, cfg, pj, pt


def _leaves_np(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _state_np(state):
    return _leaves_np(convert.state_to_jax_numpy(state))


def _tok(a):
    return torch.from_numpy(np.asarray(a)).long()


class TestParams:
    def test_layout_matches_reference(self, setup):
        cfg_j, cfg, pj, pt = setup
        ours = M.init_params(cfg, seed=0, device="cpu")
        ref = jax.tree.map(np.asarray, pj)
        shapes = jax.tree.map(lambda a: tuple(a.shape), ref)
        assert jax.tree.map(lambda t: tuple(t.shape), ours) == shapes
        assert jax.tree.map(lambda t: tuple(t.shape), pt) == shapes

    def test_init_is_seeded(self, setup):
        _, cfg, _, _ = setup
        a, b = (M.init_params(cfg, seed=3, device="cpu") for _ in range(2))
        c = M.init_params(cfg, seed=4, device="cpu")
        emb = lambda p: p["tok"]["embedding"]  # noqa: E731
        assert torch.equal(emb(a), emb(b)) and not torch.equal(emb(a), emb(c))


class TestForward:
    @pytest.mark.parametrize("t", [8, 17, 80])
    def test_logits_match_reference(self, setup, t):
        cfg_j, cfg, pj, pt = setup
        toks = np.random.default_rng(t).integers(0, cfg.vocab_size, (2, t)).astype(np.int32)
        want = np.asarray(JM.forward(pj, cfg_j, jnp.asarray(toks)))
        got = M.forward(pt, cfg, _tok(toks)).numpy()
        assert got.shape == want.shape == (2, t, cfg.padded_vocab)
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def _windows(rng, cfg, b, kw, n_windows):
    """Token windows and prefix masks: row 0 always full, row 1 ragged in
    the first window (a 3-token prefix), the last row masked out of the
    second window entirely (a frozen slot)."""
    out = []
    for i in range(n_windows):
        toks = rng.integers(0, cfg.vocab_size, (b, kw)).astype(np.int32)
        mask = np.ones((b, kw), bool)
        if i == 0:
            mask[1, min(3, kw):] = False
        if i == 1:
            mask[b - 1] = False
        out.append((toks, mask))
    return out


class TestDecode:
    @pytest.mark.parametrize("kw", [1, 4, 8])
    def test_chained_windows_match_reference(self, setup, kw):
        cfg_j, cfg, pj, pt = setup
        b = 3
        rng = np.random.default_rng(kw)
        st_j = JM.init_decode_state(cfg_j, b, 64)
        st_t = M.init_decode_state(cfg, b, 64, device="cpu")
        lengths = np.zeros(b, np.int32)
        for toks, mask in _windows(rng, cfg, b, kw, 3):
            lj, st_j = JM.decode_step(
                pj, cfg_j, st_j, jnp.asarray(toks), jnp.asarray(lengths),
                token_mask=jnp.asarray(mask), last_only=True)
            lt, st_t = M.decode_step(
                pt, cfg, st_t, _tok(toks), torch.from_numpy(lengths),
                token_mask=torch.from_numpy(mask), last_only=True)
            np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=TOL, atol=TOL)
            for a, w in zip(_state_np(st_t), _leaves_np(st_j)):
                np.testing.assert_allclose(a, w, rtol=TOL, atol=TOL)
            lengths = lengths + mask.sum(1).astype(np.int32)

    def test_full_window_logits(self, setup):
        cfg_j, cfg, pj, pt = setup
        toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 6)).astype(np.int32)
        lj, _ = JM.decode_step(pj, cfg_j, JM.init_decode_state(cfg_j, 2, 64),
                               jnp.asarray(toks), jnp.int32(0))
        lt, _ = M.decode_step(pt, cfg, M.init_decode_state(cfg, 2, 64, device="cpu"),
                              _tok(toks), 0)
        assert lt.shape == (2, 6, cfg.padded_vocab)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=TOL, atol=TOL)

    @pytest.mark.parametrize("kw", [1, 8, 40, 100])
    def test_frozen_slot_is_bit_identical(self, setup, kw):
        _, cfg, _, pt = setup
        rng = np.random.default_rng(0)
        st = M.init_decode_state(cfg, 2, 256, device="cpu")
        _, st = M.decode_step(pt, cfg, st, _tok(rng.integers(0, 512, (2, 5))), 0)
        before = [a.copy() for a in _state_np(st)]
        mask = torch.zeros((2, kw), dtype=torch.bool)
        mask[0] = True
        _, st = M.decode_step(pt, cfg, st, _tok(rng.integers(0, 512, (2, kw))), 5,
                              token_mask=mask)
        after = _state_np(st)
        for a, b in zip(after, before):
            assert np.array_equal(a[:, 1], b[:, 1])      # slot 1 frozen
            assert not np.array_equal(a[:, 0], b[:, 0])  # slot 0 moved

    def test_lengths_shape_is_checked(self, setup):
        _, cfg, _, pt = setup
        st = M.init_decode_state(cfg, 2, 64, device="cpu")
        with pytest.raises(ValueError):
            M.decode_step(pt, cfg, st, _tok(np.zeros((2, 1))), torch.zeros(3))


class TestStateConversion:
    def test_round_trip_and_handoff(self, setup):
        cfg_j, cfg, pj, pt = setup
        rng = np.random.default_rng(11)
        toks = rng.integers(0, cfg.vocab_size, (2, 7)).astype(np.int32)
        st = M.init_decode_state(cfg, 2, 64, device="cpu")
        _, st = M.decode_step(pt, cfg, st, _tok(toks), 0)
        # Port -> numpy -> port is exact.
        back = convert.state_from_jax(convert.state_to_jax_numpy(st))
        for a, b in zip(_state_np(back), _state_np(st)):
            assert np.array_equal(a, b)
        # Hand the port's state to the reference mid-stream and continue
        # both for one more window.
        treedef = jax.tree.structure(JM.init_decode_state(cfg_j, 2, 64))
        st_j = jax.tree.unflatten(treedef, [jnp.asarray(a) for a in _state_np(st)])
        nxt = rng.integers(0, cfg.vocab_size, (2, 3)).astype(np.int32)
        lj, st_j = JM.decode_step(pj, cfg_j, st_j, jnp.asarray(nxt), jnp.int32(7))
        lt, st = M.decode_step(pt, cfg, st, _tok(nxt), 7)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=TOL, atol=TOL)
        # And back: the reference's state converts into the port's.
        st_from = convert.state_from_jax(jax.tree.map(np.asarray, st_j))
        for a, b in zip(_state_np(st_from), _state_np(st)):
            np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)

    def test_numpy_state_is_a_copy(self, setup):
        """The port updates its state in place; the numpy tree handed to
        the reference must not change with it (JAX may wrap a numpy array
        without copying, so a view would change under a pending step)."""
        _, cfg, _, pt = setup
        st = M.init_decode_state(cfg, 2, 64, device="cpu")
        snap = convert.state_to_jax_numpy(st)
        before = [a.copy() for a in _leaves_np(snap)]
        M.decode_step(pt, cfg, st, _tok(np.ones((2, 3))), 0)
        assert all(np.array_equal(a, b) for a, b in zip(_leaves_np(snap), before))
        assert not all(np.array_equal(a, b) for a, b in zip(_state_np(st), before))

    def test_decode_state_finite_flags_one_slot(self, setup):
        _, cfg, _, _ = setup
        st = M.init_decode_state(cfg, 3, 64, device="cpu")
        assert M.decode_state_finite(st).tolist() == [True, True, True]
        st["scanned"][0].h[1, 2, 0, 5, 5] = float("nan")
        assert M.decode_state_finite(st).tolist() == [True, True, False]


# ---------------------------------------------------------------------------
# RecurrentGemma (reduced: 6 layers of (rec, rec, local), d_model 128, four
# 32-wide query heads over one KV head, window 64, f32).  The same 1e-4:
# measured errors are below 2e-6 in logits and 5e-6 in states.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rg():
    cfg_j = jax_config("recurrentgemma-2b").reduced()
    cfg = get_config("recurrentgemma-2b").reduced()
    pj = JM.init_params(cfg_j, jax.random.key(0))
    pt = convert.params_from_jax(jax.tree.map(np.asarray, pj))
    return cfg_j, cfg, pj, pt


class TestRecurrentGemma:
    def test_layout_and_param_count_match_reference(self, rg):
        cfg_j, cfg, pj, pt = rg
        ref = jax.tree.map(lambda a: tuple(np.shape(a)), pj)
        assert jax.tree.map(lambda t: tuple(t.shape), M.init_params(cfg, device="cpu")) == ref
        full_j = jax_config("recurrentgemma-2b")
        assert get_config("recurrentgemma-2b").param_count() == full_j.param_count()

    @pytest.mark.parametrize("t", [80, 200])
    def test_forward_matches_reference(self, rg, t):
        cfg_j, cfg, pj, pt = rg
        toks = np.random.default_rng(t).integers(0, cfg.vocab_size, (2, t)).astype(np.int32)
        want = np.asarray(JM.forward(pj, cfg_j, jnp.asarray(toks)))
        got = M.forward(pt, cfg, _tok(toks)).numpy()
        assert got.shape == want.shape == (2, t, cfg.padded_vocab)
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)

    @pytest.mark.parametrize("kw", [1, 4, 8])
    def test_chained_windows_wrap_the_ring(self, rg, kw):
        """Windows up to T=90 through a local ring of window + K - 1 slots
        (so it wraps), row 1 ragged and the last row frozen early on."""
        cfg_j, cfg, pj, pt = rg
        b, max_len = 3, 128
        rng = np.random.default_rng(kw)
        st_j = JM.init_decode_state(cfg_j, b, max_len, insert_window=kw)
        st_t = M.init_decode_state(cfg, b, max_len, kw, device="cpu")
        lengths = np.zeros(b, np.int32)
        # One compiled reference step for the whole stream.
        step_j = jax.jit(JM.decode_step, static_argnums=(1,),
                         static_argnames=("last_only", "max_len"))
        for toks, mask in _windows(rng, cfg, b, kw, -(-90 // kw)):
            lj, st_j = step_j(pj, cfg_j, st_j, jnp.asarray(toks), jnp.asarray(lengths),
                              token_mask=jnp.asarray(mask), last_only=True, max_len=max_len)
            lt, st_t = M.decode_step(pt, cfg, st_t, _tok(toks), torch.from_numpy(lengths),
                                     token_mask=torch.from_numpy(mask), last_only=True,
                                     max_len=max_len)
            np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=TOL, atol=TOL)
            lengths = lengths + mask.sum(1).astype(np.int32)
        for a, w in zip(_state_np(st_t), _leaves_np(st_j)):
            np.testing.assert_allclose(a, w, rtol=TOL, atol=TOL)
        assert int(lengths[0]) >= 90 > cfg.attn_window + kw - 1

    @pytest.mark.parametrize("kw", [1, 8, 40, 100])
    def test_frozen_slot_is_bit_identical(self, rg, kw):
        _, cfg, _, pt = rg
        rng = np.random.default_rng(0)
        st = M.init_decode_state(cfg, 2, 256, max(kw, 5), device="cpu")
        _, st = M.decode_step(pt, cfg, st, _tok(rng.integers(0, 512, (2, 5))), 0, max_len=256)
        before = [a.copy() for a in _state_np(st)]
        mask = torch.zeros((2, kw), dtype=torch.bool)
        mask[0] = True
        _, st = M.decode_step(pt, cfg, st, _tok(rng.integers(0, 512, (2, kw))),
                              torch.tensor([5, 5]), token_mask=mask, max_len=256)
        after = _state_np(st)
        for a, b in zip(after, before):
            assert np.array_equal(a[:, 1], b[:, 1])      # slot 1 frozen
            assert not np.array_equal(a[:, 0], b[:, 0])  # slot 0 moved

    def test_kv_state_handoff_both_ways(self, rg):
        cfg_j, cfg, pj, pt = rg
        rng = np.random.default_rng(11)
        toks = rng.integers(0, cfg.vocab_size, (2, 70)).astype(np.int32)
        st = M.init_decode_state(cfg, 2, 128, 8, device="cpu")
        for i in range(0, 70, 7):                          # 70 tokens: the ring wraps
            _, st = M.decode_step(pt, cfg, st, _tok(toks[:, i:i + 7]), i, max_len=128)
        assert isinstance(st["scanned"][2], M.KVCache)
        back = convert.state_from_jax(convert.state_to_jax_numpy(st))
        for a, b in zip(_state_np(back), _state_np(st)):
            assert np.array_equal(a, b)
        # The port's state continues in the reference, and the reference's
        # state comes back into the port.
        treedef = jax.tree.structure(JM.init_decode_state(cfg_j, 2, 128, insert_window=8))
        st_j = jax.tree.unflatten(treedef, [jnp.asarray(a) for a in _state_np(st)])
        nxt = rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
        lj, st_j = JM.decode_step(pj, cfg_j, st_j, jnp.asarray(nxt), jnp.int32(70), max_len=128)
        lt, st = M.decode_step(pt, cfg, st, _tok(nxt), 70, max_len=128)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=TOL, atol=TOL)
        st_from = convert.state_from_jax(jax.tree.map(np.asarray, st_j))
        for a, b in zip(_state_np(st_from), _state_np(st)):
            np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)

    @pytest.mark.parametrize("insert_window,t,max_len", [(1, 8, None), (4, 8, None),
                                                         (8, 8, None), (1, 8, 64), (1, 1, None)])
    def test_ring_slack_check_raises_where_reference_raises(self, rg, insert_window, t, max_len):
        cfg_j, cfg, pj, pt = rg
        toks = np.zeros((1, t), np.int32)

        def run_ref():
            st = JM.init_decode_state(cfg_j, 1, 128, insert_window=insert_window)
            JM.decode_step(pj, cfg_j, st, jnp.asarray(toks), jnp.int32(0), max_len=max_len)

        def run_port():
            st = M.init_decode_state(cfg, 1, 128, insert_window, device="cpu")
            M.decode_step(pt, cfg, st, _tok(toks), 0, max_len=max_len)

        outcomes = []
        for run in (run_ref, run_port):
            try:
                run()
                outcomes.append("ok")
            except ValueError as e:
                assert "would wrap the local-attention ring" in str(e)
                outcomes.append("raised")
        assert outcomes[0] == outcomes[1]
        assert outcomes[0] == ("raised" if (insert_window, max_len) in ((1, None), (4, None))
                               and t > 1 else "ok")

    def test_decode_state_finite_skips_kv_caches(self, rg):
        _, cfg, _, _ = rg
        st = M.init_decode_state(cfg, 3, 64, device="cpu")
        st["scanned"][2].k[0, 1] = float("nan")          # KV caches are not scanned
        assert M.decode_state_finite(st).tolist() == [True, True, True]
        st["scanned"][0].h[1, 2, 5] = float("nan")
        assert M.decode_state_finite(st).tolist() == [True, True, False]


# ---------------------------------------------------------------------------
# Slot health: decode_state_finite and decode_state_checksum against the
# reference on reduced states of every ported arch (Gemma3's holds only KV
# caches), with random leaves from a numpy seed.  Both are exact: flags and
# integer sums of raw bits.
# ---------------------------------------------------------------------------

HEALTH_ARCHS = ["rwkv6-1.6b", "recurrentgemma-2b", "gemma3-1b"]


def _random_state(arch, dtype, batch=3, seed=0):
    """A port state and the same state as the reference's tree, every leaf
    random: floats N(0, 1) in the config's dtype, lengths in [0, 64)."""
    import dataclasses

    cfg = dataclasses.replace(get_config(arch).reduced(), dtype=dtype)
    cfg_j = dataclasses.replace(jax_config(arch).reduced(), dtype=dtype)
    rng = np.random.default_rng(seed)
    st = M.init_decode_state(cfg, batch, 64, device="cpu")
    for node in M.state_nodes(st):
        for leaf in node:
            if leaf.dtype.is_floating_point:
                leaf.copy_(torch.from_numpy(rng.standard_normal(tuple(leaf.shape))))
            else:
                leaf.copy_(torch.from_numpy(rng.integers(0, 64, tuple(leaf.shape))))
    return st, cfg_j


def _to_ref(st, cfg_j, batch=3):
    treedef = jax.tree.structure(JM.init_decode_state(cfg_j, batch, 64))
    return jax.tree.unflatten(treedef, [jnp.asarray(a) for a in _state_np(st)])


class TestStateHealth:
    @pytest.mark.parametrize("arch", HEALTH_ARCHS)
    def test_decode_state_finite_equals_reference(self, arch):
        st, cfg_j = _random_state(arch, "float32")
        want = np.asarray(JM.decode_state_finite(_to_ref(st, cfg_j)))
        assert M.decode_state_finite(st).tolist() == want.tolist() == [True] * 3
        # Slot 1 of the first (stacked) node's h, or of its K where the
        # state is attention-only.
        M.state_nodes(st)[0][0][0, 1] = float("nan")
        want = np.asarray(JM.decode_state_finite(_to_ref(st, cfg_j)))
        got = M.decode_state_finite(st)
        assert got.dtype == torch.bool and got.tolist() == want.tolist()
        # A KV cache is never scanned: Gemma3's flags stay all True.
        assert got.tolist() == ([True] * 3 if arch == "gemma3-1b" else [True, False, True])

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("arch", HEALTH_ARCHS)
    def test_decode_state_checksum_bit_equal_to_reference(self, arch, dtype):
        from repro.serve import chaos as JCH
        from repro_torch.serve import chaos as CH

        st, cfg_j = _random_state(arch, dtype, seed=len(arch))
        st_j = _to_ref(st, cfg_j)
        want = np.asarray(JM.decode_state_checksum(st_j))
        got = M.decode_state_checksum(st)
        assert want.dtype == np.uint32 and got.dtype == torch.int64
        assert int(got.min()) >= 0 and int(got.max()) < 2**32
        assert np.array_equal(got.numpy().astype(np.uint32), want)
        # One flipped bit in slot 1 moves slot 1's sum only, as in the reference.
        CH.bitflip_slot_state(st, 1)
        flipped = M.decode_state_checksum(st).numpy()
        want_flipped = np.asarray(JM.decode_state_checksum(JCH.bitflip_slot_state(st_j, 1)))
        assert np.array_equal(flipped.astype(np.uint32), want_flipped)
        assert (flipped != got.numpy()).tolist() == [False, True, False]
