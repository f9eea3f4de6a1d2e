"""The port's Gemma3-1B against the reference's, on the CPU.

Reduced config: 12 layers (two periods of five ``local`` layers and one
``global``), d_model 128, four 32-wide query heads over one KV head, window
64, vocab 512, f32; parameters from the reference's ``init_params``
through ``convert.params_from_jax``, tokens from numpy with fixed seeds.

The state of Gemma3 is attention only: local layers keep a ring of
window + K - 1 slots, global layers every position up to ``max_len``.
Tolerance 1e-4 for logits and states, as for the other archs
(tests/test_torch_model.py); greedy tokens exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.model import model as JM
from repro.serve import engine as JE
from repro_torch.configs.registry import get_config
from repro_torch.launch import serve as launcher
from repro_torch.model import convert
from repro_torch.model import model as M
from repro_torch.model.attention import KVCache
from repro_torch.serve import engine as E

jax.config.update("jax_platform_name", "cpu")
# Tiny tensors: one intra-op thread, so parallel test workers do not
# oversubscribe the cores.
torch.set_num_threads(1)

TOL = 1e-4


@pytest.fixture(scope="module")
def g3():
    cfg_j = jax_config("gemma3-1b").reduced()
    cfg = get_config("gemma3-1b").reduced()
    pj = JM.init_params(cfg_j, jax.random.key(0))
    pt = convert.params_from_jax(jax.tree.map(np.asarray, pj))
    return cfg_j, cfg, pj, pt


def _tok(a):
    return torch.from_numpy(np.asarray(a)).long()


def _state_np(state):
    return [np.asarray(x) for x in jax.tree.leaves(convert.state_to_jax_numpy(state))]


def _prompts(seed, b, p, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (b, p)).astype(np.int32)


class TestConfig:
    def test_equals_reference_field_for_field(self):
        ours, ref = get_config("gemma3-1b"), jax_config("gemma3-1b")
        fields = [f.name for f in dataclasses.fields(ref)]
        assert [f.name for f in dataclasses.fields(ours)] == fields
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
        assert dataclasses.asdict(ours.reduced()) == dataclasses.asdict(ref.reduced())
        assert ours.param_count() == ref.param_count()

    def test_layer_plan(self, g3):
        from repro_torch.model import transformer as tf

        full = get_config("gemma3-1b")
        assert tf.plan_groups(full) == (full.pattern, 4, ("local", "local"))
        assert full.layer_kinds.count("global") == 4
        _, cfg, _, _ = g3
        assert tf.plan_groups(cfg) == (cfg.pattern, 2, ())
        assert (cfg.num_layers, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                cfg.attn_window) == (12, 4, 1, 32, 64)

    def test_param_layout_matches_reference(self, g3):
        cfg_j, cfg, pj, _ = g3
        ref = jax.tree.map(lambda a: tuple(np.shape(a)), pj)
        assert jax.tree.map(lambda t: tuple(t.shape), M.init_params(cfg, device="cpu")) == ref
        assert "unembed" not in M.init_params(cfg, device="cpu")["tok"]     # tied


class TestForward:
    @pytest.mark.parametrize("t", [8, 100])
    def test_logits_match_reference(self, g3, t):
        cfg_j, cfg, pj, pt = g3
        toks = _prompts(t, 2, t)
        want = np.asarray(JM.forward(pj, cfg_j, jnp.asarray(toks)))
        got = M.forward(pt, cfg, _tok(toks)).numpy()
        assert got.shape == want.shape == (2, t, cfg.padded_vocab)
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)

    def test_prefill_step_logits_match_reference(self, g3):
        cfg_j, cfg, pj, pt = g3
        toks = _prompts(3, 2, 90)
        want = np.asarray(JE.make_prefill_step(cfg_j)(pj, jnp.asarray(toks)))
        got = E.make_prefill_step(cfg)(pt, _tok(toks)).numpy()
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


class TestDecode:
    @pytest.mark.parametrize("kw", [4, 32])
    def test_chained_windows_wrap_the_local_rings(self, g3, kw):
        """A 100-token prompt, then more windows, fed K tokens at a time:
        the local rings (window + K - 1 slots) wrap, the global layers hold
        every position.  Row 1 is ragged in the first window, the last row
        frozen in the second."""
        cfg_j, cfg, pj, pt = g3
        b, max_len = 3, 192
        rng = np.random.default_rng(kw)
        st_j = JM.init_decode_state(cfg_j, b, max_len, insert_window=kw)
        st_t = M.init_decode_state(cfg, b, max_len, kw, device="cpu")
        step_j = jax.jit(JM.decode_step, static_argnums=(1,),
                         static_argnames=("last_only", "max_len"))
        lengths = np.zeros(b, np.int32)
        for i in range(-(-130 // kw)):
            toks = rng.integers(0, cfg.vocab_size, (b, kw)).astype(np.int32)
            mask = np.ones((b, kw), bool)
            if i == 0:
                mask[1, 3:] = False
            if i == 1:
                mask[b - 1] = False
            lj, st_j = step_j(pj, cfg_j, st_j, jnp.asarray(toks), jnp.asarray(lengths),
                              token_mask=jnp.asarray(mask), max_len=max_len)
            lt, st_t = M.decode_step(pt, cfg, st_t, _tok(toks), torch.from_numpy(lengths),
                                     token_mask=torch.from_numpy(mask), max_len=max_len)
            np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=TOL, atol=TOL)
            lengths = lengths + mask.sum(1).astype(np.int32)
        for a, w in zip(_state_np(st_t), jax.tree.leaves(st_j)):
            np.testing.assert_allclose(a, np.asarray(w), rtol=TOL, atol=TOL)
        local, glob = st_t["scanned"][0], st_t["scanned"][5]
        assert local.k.shape[-2] == cfg.attn_window + kw - 1 < int(lengths.min())
        assert glob.k.shape[-2] == max_len and int(lengths[0]) > 100 > cfg.attn_window

    def test_frozen_slot_is_bit_identical(self, g3):
        _, cfg, _, pt = g3
        rng = np.random.default_rng(0)
        st = M.init_decode_state(cfg, 2, 96, 8, device="cpu")
        M.decode_step(pt, cfg, st, _tok(rng.integers(0, 512, (2, 5))), 0, max_len=96)
        before = _state_np(st)
        mask = torch.tensor([[True] * 8, [False] * 8])
        M.decode_step(pt, cfg, st, _tok(rng.integers(0, 512, (2, 8))), torch.tensor([5, 5]),
                      token_mask=mask, max_len=96)
        for a, b in zip(_state_np(st), before):
            assert np.array_equal(a[:, 1], b[:, 1])
            assert not np.array_equal(a[:, 0], b[:, 0])
        assert all(isinstance(n, KVCache) for n in M.state_nodes(st))


class TestServe:
    @pytest.mark.parametrize("p,lens,k", [
        (100, None, 4),           # the global layers hold more than the window
        (12, (12, 7, 3), 8),      # ragged prompts
    ])
    def test_generate_greedy_equals_reference(self, g3, p, lens, k):
        cfg_j, cfg, pj, pt = g3
        prompts = _prompts(p, 3, p)
        lj = None if lens is None else jnp.asarray(lens)
        want = JE.ServeEngine(cfg_j, pj, max_len=128, decode_window=k).generate(
            jnp.asarray(prompts), 12, prompt_lengths=lj)
        eng = E.ServeEngine(cfg, pt, max_len=128, decode_window=k, device="cpu")
        got = eng.generate(prompts, 12, prompt_lengths=lens)
        assert np.array_equal(got.numpy(), np.asarray(want))
        assert eng.last_decode_dispatches == -(-12 // k)

    @pytest.mark.parametrize("slots,k", [(2, 2), (3, 4)])
    def test_serve_greedy_equals_reference(self, g3, slots, k):
        cfg_j, cfg, pj, pt = g3
        rng = np.random.default_rng(slots)
        reqs = [(rng.integers(0, cfg.vocab_size, (int(rng.integers(4, 40)),)).astype(np.int32),
                 int(rng.integers(2, 12))) for _ in range(5)]
        want = JE.ServeEngine(cfg_j, pj, max_len=96, decode_window=k).serve(
            [JE.Request(tokens=t, max_new_tokens=n) for t, n in reqs], slots=slots)
        eng = E.ServeEngine(cfg, pt, max_len=96, decode_window=k, device="cpu")
        got = eng.serve([E.Request(tokens=t, max_new_tokens=n) for t, n in reqs], slots=slots)
        for w, g, (_, n) in zip(want, got, reqs):
            assert g.outcome == w.outcome == "ok" and g.size == n
            assert np.array_equal(np.asarray(g), np.asarray(w))
        assert bool(M.decode_state_finite(eng.last_state).all())

    @pytest.mark.parametrize("extra", [
        ["--batch", "2", "--prompt-len", "70", "--new-tokens", "5"],
        ["--continuous", "--requests", "5", "--slots", "2", "--prompt-len", "8",
         "--new-tokens", "6", "--max-len", "64", "--decode-window", "2"],
    ])
    def test_launcher_smoke_on_cpu_exits_zero(self, extra, capsys):
        launcher.main(["--arch", "gemma3-1b", "--smoke", "--device", "cpu", *extra])
        assert "tok/s" in capsys.readouterr().out
