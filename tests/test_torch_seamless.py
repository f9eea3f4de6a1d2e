"""The encoder-decoder arch, seamless-m4t-large-v2, against the reference on
the CPU: the config, the param tree, cross-attention, the encoder, prompt
scoring with frames, and decoding against the encoder's output.

Reduced config (``reduced()``: two encoder and two decoder layers, d_model
128, 4 query heads over 2 KV heads, vocab 512, f32), parameters from the
reference's ``init_params`` through ``convert.params_from_jax`` (one module
fixture), tokens and frame embeddings from numpy with fixed seeds.
Tolerance 1e-4 for logits and states, as for the other archs
(tests/test_torch_archs.py); greedy tokens exactly.
"""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.kernels.local_attention.kernel import flash_attention_pallas
from repro.launch import serve as jax_launcher
from repro.model import attention as JA
from repro.model import layers as JL
from repro.model import model as JM
from repro.model import transformer as JT
from repro.model.sharding import init_mk
from repro.serve import engine as JE
from repro_torch.configs.registry import get_config
from repro_torch.kernels.local_attention import ops as FO
from repro_torch.launch import serve as launcher
from repro_torch.model import attention as A
from repro_torch.model import convert
from repro_torch.model import model as M
from repro_torch.serve import engine as E

jax.config.update("jax_platform_name", "cpu")
# Tiny tensors: one intra-op thread, so parallel test workers do not
# oversubscribe the cores.
torch.set_num_threads(1)

TOL = 1e-4
NAME = "seamless-m4t-large-v2"
FRAMES = 48


@pytest.fixture(scope="module")
def model():
    cfg_j = jax_config(NAME).reduced()
    cfg = get_config(NAME).reduced()
    pj = JM.init_params(cfg_j, jax.random.key(0))
    pt = convert.params_from_jax(jax.tree.map(np.asarray, pj))
    return cfg_j, cfg, pj, pt


def _tok(a):
    return torch.from_numpy(np.asarray(a)).long()


def _tokens(seed, b, t, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (b, t)).astype(np.int32)


def _frames(seed, b, s=FRAMES, d=128):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(np.float32)


def _state_np(state):
    return [np.asarray(x) for x in jax.tree.leaves(convert.state_to_jax_numpy(state))]


def _jax_encode(pj, cfg_j, frames):
    """The reference's encoder half: ``forward``'s lines before the
    decoder (``src/repro/model/model.py``), which hands every decoder block
    this ``enc_out``."""
    enc_cfg = dataclasses.replace(cfg_j, pattern=("attn",), num_experts=0)
    ex, _ = JT.apply_stack(pj["encoder"], jnp.asarray(frames).astype(jnp.float32), enc_cfg,
                           causal=False, num_layers=cfg_j.encoder_layers)
    return JL.rms_norm(pj["enc_final_norm"], ex, cfg_j.norm_eps)


class TestConfig:
    def test_equals_reference_field_for_field(self):
        ours, ref = get_config(NAME), jax_config(NAME)
        assert [f.name for f in dataclasses.fields(ours)] == [
            f.name for f in dataclasses.fields(ref)]
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
        assert dataclasses.asdict(ours.reduced()) == dataclasses.asdict(ref.reduced())
        assert ours.param_count() == ref.param_count() == 1_772_304_384
        assert (ours.num_layers, ours.encoder_layers, ours.d_model, ours.num_heads,
                ours.num_kv_heads, ours.d_ff, ours.vocab_size, ours.padded_vocab) == (
            24, 24, 1024, 16, 16, 8192, 256206, 256256)
        assert ours.is_enc_dec and ours.frontend == "audio"

    def test_param_tree_equals_reference(self, model):
        cfg_j, cfg, pj, pt = model
        ref = jax.tree.map(lambda a: tuple(np.shape(a)), pj)
        assert jax.tree.map(lambda t: tuple(t.shape), M.init_params(cfg, device="cpu")) == ref
        assert set(pt) == {"tok", "final_norm", "decoder", "encoder", "enc_final_norm"}
        assert set(pt["decoder"]["scanned"][0]) == {"attn", "cross", "ffn", "ln1", "ln2",
                                                    "ln_cross"}
        assert set(pt["encoder"]["scanned"][0]) == {"attn", "ffn", "ln1", "ln2"}
        assert pt["decoder"]["scanned"][0]["cross"]["wk"].shape == (2, 128, 2 * 32)
        assert pt["encoder"]["scanned"][0]["attn"]["wq"].shape == (2, 128, 4 * 32)
        for a, b in zip(jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), pt)),
                        jax.tree.leaves(pj)):
            assert np.array_equal(a, np.asarray(b))


class TestCrossAttention:
    def test_cross_layer_matches_reference(self):
        """T = 9 decoder rows against S = 23 memory rows, with the reduced
        config's 4 / 2 heads; a cache passed beside ``x_kv`` is ignored and
        none comes back, as in the reference."""
        cfg_j, cfg = jax_config(NAME).reduced(), get_config(NAME).reduced()
        pj = JA.init_attention(init_mk(jax.random.key(5), jnp.float32), cfg_j, "cross",
                               cross=True)
        pt = convert.params_from_jax(jax.tree.map(np.asarray, pj))
        assert set(pt) == {"wq", "wk", "wv", "wo"}
        rng = np.random.default_rng(5)
        x = rng.standard_normal((2, 9, 128)).astype(np.float32)
        mem = rng.standard_normal((2, 23, 128)).astype(np.float32)
        want, none_j = JA.apply_attention(pj, jnp.asarray(x), cfg_j, x_kv=jnp.asarray(mem),
                                          causal=False)
        got, none_t = A.apply_attention(pt, torch.from_numpy(x), cfg,
                                        x_kv=torch.from_numpy(mem), causal=False)
        assert none_j is None and none_t is None
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
        cache = A.KVCache(torch.zeros(2, 2, 16, 32), torch.zeros(2, 2, 16, 32),
                          torch.zeros(2, dtype=torch.int32))
        again, none = A.apply_attention(pt, torch.from_numpy(x), cfg,
                                        x_kv=torch.from_numpy(mem), kv_cache=cache)
        assert none is None and torch.equal(again, got)
        assert not cache.k.any() and not cache.length.any()

    def test_cross_layer_is_non_causal_whatever_causal_says(self):
        """Cross-attention decides its own mask: with T = S = 12, where a
        causal mask would change every row but the last, ``causal=True``
        and the default give the reference's non-causal output."""
        cfg_j, cfg = jax_config(NAME).reduced(), get_config(NAME).reduced()
        pj = JA.init_attention(init_mk(jax.random.key(6), jnp.float32), cfg_j, "cross",
                               cross=True)
        pt = convert.params_from_jax(jax.tree.map(np.asarray, pj))
        rng = np.random.default_rng(6)
        x = rng.standard_normal((2, 12, 128)).astype(np.float32)
        mem = rng.standard_normal((2, 12, 128)).astype(np.float32)
        want, _ = JA.apply_attention(pj, jnp.asarray(x), cfg_j, x_kv=jnp.asarray(mem),
                                     causal=False)
        for causal in (True, None):
            kw = {} if causal is None else {"causal": causal}
            got, _ = A.apply_attention(pt, torch.from_numpy(x), cfg,
                                       x_kv=torch.from_numpy(mem), **kw)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)

    def test_plain_non_causal_matches_pallas_interpret(self):
        """seamless's heads (16 over 16 KV heads of 64), T = 96 queries
        against S = 160 keys, non-causal: the port's plain version against
        the Pallas kernel in interpret mode."""
        rng = np.random.default_rng(16)
        q = rng.standard_normal((1, 16, 96, 64)).astype(np.float32)
        k, v = (rng.standard_normal((1, 16, 160, 64)).astype(np.float32) for _ in range(2))
        want = np.asarray(flash_attention_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                                 causal=False, interpret=True))
        got = FO.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                 causal=False).numpy()
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


class TestForward:
    def test_encode_matches_reference_encoder(self, model):
        cfg_j, cfg, pj, pt = model
        fr = _frames(1, 2)
        want = np.asarray(_jax_encode(pj, cfg_j, fr))
        got = M.encode(pt, cfg, torch.from_numpy(fr)).numpy()
        assert got.shape == (2, FRAMES, 128)
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)

    def test_logits_match_reference(self, model):
        cfg_j, cfg, pj, pt = model
        toks, fr = _tokens(2, 2, 24), _frames(2, 2)
        want = np.asarray(JM.forward(pj, cfg_j, jnp.asarray(toks),
                                     enc_tokens_embeds=jnp.asarray(fr)))
        got = M.forward(pt, cfg, _tok(toks), enc_tokens_embeds=torch.from_numpy(fr)).numpy()
        assert got.shape == want.shape == (2, 24, cfg.padded_vocab)
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
        # The frames matter: other frames, other logits.
        other = M.forward(pt, cfg, _tok(toks), enc_tokens_embeds=torch.from_numpy(_frames(3, 2)))
        assert np.abs(other.numpy() - got).max() > 1e-2

    @pytest.mark.parametrize("chunks,b", [(1, 2), (2, 4)])
    def test_prefill_step_with_frames_matches_reference(self, model, chunks, b):
        """``make_prefill_step`` with the frames among its extras; at
        ``prefill_chunks=2`` the frames split on axis 0 like the tokens."""
        cfg_j, cfg, pj, pt = model
        cfg_j = dataclasses.replace(cfg_j, prefill_chunks=chunks)
        cfg = dataclasses.replace(cfg, prefill_chunks=chunks)
        toks, fr = _tokens(4, b, 16), _frames(4, b)
        want = np.asarray(JE.make_prefill_step(cfg_j)(pj, jnp.asarray(toks),
                                                      enc_tokens_embeds=jnp.asarray(fr)))
        got = E.make_prefill_step(cfg)(pt, _tok(toks), enc_tokens_embeds=torch.from_numpy(fr))
        np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


class TestDecode:
    def test_chained_decode_matches_reference_and_forward(self, model):
        """A 16-token prompt window at length 0, then 8 chained
        single-token steps, each against the encoder's output: every
        step's logits and the final (converted) KV state against the
        reference's, and the logits against the teacher-forced forward of
        the whole 24 tokens."""
        cfg_j, cfg, pj, pt = model
        b = 2
        toks, fr = _tokens(6, b, 24), _frames(6, b)
        enc_j = _jax_encode(pj, cfg_j, fr)
        enc_t = M.encode(pt, cfg, torch.from_numpy(fr))
        st_j = JM.init_decode_state(cfg_j, b, 32, insert_window=16)
        st_t = M.init_decode_state(cfg, b, 32, 16, device="cpu")
        lj, st_j = JM.decode_step(pj, cfg_j, st_j, jnp.asarray(toks[:, :16]), jnp.int32(0),
                                  enc_out=enc_j)
        lt, st_t = M.decode_step(pt, cfg, st_t, _tok(toks[:, :16]), 0, enc_out=enc_t)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=TOL, atol=TOL)
        steps = [lt]
        step_j = jax.jit(JM.decode_step, static_argnums=(1,))
        for i in range(16, 24):
            lj, st_j = step_j(pj, cfg_j, st_j, jnp.asarray(toks[:, i:i + 1]), jnp.int32(i),
                              enc_out=enc_j)
            lt, st_t = M.decode_step(pt, cfg, st_t, _tok(toks[:, i:i + 1]), i, enc_out=enc_t)
            np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=TOL, atol=TOL)
            steps.append(lt)
        for a, w in zip(_state_np(st_t), jax.tree.leaves(st_j)):
            np.testing.assert_allclose(a, np.asarray(w), rtol=TOL, atol=TOL)
        forced = M.forward(pt, cfg, _tok(toks), enc_tokens_embeds=torch.from_numpy(fr))
        np.testing.assert_allclose(torch.cat(steps, 1).numpy(), forced.numpy(),
                                   rtol=TOL, atol=TOL)

    def test_decode_state_converts_both_ways(self, model):
        """The decode state of the encoder-decoder arch is the decoder's
        KV caches, so ``convert`` carries it as it is: the reference's
        state after a prompt window continues in the port to the
        reference's next logits, and goes back unchanged."""
        cfg_j, cfg, pj, pt = model
        toks, fr = _tokens(8, 2, 13), _frames(8, 2)
        enc_j = _jax_encode(pj, cfg_j, fr)
        st_j = JM.init_decode_state(cfg_j, 2, 32, insert_window=12)
        _, st_j = JM.decode_step(pj, cfg_j, st_j, jnp.asarray(toks[:, :12]), jnp.int32(0),
                                 enc_out=enc_j)
        st_t = convert.state_from_jax(jax.tree.map(np.asarray, st_j,
                                                   is_leaf=lambda x: x is None))
        assert all(isinstance(n, A.KVCache) for n in M.state_nodes(st_t))
        for a, w in zip(_state_np(st_t), jax.tree.leaves(st_j)):
            assert np.array_equal(a, np.asarray(w))
        lj, _ = JM.decode_step(pj, cfg_j, st_j, jnp.asarray(toks[:, 12:]), jnp.int32(12),
                               enc_out=enc_j)
        lt, _ = M.decode_step(pt, cfg, st_t, _tok(toks[:, 12:]), 12,
                              enc_out=M.encode(pt, cfg, torch.from_numpy(fr)))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=TOL, atol=TOL)

    def test_make_decode_step_greedy_matches_reference(self, model):
        """``make_decode_step``: a 16-token prompt window, then 6 greedy
        steps, the argmax fed back on both sides: equal tokens, logits
        within tolerance."""
        cfg_j, cfg, pj, pt = model
        toks, fr = _tokens(9, 2, 16), _frames(9, 2)
        step_j, step_t = JE.make_decode_step(cfg_j), E.make_decode_step(cfg)
        enc_j = _jax_encode(pj, cfg_j, fr)
        enc_t = M.encode(pt, cfg, torch.from_numpy(fr))
        st_j = JM.init_decode_state(cfg_j, 2, 32, insert_window=16)
        st_t = M.init_decode_state(cfg, 2, 32, 16, device="cpu")
        lj, st_j = step_j(pj, st_j, jnp.asarray(toks), jnp.int32(0), enc_j)
        lt, st_t = step_t(pt, st_t, _tok(toks), 0, enc_out=enc_t)
        out_j, out_t = [], []
        for i in range(16, 22):
            np.testing.assert_allclose(lt[:, -1].numpy(), np.asarray(lj[:, -1]),
                                       rtol=TOL, atol=TOL)
            nj = np.asarray(jnp.argmax(lj[:, -1], -1)).astype(np.int32)
            nt = lt[:, -1].argmax(-1)
            out_j.append(nj)
            out_t.append(nt.numpy())
            lj, st_j = step_j(pj, st_j, jnp.asarray(nj[:, None]), jnp.int32(i), enc_j)
            lt, st_t = step_t(pt, st_t, nt[:, None], i, enc_out=enc_t)
        assert np.array_equal(np.stack(out_t), np.stack(out_j))


class TestPadMask:
    def test_padded_columns_are_masked_as_the_reference(self):
        """vocab 500 pads to 512: the 12 padded logit columns read -1e30 in
        the forward and in decoding, as in the reference, and greedy never
        picks them."""
        cfg_j = dataclasses.replace(jax_config(NAME).reduced(), vocab_size=500)
        cfg = dataclasses.replace(get_config(NAME).reduced(), vocab_size=500)
        assert cfg.padded_vocab == 512
        pj = JM.init_params(cfg_j, jax.random.key(3))
        pt = convert.params_from_jax(jax.tree.map(np.asarray, pj))
        toks, fr = _tokens(10, 2, 12, vocab=500), _frames(10, 2)
        want = np.asarray(JM.forward(pj, cfg_j, jnp.asarray(toks),
                                     enc_tokens_embeds=jnp.asarray(fr)))
        got = M.forward(pt, cfg, _tok(toks), enc_tokens_embeds=torch.from_numpy(fr)).numpy()
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
        assert np.all(want[..., 500:] == np.float32(-1e30))
        assert np.all(got[..., 500:] == np.float32(-1e30))
        assert np.all(got[..., :500] > -1e29)
        enc = M.encode(pt, cfg, torch.from_numpy(fr))
        st = M.init_decode_state(cfg, 2, 32, 12, device="cpu")
        logits, st = M.decode_step(pt, cfg, st, _tok(toks), 0, enc_out=enc, last_only=True)
        picked = []
        for i in range(12, 20):
            assert torch.all(logits[..., 500:] == -1e30)
            nxt = logits[:, -1].argmax(-1)
            picked.append(nxt)
            logits, st = M.decode_step(pt, cfg, st, nxt[:, None], i, enc_out=enc)
        assert int(torch.stack(picked).max()) < 500


class TestRefusals:
    def test_engine_refuses_enc_dec(self, model):
        _, cfg, _, pt = model
        with pytest.raises(ValueError, match="make_decode_step"):
            E.ServeEngine(cfg, pt, device="cpu")

    def test_launcher_refusal_equals_reference(self, monkeypatch, capsys):
        argv = ["--arch", NAME, "--smoke"]
        monkeypatch.setattr(sys, "argv", ["serve"] + argv)
        with pytest.raises(SystemExit) as want:
            jax_launcher.main()
        capsys.readouterr()
        with pytest.raises(SystemExit) as got:
            launcher.main(argv + ["--device", "cpu"])
        assert str(got.value) == str(want.value) == (
            "enc-dec serving demo: use examples/serve_decode.py")
        # The port names its own enc-dec decode entry beside the reference's text.
        err = capsys.readouterr().err
        assert "make_decode_step" in err and "encode" in err

    def test_forward_and_decode_need_the_frames(self, model):
        _, cfg, _, pt = model
        toks = _tok(_tokens(11, 1, 4))
        with pytest.raises(ValueError, match="enc_tokens_embeds"):
            M.forward(pt, cfg, toks)
        with pytest.raises(ValueError, match="enc_out"):
            M.decode_step(pt, cfg, M.init_decode_state(cfg, 1, 8, 4, device="cpu"), toks, 0)
