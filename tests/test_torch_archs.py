"""The six decoder-only archs of the port's last serving slice against the
reference's, on the CPU: qwen2-0.5b (QKV bias), minitron-8b and
nemotron-4-15b (the squared-ReLU MLP), qwen2-vl-7b (M-RoPE and the stub
vision frontend), dbrx-132b and qwen3-moe-235b-a22b (the MoE layer, q/k
norms, chunked prompt scoring).

Reduced configs (``reduced()``: two layers, d_model 128, vocab 512, f32;
the MoE archs four experts top-2), parameters from the reference's
``init_params`` through ``convert.params_from_jax`` (one module fixture
per arch), tokens, patch embeddings and positions from numpy with fixed
seeds.  Tolerance 1e-4 for logits and states, as for the other archs
(tests/test_torch_model.py); greedy tokens exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.kernels.local_attention.kernel import flash_attention_pallas
from repro.model import attention as JA
from repro.model import layers as JL
from repro.model import model as JM
from repro.model.sharding import init_mk
from repro.serve import engine as JE
from repro_torch.configs.registry import get_config
from repro_torch.kernels.local_attention import ops as FO
from repro_torch.launch import serve as launcher
from repro_torch.model import attention as A
from repro_torch.model import convert
from repro_torch.model import layers as L
from repro_torch.model import model as M
from repro_torch.serve import engine as E

jax.config.update("jax_platform_name", "cpu")
# Tiny tensors: one intra-op thread, so parallel test workers do not
# oversubscribe the cores.
torch.set_num_threads(1)

TOL = 1e-4
ARCHS = ("qwen2-0.5b", "minitron-8b", "nemotron-4-15b", "qwen2-vl-7b", "dbrx-132b",
         "qwen3-moe-235b-a22b")
MOE_ARCHS = ("dbrx-132b", "qwen3-moe-235b-a22b")


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    cfg_j = jax_config(request.param).reduced()
    cfg = get_config(request.param).reduced()
    pj = JM.init_params(cfg_j, jax.random.key(0))
    pt = convert.params_from_jax(jax.tree.map(np.asarray, pj))
    return cfg_j, cfg, pj, pt


def _tok(a):
    return torch.from_numpy(np.asarray(a)).long()


def _prompts(seed, b, p, vocab=512):
    return np.random.default_rng(seed).integers(0, vocab, (b, p)).astype(np.int32)


def _vision_inputs(cfg, b, t, seed):
    """Patch embeddings for the first t // 4 positions and (3, B, T) M-RoPE
    positions: text positions on all three streams, a 2-D grid (row,
    column) on the height and width streams of the image patches."""
    rng = np.random.default_rng(seed)
    s_f = t // 4
    fe = rng.standard_normal((b, s_f, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(t, dtype=np.int32), (3, b, t)).copy()
    pos[1, :, :s_f] = np.arange(s_f) // 4
    pos[2, :, :s_f] = np.arange(s_f) % 4
    pos[0, :, :s_f] = 0
    return fe, pos


def _extras(cfg, b, t, seed):
    """(reference kwargs, port kwargs) of a forward: the vision arch's
    frontend embeddings and 3-D positions, nothing for the text archs."""
    if cfg.frontend != "vision":
        return {}, {}
    fe, pos = _vision_inputs(cfg, b, t, seed)
    return ({"frontend_embeds": jnp.asarray(fe), "positions": jnp.asarray(pos)},
            {"frontend_embeds": torch.from_numpy(fe), "positions": torch.from_numpy(pos)})


def _state_np(state):
    return [np.asarray(x) for x in jax.tree.leaves(convert.state_to_jax_numpy(state))]


class TestConfig:
    @pytest.mark.parametrize("name", ARCHS)
    def test_equals_reference_field_for_field(self, name):
        ours, ref = get_config(name), jax_config(name)
        assert [f.name for f in dataclasses.fields(ours)] == [
            f.name for f in dataclasses.fields(ref)]
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
        assert dataclasses.asdict(ours.reduced()) == dataclasses.asdict(ref.reduced())
        assert ours.param_count() == ref.param_count()
        assert ours.active_param_count() == ref.active_param_count()

    def test_exact_assignment_numbers(self):
        expect = {
            "qwen2-vl-7b": (28, 3584, 28, 4, 18944, 152064),
            "dbrx-132b": (40, 6144, 48, 8, 10752, 100352),
            "qwen3-moe-235b-a22b": (94, 4096, 64, 4, 1536, 151936),
            "minitron-8b": (32, 4096, 32, 8, 16384, 256000),
            "nemotron-4-15b": (32, 6144, 48, 8, 24576, 256000),
            "qwen2-0.5b": (24, 896, 14, 2, 4864, 151936),
        }
        for name, want in expect.items():
            c = get_config(name)
            assert (c.num_layers, c.d_model, c.num_heads, c.num_kv_heads, c.d_ff,
                    c.vocab_size) == want, name
        assert 14e9 <= get_config("qwen3-moe-235b-a22b").active_param_count() <= 30e9
        assert get_config("seamless-m4t-large-v2").param_count() == 1_772_304_384

    def test_param_layout_and_conversion(self, arch):
        cfg_j, cfg, pj, pt = arch
        ref = jax.tree.map(lambda a: tuple(np.shape(a)), pj)
        assert jax.tree.map(lambda t: tuple(t.shape), M.init_params(cfg, device="cpu")) == ref
        got = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), pt))
        for a, b in zip(got, jax.tree.leaves(pj)):
            assert np.array_equal(a, np.asarray(b))
        blk = pt["decoder"]["scanned"][0]
        if cfg.num_experts:
            assert blk["ffn"]["w_up"].shape == (cfg.num_layers, cfg.num_experts, 128, 256)
        elif cfg.mlp_type == "relu2":
            assert set(blk["ffn"]) == {"w_up", "w_down"}
        assert ("bq" in blk["attn"]) == cfg.qkv_bias
        assert ("q_norm" in blk["attn"]) == cfg.qk_norm


class TestLayers:
    def test_relu2_mlp_matches_reference(self):
        cfg_j, cfg = jax_config("nemotron-4-15b").reduced(), get_config("nemotron-4-15b").reduced()
        pj = JL.init_mlp(init_mk(jax.random.key(3), jnp.float32), cfg_j, "mlp")
        pt = convert.params_from_jax(jax.tree.map(np.asarray, pj))
        x = np.random.default_rng(3).standard_normal((2, 9, 128)).astype(np.float32)
        want = np.asarray(JL.apply_mlp(pj, jnp.asarray(x), cfg_j))
        got = L.apply_mlp(pt, torch.from_numpy(x), cfg).numpy()
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)

    @pytest.mark.parametrize("sections,d", [((8, 4, 4), 32), ((16, 24, 24), 128)])
    @pytest.mark.parametrize("streams", [2, 3])
    def test_mrope_matches_reference(self, sections, d, streams):
        rng = np.random.default_rng(d + streams)
        x = rng.standard_normal((2, 3, 11, d)).astype(np.float32)
        pos = rng.integers(0, 300, (3, 2, 11) if streams == 3 else (2, 11)).astype(np.int32)
        want = np.asarray(JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6, sections))
        got = L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6, sections).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        if streams == 2:        # three equal streams: plain 1-D RoPE
            plain = L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6).numpy()
            np.testing.assert_array_equal(got, plain)


#: (Hq, Hkv, D, T) of the real archs' head ratios: qwen2-0.5b (14/2 at 64),
#: nemotron-4-15b and dbrx (48/8 at 128), qwen3-moe (64/4 at 128).
HEAD_RATIOS = {"14-2": (14, 2, 64, 256), "48-8": (48, 8, 128, 128), "64-4": (64, 4, 128, 128)}


class TestRealHeadRatios:
    @pytest.mark.parametrize("ratio", HEAD_RATIOS)
    def test_plain_attention_matches_pallas_interpret(self, ratio):
        hq, hkv, d, t = HEAD_RATIOS[ratio]
        rng = np.random.default_rng(hq)
        q, k, v = (rng.standard_normal(s).astype(np.float32)
                   for s in ((1, hq, t, d), (1, hkv, t, d), (1, hkv, t, d)))
        want = np.asarray(flash_attention_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                                 causal=True, interpret=True))
        got = FO.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                 causal=True).numpy()
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)

    @pytest.mark.parametrize("ratio", HEAD_RATIOS)
    def test_attention_layer_matches_reference(self, ratio):
        """The layer at a narrow width with the real head ratio, cache-free
        and then decoding 3 tokens against a KV cache."""
        hq, hkv, d, _ = HEAD_RATIOS[ratio]
        base = dict(num_heads=hq, num_kv_heads=hkv, head_dim=d, d_model=64)
        cfg_j = dataclasses.replace(jax_config("qwen3-moe-235b-a22b").reduced(), **base)
        cfg = dataclasses.replace(get_config("qwen3-moe-235b-a22b").reduced(), **base)
        pj = JA.init_attention(init_mk(jax.random.key(1), jnp.float32), cfg_j, "attn")
        pt = convert.params_from_jax(jax.tree.map(np.asarray, pj))
        x = np.random.default_rng(1).standard_normal((2, 40, 64)).astype(np.float32)
        attend = jax.jit(JA.apply_attention, static_argnums=(2,))
        want, _ = attend(pj, jnp.asarray(x), cfg_j)
        got, _ = A.apply_attention(pt, torch.from_numpy(x), cfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
        cj = JA.KVCache(jnp.zeros((2, hkv, 64, d)), jnp.zeros((2, hkv, 64, d)),
                        jnp.zeros((2,), jnp.int32))
        ct = A.KVCache(torch.zeros(2, hkv, 64, d), torch.zeros(2, hkv, 64, d),
                       torch.zeros(2, dtype=torch.int32))
        for i in range(3):
            xi = x[:, i:i + 1]
            pos = np.full((2, 1), i, np.int32)
            wj, cj = attend(pj, jnp.asarray(xi), cfg_j, positions=jnp.asarray(pos), kv_cache=cj)
            gt, ct = A.apply_attention(pt, torch.from_numpy(xi), cfg,
                                       positions=torch.from_numpy(pos), kv_cache=ct)
            np.testing.assert_allclose(gt.numpy(), np.asarray(wj), rtol=TOL, atol=TOL)


class TestForward:
    def test_logits_match_reference(self, arch):
        cfg_j, cfg, pj, pt = arch
        toks = _prompts(7, 2, 48)
        kj, kt = _extras(cfg, 2, 48, seed=7)
        want = np.asarray(JM.forward(pj, cfg_j, jnp.asarray(toks), **kj))
        got = M.forward(pt, cfg, _tok(toks), **kt).numpy()
        assert got.shape == want.shape == (2, 48, cfg.padded_vocab)
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)

    def test_prefill_step_matches_reference(self, arch):
        """``make_prefill_step`` at the config's own ``prefill_chunks`` (4
        for dbrx, 8 for qwen3-moe, 1 for the rest): B = 2n goes through n
        chunks of two sequences, and B = n + 1 through one forward.  The
        MoE capacity counts the tokens of each call, so the chunked logits
        are held to the reference's chunked ones."""
        cfg_j, cfg, pj, pt = arch
        n = cfg.prefill_chunks
        for b in sorted({2 * n, n + 1}):
            toks = _prompts(b, b, 24)
            kj, kt = _extras(cfg, b, 24, seed=b)
            want = np.asarray(JE.make_prefill_step(cfg_j)(pj, jnp.asarray(toks), **kj))
            got = E.make_prefill_step(cfg)(pt, _tok(toks), **kt).numpy()
            np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)

    @pytest.mark.parametrize("name", MOE_ARCHS)
    def test_chunked_prefill_differs_from_one_forward_as_the_reference(self, name):
        """At a tight capacity the chunks' own capacities drop other
        assignments than one forward's: the port's chunked scoring follows
        the reference's chunked scoring, not the one-forward logits."""
        cfg_j = dataclasses.replace(jax_config(name).reduced(), moe_capacity_factor=0.3)
        cfg = dataclasses.replace(get_config(name).reduced(), moe_capacity_factor=0.3)
        pj = JM.init_params(cfg_j, jax.random.key(2))
        pt = convert.params_from_jax(jax.tree.map(np.asarray, pj))
        toks = _prompts(5, 2 * cfg.prefill_chunks, 16)
        want = np.asarray(JE.make_prefill_step(cfg_j)(pj, jnp.asarray(toks)))
        got = E.make_prefill_step(cfg)(pt, _tok(toks)).numpy()
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
        whole = M.forward(pt, cfg, _tok(toks)).numpy()
        assert np.abs(whole - got).max() > 1e-2

    def test_chunked_prefill_splits_mrope_positions(self):
        """qwen2-vl at ``prefill_chunks=2``: the (3, B, T) positions split
        along the batch axis, the patch embeddings along the first."""
        cfg_j = dataclasses.replace(jax_config("qwen2-vl-7b").reduced(), prefill_chunks=2)
        cfg = dataclasses.replace(get_config("qwen2-vl-7b").reduced(), prefill_chunks=2)
        pj = JM.init_params(cfg_j, jax.random.key(4))
        pt = convert.params_from_jax(jax.tree.map(np.asarray, pj))
        toks = _prompts(4, 4, 32)
        kj, kt = _extras(cfg, 4, 32, seed=4)
        kj["positions"] = kj["positions"].at[:, 2:].add(5)     # chunks differ
        kt["positions"] = torch.from_numpy(np.array(kj["positions"]))
        want = np.asarray(JE.make_prefill_step(cfg_j)(pj, jnp.asarray(toks), **kj))
        got = E.make_prefill_step(cfg)(pt, _tok(toks), **kt).numpy()
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
        one = M.forward(pt, dataclasses.replace(cfg, prefill_chunks=1), _tok(toks), **kt)
        np.testing.assert_allclose(got, one.numpy(), rtol=TOL, atol=TOL)


class TestDecode:
    def test_chained_decode_matches_reference(self, arch):
        """A 12-token prompt window, then 8 chained single-token steps, each
        step's logits and the final state against the reference's; row 1's
        prompt is ragged (5 tokens)."""
        cfg_j, cfg, pj, pt = arch
        b, max_len = 2, 64
        rng = np.random.default_rng(11)
        st_j = JM.init_decode_state(cfg_j, b, max_len, insert_window=12)
        st_t = M.init_decode_state(cfg, b, max_len, 12, device="cpu")
        toks = rng.integers(0, cfg.vocab_size, (b, 12)).astype(np.int32)
        mask = np.ones((b, 12), bool)
        mask[1, 5:] = False
        lj, st_j = JM.decode_step(pj, cfg_j, st_j, jnp.asarray(toks), jnp.zeros(b, jnp.int32),
                                  token_mask=jnp.asarray(mask))
        lt, st_t = M.decode_step(pt, cfg, st_t, _tok(toks), torch.zeros(b, dtype=torch.int32),
                                 token_mask=torch.from_numpy(mask))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=TOL, atol=TOL)
        lengths = mask.sum(1).astype(np.int32)
        step_j = jax.jit(JM.decode_step, static_argnums=(1,))
        for _ in range(8):
            tok = rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32)
            lj, st_j = step_j(pj, cfg_j, st_j, jnp.asarray(tok), jnp.asarray(lengths))
            lt, st_t = M.decode_step(pt, cfg, st_t, _tok(tok), torch.from_numpy(lengths))
            np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=TOL, atol=TOL)
            lengths = lengths + 1
        for a, w in zip(_state_np(st_t), jax.tree.leaves(st_j)):
            np.testing.assert_allclose(a, np.asarray(w), rtol=TOL, atol=TOL)


class TestServe:
    def test_generate_greedy_equals_reference(self, arch):
        cfg_j, cfg, pj, pt = arch
        prompts = _prompts(12, 3, 12)
        lens = (12, 7, 3)
        want = JE.ServeEngine(cfg_j, pj, max_len=64, decode_window=4).generate(
            jnp.asarray(prompts), 10, prompt_lengths=jnp.asarray(lens))
        eng = E.ServeEngine(cfg, pt, max_len=64, decode_window=4, device="cpu")
        got = eng.generate(prompts, 10, prompt_lengths=lens)
        assert np.array_equal(got.numpy(), np.asarray(want))

    def test_serve_greedy_equals_reference(self, arch):
        cfg_j, cfg, pj, pt = arch
        rng = np.random.default_rng(3)
        reqs = [(rng.integers(0, cfg.vocab_size, (int(rng.integers(4, 30)),)).astype(np.int32),
                 int(rng.integers(2, 10))) for _ in range(5)]
        want = JE.ServeEngine(cfg_j, pj, max_len=64, decode_window=4).serve(
            [JE.Request(tokens=t, max_new_tokens=n) for t, n in reqs], slots=2)
        eng = E.ServeEngine(cfg, pt, max_len=64, decode_window=4, device="cpu")
        got = eng.serve([E.Request(tokens=t, max_new_tokens=n) for t, n in reqs], slots=2)
        for w, g, (_, n) in zip(want, got, reqs):
            assert g.outcome == w.outcome == "ok" and g.size == n
            assert np.array_equal(np.asarray(g), np.asarray(w))
        assert bool(M.decode_state_finite(eng.last_state).all())

    @pytest.mark.parametrize("name", ARCHS)
    def test_launcher_smoke_on_cpu_exits_zero(self, name, capsys):
        launcher.main(["--arch", name, "--smoke", "--continuous", "--device", "cpu",
                       "--requests", "4", "--slots", "2", "--prompt-len", "8",
                       "--new-tokens", "5", "--max-len", "32", "--decode-window", "2"])
        assert "tok/s" in capsys.readouterr().out
