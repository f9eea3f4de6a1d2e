"""The port's serve engine against the reference's, on the CPU, on the
reduced RWKV6 config with the reference's parameters.

Greedy streams must equal the reference token for token: logits agree to
about 1e-5 (see tests/test_torch_model.py), far inside the gaps between
the top logits of these workloads.  Sampled streams use the port's own
counter-based draw, so they are held to the reference's invariance
contract inside the port: the same for every decode window and slot count.
"""

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
from repro_torch.serve import engine as E

jax.config.update("jax_platform_name", "cpu")
# Tiny tensors: one intra-op thread, so parallel test workers do not
# oversubscribe the cores.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    cfg_j = jax_config("rwkv6-1.6b").reduced()
    cfg = get_config("rwkv6-1.6b").reduced()
    pj = JM.init_params(cfg_j, jax.random.key(0))
    pt = convert.params_from_jax(jax.tree.map(np.asarray, pj))
    return cfg_j, cfg, pj, pt


def _lane3b_requests(vocab):
    """The lane-3b workload of scripts/tier1.sh, drawn as the reference's
    launcher draws it: 5 requests, prompts of 4-8 tokens, budgets 2-6."""
    rng = np.random.default_rng(0)
    reqs = []
    for _ in range(5):
        p = int(rng.integers(4, 9))
        toks = rng.integers(0, vocab, (p,)).astype(np.int32)
        reqs.append((toks, int(rng.integers(2, 7))))
    return reqs


def _serve_both(setup, reqs, *, slots, max_len, k, eos_id=None):
    cfg_j, cfg, pj, pt = setup
    want = JE.ServeEngine(cfg_j, pj, max_len=max_len, decode_window=k).serve(
        [JE.Request(tokens=t, max_new_tokens=n) for t, n in reqs],
        slots=slots, eos_id=eos_id)
    eng = E.ServeEngine(cfg, pt, max_len=max_len, decode_window=k, device="cpu")
    got = eng.serve([E.Request(tokens=t, max_new_tokens=n) for t, n in reqs],
                    slots=slots, eos_id=eos_id)
    return want, got, eng


class TestGenerate:
    @pytest.mark.parametrize("p,lens,k", [
        (12, (12, 7, 3), 4),      # ragged prompts, window path at prefill
        (80, None, 8),            # an 80-token prefill: the chunked path
    ])
    def test_greedy_equals_reference(self, setup, p, lens, k):
        cfg_j, cfg, pj, pt = setup
        prompts = np.random.default_rng(p).integers(0, cfg.vocab_size, (3, p)).astype(np.int32)
        lj = None if lens is None else jnp.asarray(lens)
        want = JE.ServeEngine(cfg_j, pj, max_len=128, decode_window=k).generate(
            jnp.asarray(prompts), 9, prompt_lengths=lj)
        eng = E.ServeEngine(cfg, pt, max_len=128, decode_window=k, device="cpu")
        got = eng.generate(prompts, 9, prompt_lengths=lens)
        assert np.array_equal(got.numpy(), np.asarray(want))
        assert eng.last_decode_dispatches == -(-9 // k)

    def test_zero_new_tokens_returns_prompts(self, setup):
        _, cfg, _, pt = setup
        prompts = np.arange(10).reshape(2, 5)
        eng = E.ServeEngine(cfg, pt, device="cpu")
        assert np.array_equal(eng.generate(prompts, 0).numpy(), prompts)


class TestServe:
    def test_lane3b_greedy_equals_reference(self, setup):
        reqs = _lane3b_requests(512)
        want, got, eng = _serve_both(setup, reqs, slots=2, max_len=32, k=2)
        for w, g, (_, n) in zip(want, got, reqs):
            assert g.outcome == w.outcome == "ok"
            assert np.array_equal(np.asarray(g), np.asarray(w)) and g.size == n
        assert eng.last_serve_stats["admissions"] >= 2     # slots recycled

    def test_eos_and_shed_outcomes_equal_reference(self, setup):
        reqs = _lane3b_requests(512) + [(np.arange(30, dtype=np.int32), 8)]
        # An EOS id the greedy streams produce: the first request's second
        # token under the same engine settings.
        first, _, _ = _serve_both(setup, reqs[:1], slots=1, max_len=32, k=2)
        eos = int(np.asarray(first[0])[1])
        want, got, _ = _serve_both(setup, reqs, slots=3, max_len=32, k=4, eos_id=eos)
        assert [g.outcome for g in got] == [w.outcome for w in want]
        assert "eos" in [g.outcome for g in got] and got[-1].outcome == "shed"
        for w, g in zip(want, got):
            assert np.array_equal(np.asarray(g), np.asarray(w))

    @pytest.mark.parametrize("k,slots", [(k, s) for k in (1, 2, 4) for s in (1, 2, 3)
                                         if (k, s) != (1, 1)])
    def test_sampled_streams_invariant(self, setup, k, slots):
        _, cfg, _, pt = setup
        reqs = [E.Request(tokens=t, max_new_tokens=n) for t, n in _lane3b_requests(512)]

        def run(k_, slots_):
            eng = E.ServeEngine(cfg, pt, max_len=32, decode_window=k_, device="cpu")
            return [o.tolist() for o in eng.serve(
                reqs, slots=slots_, temperature=0.8, top_k=16, seed=7)]

        base = run(1, 1)
        assert run(k, slots) == base
        # The draw depends on the seed, and it is not greedy.
        eng = E.ServeEngine(cfg, pt, max_len=32, decode_window=1, device="cpu")
        assert [o.tolist() for o in eng.serve(reqs, slots=1)] != base

    def test_gumbel_noise_is_a_pure_counter_function(self):
        rid = torch.tensor([0, 5, 5])
        idx = torch.tensor([3, 3, 4])
        a = E._gumbel(1, rid, idx, 64)
        assert torch.equal(a, E._gumbel(1, rid, idx, 64))
        assert torch.equal(a[1], E._gumbel(1, rid[1:2], idx[1:2], 64)[0])
        assert not torch.equal(a[1], a[2]) and not torch.equal(a, E._gumbel(2, rid, idx, 64))
        assert bool(torch.isfinite(a).all())

    def test_reset_slot_rows_touches_only_marked_rows(self, setup):
        _, cfg, _, _ = setup
        st = M.init_decode_state(cfg, 3, 64, device="cpu")
        for node in st["scanned"]:
            node.h.fill_(1.0)
            node.conv.fill_(2.0)
        E._reset_slot_rows(st, torch.tensor([False, True, False]))
        node = st["scanned"][0]
        assert float(node.h[:, 1].abs().sum()) == 0 and float(node.conv[:, 1].abs().sum()) == 0
        assert bool((node.h[:, 0] == 1).all() and (node.conv[:, 2] == 2).all())

    def test_bucket32(self):
        assert [E._bucket32(n) for n in (0, 1, 32, 33, 64, 65)] == [32, 32, 32, 64, 64, 96]


class TestLauncher:
    @pytest.mark.parametrize("extra", [
        ["--continuous", "--requests", "5", "--slots", "2", "--prompt-len", "8",
         "--new-tokens", "6", "--max-len", "32", "--decode-window", "2",
         "--temperature", "0.8", "--top-k", "16"],
        ["--batch", "2", "--prompt-len", "70", "--new-tokens", "5"],
    ])
    def test_smoke_on_cpu_exits_zero(self, extra, capsys):
        launcher.main(["--arch", "rwkv6-1.6b", "--smoke", "--device", "cpu", *extra])
        assert "tok/s" in capsys.readouterr().out

    def test_unported_arch_is_refused(self):
        with pytest.raises(NotImplementedError):
            launcher.main(["--arch", "gemma3-1b", "--smoke", "--device", "cpu"])


# ---------------------------------------------------------------------------
# RecurrentGemma (reduced, f32): the local-attention ring and the RG-LRU
# state through the same engine.  Greedy streams equal the reference's
# (logits agree to about 2e-6, tests/test_torch_model.py); prompt-scoring
# logits are held to the model tolerance, 1e-4.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rg_setup():
    cfg_j = jax_config("recurrentgemma-2b").reduced()
    cfg = get_config("recurrentgemma-2b").reduced()
    pj = JM.init_params(cfg_j, jax.random.key(0))
    pt = convert.params_from_jax(jax.tree.map(np.asarray, pj))
    return cfg_j, cfg, pj, pt


class TestRecurrentGemma:
    @pytest.mark.parametrize("p,lens,k", [
        (12, (12, 7, 3), 4),      # ragged prompts, the window kernel at prefill
        (80, None, 8),            # an 80-token prefill: the chunked scan, a wrapped ring
    ])
    def test_generate_greedy_equals_reference(self, rg_setup, p, lens, k):
        cfg_j, cfg, pj, pt = rg_setup
        prompts = np.random.default_rng(p).integers(0, cfg.vocab_size, (3, p)).astype(np.int32)
        lj = None if lens is None else jnp.asarray(lens)
        want = JE.ServeEngine(cfg_j, pj, max_len=128, decode_window=k).generate(
            jnp.asarray(prompts), 9, prompt_lengths=lj)
        eng = E.ServeEngine(cfg, pt, max_len=128, decode_window=k, device="cpu")
        got = eng.generate(prompts, 9, prompt_lengths=lens)
        assert np.array_equal(got.numpy(), np.asarray(want))

    def test_lane3b_serve_greedy_equals_reference(self, rg_setup):
        reqs = _lane3b_requests(512)
        want, got, eng = _serve_both(rg_setup, reqs, slots=2, max_len=32, k=2)
        for w, g, (_, n) in zip(want, got, reqs):
            assert g.outcome == w.outcome == "ok"
            assert np.array_equal(np.asarray(g), np.asarray(w)) and g.size == n
        assert eng.last_serve_stats["admissions"] >= 2

    @pytest.mark.parametrize("k,slots", [(2, 1), (1, 3), (4, 2)])
    def test_sampled_streams_invariant(self, rg_setup, k, slots):
        _, cfg, _, pt = rg_setup
        reqs = [E.Request(tokens=t, max_new_tokens=n) for t, n in _lane3b_requests(512)]

        def run(k_, slots_):
            eng = E.ServeEngine(cfg, pt, max_len=32, decode_window=k_, device="cpu")
            return [o.tolist() for o in eng.serve(
                reqs, slots=slots_, temperature=0.8, top_k=16, seed=7)]

        assert run(k, slots) == run(1, 1)

    @pytest.mark.parametrize("seed", [1, 2])
    def test_prefill_step_logits_match_reference(self, rg_setup, seed):
        cfg_j, cfg, pj, pt = rg_setup
        assert cfg.prefill_chunks == cfg_j.prefill_chunks == 1
        toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (2, 90)).astype(np.int32)
        want = np.asarray(JE.make_prefill_step(cfg_j)(pj, jnp.asarray(toks)))
        got = E.make_prefill_step(cfg)(pt, torch.from_numpy(toks).long()).numpy()
        assert got.shape == want.shape == (2, 90, cfg.padded_vocab)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)

    def test_prefill_step_refuses_chunks(self, rg_setup):
        import dataclasses

        cfg = dataclasses.replace(rg_setup[1], prefill_chunks=2)
        with pytest.raises(NotImplementedError, match="prefill_chunks"):
            E.make_prefill_step(cfg)

    def test_reset_slot_rows_resets_kv_lengths_and_scrubs_nan(self, rg_setup):
        _, cfg, _, _ = rg_setup
        st = M.init_decode_state(cfg, 3, 64, device="cpu")
        kv = st["scanned"][2]
        kv.k.fill_(1.0)
        kv.length.fill_(9)
        kv.k[0, 1, 0, 3, 5] = float("nan")    # reset row: scrubbed
        kv.k[0, 2, 0, 3, 5] = float("nan")    # kept row: untouched
        E._reset_slot_rows(st, torch.tensor([False, True, False]))
        assert kv.length[:, 1].tolist() == [0, 0] and kv.length[:, 0].tolist() == [9, 9]
        assert float(kv.k[0, 1, 0, 3, 5]) == 0.0 and float(kv.k[0, 1, 0, 3, 4]) == 1.0
        assert bool(torch.isnan(kv.k[0, 2, 0, 3, 5]))

    def test_launcher_smoke_on_cpu_exits_zero(self, capsys):
        launcher.main(["--arch", "recurrentgemma-2b", "--smoke", "--device", "cpu",
                       "--continuous", "--requests", "5", "--slots", "2", "--prompt-len", "8",
                       "--new-tokens", "6", "--max-len", "32", "--decode-window", "2"])
        assert "tok/s" in capsys.readouterr().out
