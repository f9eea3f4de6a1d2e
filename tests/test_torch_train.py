"""The port's training stack against the reference's, on the CPU, plus the
port's own copies of the reference's substrate tests (tests/test_substrates.py)
for the optimizer, compression, data, checkpoint and fault tolerance.

Parity runs on the reduced rwkv6 config (2 layers, d_model 128, two 64-wide
WKV heads, f32) from the reference's ``init_train_state``, carried across
with ``convert.train_state_from_jax``, on one numpy batch.

Tolerances, measured on this tree: the loss agrees to about 1e-6 and every
gradient leaf to about 1e-6 of its largest value, so GRAD_TOL = 1e-4 of the
leaf's largest value (plus 1e-4 relative) is stated.  After one AdamW step
the parameters move by about lr * g/|g|; they are held to 1e-5 where the
gradient is well above AdamW's eps, and to 2 * lr where it is not; the
moments to GRAD_TOL of their largest value.
"""

import dataclasses
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.optim import adamw as jadamw
from repro.train import step as jstep
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import DataConfig, make_batch, make_batch_numpy
from repro_torch.ft.watchdog import (
    NodeFailure,
    StepTimeout,
    StepWatchdog,
    StragglerDetector,
    run_with_restarts,
)
from repro_torch.model import convert
from repro_torch.optim import adamw
from repro_torch.optim.compression import (
    compressed_gradients,
    compression_ratio,
    dequantize_int8,
    init_error_feedback,
    quantize_int8,
)
from repro_torch.train import step as tstep
from repro_torch.tree import tree_leaves, tree_paths

jax.config.update("jax_platform_name", "cpu")
# Small tensors: one intra-op thread, so parallel test workers do not
# oversubscribe the cores.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
GRAD_TOL = 1e-4


def _close_leaves(got, want, tol=GRAD_TOL):
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.detach().float().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol * max(1e-3, np.abs(w).max()))


def _batch(cfg, b, t, seed=0):
    return make_batch_numpy(DataConfig(vocab_size=cfg.vocab_size, seq_len=t,
                                       global_batch=b, seed=seed), 0)


def _jbatch(nb):
    return {k: jnp.asarray(v.astype(np.int32)) for k, v in nb.items()}


def _tbatch(nb):
    return {k: torch.from_numpy(v) for k, v in nb.items()}


@pytest.fixture(scope="module")
def reduced():
    cfg_j = dataclasses.replace(jax_config("rwkv6-1.6b").reduced(), microbatch=2)
    cfg = dataclasses.replace(get_config("rwkv6-1.6b").reduced(), microbatch=2)
    state_j = jstep.init_train_state(cfg_j, jax.random.key(0))
    return cfg_j, cfg, state_j


def _port_state(state_j):
    return convert.train_state_from_jax(jax.tree.map(np.asarray, state_j))


# --------------------------------------------------------------------------
# Against the reference
# --------------------------------------------------------------------------

class TestAgainstReference:
    @pytest.mark.parametrize("remat", ["none", "full"])
    def test_loss_and_grads(self, reduced, remat):
        cfg_j, cfg, state_j = reduced
        cfg = dataclasses.replace(cfg, remat=remat)
        nb = _batch(cfg, 2, 32)
        loss_j, grads_j = jax.value_and_grad(jstep.make_loss_fn(cfg_j))(
            state_j.params, _jbatch(nb))
        params = _port_state(state_j).params
        loss = tstep.make_loss_fn(cfg)(params, _tbatch(nb))
        loss.backward()
        assert loss.item() == pytest.approx(float(loss_j), rel=1e-5)
        paths = [p for p, _ in tree_paths(params)]
        assert len(paths) == len(jax.tree.leaves(grads_j))
        _close_leaves([p.grad for p in tree_leaves(params)], jax.tree.leaves(grads_j))

    def test_one_train_step_microbatch_2(self, reduced):
        cfg_j, cfg, state_j = reduced
        opt_cfg = dict(lr=1e-3, warmup_steps=2, total_steps=10)
        nb = _batch(cfg, 4, 32, seed=1)
        state = _port_state(state_j)
        new_j, m_j = jstep.make_train_step(cfg_j, jadamw.AdamWConfig(**opt_cfg))(
            state_j, _jbatch(nb))
        new, m = tstep.make_train_step(cfg, adamw.AdamWConfig(**opt_cfg))(
            state, _tbatch(nb))
        assert float(m["loss"]) == pytest.approx(float(m_j["loss"]), rel=1e-5)
        assert float(m["grad_norm"]) == pytest.approx(float(m_j["grad_norm"]), rel=1e-4)
        assert float(m["lr"]) == pytest.approx(float(m_j["lr"]), rel=1e-6)
        assert int(new.opt.step) == int(new_j.opt.step) == 1
        _close_leaves(tree_leaves(new.opt.mu), jax.tree.leaves(new_j.opt.mu))
        _close_leaves(tree_leaves(new.opt.nu), jax.tree.leaves(new_j.opt.nu))
        # A first AdamW step moves each parameter by about lr * g/|g|, so
        # where a gradient is near eps (1e-8) the two frameworks may round
        # it to different steps: held to 1e-5 where |mu| > 1e-7 (gradients
        # above 1e-6), and everywhere to 2 * lr, the largest first step.
        lr = float(m_j["lr"])
        for g, w, mu in zip(tree_leaves(new.params), jax.tree.leaves(new_j.params),
                            jax.tree.leaves(new_j.opt.mu)):
            diff = np.abs(g.detach().numpy() - np.asarray(w))
            assert diff.max() <= 2 * lr
            assert diff[np.abs(np.asarray(mu)) > 1e-7].max(initial=0.0) <= 1e-5

    def test_train_state_round_trip(self, reduced):
        _, _, state_j = reduced
        ref = jax.tree.map(np.asarray, state_j)
        back = convert.train_state_to_numpy(convert.train_state_from_jax(ref))
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
            np.testing.assert_array_equal(a, b)

    def test_compressed_step(self, reduced):
        cfg_j, cfg, _ = reduced
        state_j = jstep.init_train_state(cfg_j, jax.random.key(1), compress=True)
        state = _port_state(state_j)
        assert state.ef is not None
        nb = _batch(cfg, 4, 16, seed=2)
        new_j, m_j = jstep.make_train_step(cfg_j, compress=True)(state_j, _jbatch(nb))
        new, m = tstep.make_train_step(cfg, compress=True)(state, _tbatch(nb))
        assert float(m["loss"]) == pytest.approx(float(m_j["loss"]), rel=1e-5)
        # The residual is the quantization error: below half a bucket.
        for r in tree_leaves(new.ef.residual):
            assert float(r.abs().max()) < 1.0


# --------------------------------------------------------------------------
# Inside the port
# --------------------------------------------------------------------------

class TestTrainStep:
    def test_microbatch_equals_full_batch_grads(self):
        base = get_config("rwkv6-1.6b").reduced()
        cfg1 = dataclasses.replace(base, num_layers=1, microbatch=1)
        cfg4 = dataclasses.replace(base, num_layers=1, microbatch=4)
        nb = _tbatch(_batch(base, 8, 16))
        s1 = tstep.init_train_state(cfg1, 0, device="cpu")
        s4 = tstep.init_train_state(cfg4, 0, device="cpu")
        n1, m1 = tstep.make_train_step(cfg1)(s1, nb)
        n4, m4 = tstep.make_train_step(cfg4)(s4, nb)
        assert float(m1["loss"]) == pytest.approx(float(m4["loss"]), rel=1e-5)
        _close_leaves(tree_leaves(n1.params), [p.detach() for p in tree_leaves(n4.params)],
                      tol=2e-4)

    def test_remat_full_equals_none(self):
        base = get_config("rwkv6-1.6b").reduced()
        nb = _tbatch(_batch(base, 2, 32))
        grads = {}
        for remat in ("none", "full"):
            cfg = dataclasses.replace(base, remat=remat)
            params = tstep.init_train_state(cfg, 3, device="cpu").params
            tstep.make_loss_fn(cfg)(params, nb).backward()
            grads[remat] = [p.grad for p in tree_leaves(params)]
        for a, b in zip(grads["none"], grads["full"]):
            assert torch.equal(a, b)

    def test_remat_dots_saves_the_products_and_recomputes_the_rest(self):
        """``remat="dots"`` (the reference's
        ``checkpoint_dots_with_no_batch_dims``): the backward runs no
        ``aten.mm`` beyond what "none" runs (the projections' outputs are
        saved), the batched products and everything else as "full"
        recomputes them, and the grads equal both."""
        from torch.utils._python_dispatch import TorchDispatchMode

        class Count(TorchDispatchMode):
            def __init__(self):
                super().__init__()
                self.n = {"mm": 0, "bmm": 0}

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if func is torch.ops.aten.mm.default:
                    self.n["mm"] += 1
                if func is torch.ops.aten.bmm.default:
                    self.n["bmm"] += 1
                return func(*args, **(kwargs or {}))

        base = get_config("gemma3-1b").reduced()
        nb = _tbatch(_batch(base, 2, 16))
        counts, grads = {}, {}
        for remat in ("none", "full", "dots"):
            cfg = dataclasses.replace(base, remat=remat)
            params = tstep.init_train_state(cfg, 0, device="cpu").params
            loss = tstep.make_loss_fn(cfg)(params, nb)
            with Count() as c:
                grads[remat] = torch.autograd.grad(loss, tree_leaves(params))
            counts[remat] = c.n
        assert counts["dots"]["mm"] == counts["none"]["mm"] < counts["full"]["mm"]
        assert counts["dots"]["bmm"] == counts["full"]["bmm"] > counts["none"]["bmm"]
        for remat in ("full", "dots"):
            assert all(torch.equal(a, b) for a, b in zip(grads["none"], grads[remat]))

    def test_loss_decreases(self):
        cfg = get_config("rwkv6-1.6b").reduced()
        dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=8, seed=1)
        state = tstep.init_train_state(cfg, 0, device="cpu")
        step = tstep.make_train_step(
            cfg, adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20))
        losses = []
        for i in range(10):
            state, m = step(state, make_batch(dcfg, i, device="cpu"))
            losses.append(float(m["loss"]))
        assert losses[-1] < losses[0] - 0.5, losses


class TestAdamW:
    def test_quadratic_convergence(self):
        params = {"w": torch.tensor([5.0, -3.0])}
        state = adamw.init_state(params)
        cfg = adamw.AdamWConfig(lr=0.2, weight_decay=0.0, warmup_steps=0, total_steps=200)
        for _ in range(150):
            g = {"w": 2 * params["w"]}
            params, state, _ = adamw.apply_updates(params, g, state, cfg)
        assert float(params["w"].square().sum()) < 1e-2

    def test_clip_norm(self):
        params = {"w": torch.zeros(4)}
        state = adamw.init_state(params)
        cfg = adamw.AdamWConfig(clip_norm=1.0, warmup_steps=0)
        _, _, metrics = adamw.apply_updates(params, {"w": torch.full((4,), 100.0)}, state, cfg)
        assert float(metrics["grad_norm"]) == pytest.approx(200.0)

    def test_schedule_warmup_and_decay(self):
        cfg = adamw.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
        assert float(adamw.schedule(cfg, 0)) == 0.0
        assert float(adamw.schedule(cfg, 10)) == pytest.approx(1.0)
        assert float(adamw.schedule(cfg, 100)) == pytest.approx(0.1)

    def test_stacked_leaf_updates_per_layer_like_whole(self):
        rng = np.random.default_rng(0)
        p = torch.from_numpy(rng.standard_normal((3, 4, 5)).astype(np.float32))
        g = torch.from_numpy(rng.standard_normal((3, 4, 5)).astype(np.float32))
        cfg = adamw.AdamWConfig(warmup_steps=0)
        a = {"w": p.clone()}
        adamw.apply_updates(a, {"w": g}, adamw.init_state(a), cfg)
        b = {"w": p[None].clone()}               # one slab: no per-layer loop
        adamw.apply_updates(b, {"w": g[None]}, adamw.init_state(b), cfg)
        assert torch.equal(a["w"], b["w"][0])

    def test_bf16_params_keep_their_dtype(self):
        params = {"w": torch.ones(8, dtype=torch.bfloat16)}
        state = adamw.init_state(params)
        adamw.apply_updates(params, {"w": torch.ones(8)}, state, adamw.AdamWConfig(warmup_steps=0))
        assert params["w"].dtype == torch.bfloat16 and state.mu["w"].dtype == torch.float32


class TestCompression:
    @pytest.mark.parametrize("seed,n", [(0, 10), (1, 256), (2, 257), (3, 3000)])
    def test_quantize_roundtrip_error_bounded(self, seed, n):
        rng = np.random.default_rng(seed)
        x = torch.from_numpy(rng.standard_normal(n).astype(np.float32)) * 10
        q, scale, shape, pad = quantize_int8(x)
        deq = dequantize_int8(q, scale, shape, pad)
        bound = np.repeat(scale.numpy(), 256)[:n] * 0.5 + 1e-6
        assert np.all(np.abs((deq - x).numpy()) <= bound)

    def test_matches_reference_quantizer(self):
        from repro.optim.compression import compress_leaf as jcompress

        rng = np.random.default_rng(4)
        g = rng.standard_normal((3, 300)).astype(np.float32)
        r = rng.standard_normal((3, 300)).astype(np.float32) * 0.01
        from repro_torch.optim.compression import compress_leaf

        got = compress_leaf(torch.from_numpy(g), torch.from_numpy(r))
        want = jcompress(jnp.asarray(g), jnp.asarray(r))
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)

    def test_error_feedback_preserves_sum(self):
        rng = np.random.default_rng(0)
        g_true = [torch.from_numpy(rng.standard_normal(512).astype(np.float32)) for _ in range(20)]
        ef = init_error_feedback({"w": g_true[0]})
        total_c = torch.zeros(512)
        for g in g_true:
            gc, ef = compressed_gradients({"w": g}, ef)
            total_c = total_c + gc["w"]
        np.testing.assert_allclose((total_c + ef.residual["w"]).numpy(),
                                   sum(g_true).numpy(), rtol=1e-4, atol=1e-4)

    def test_ratio_beats_bf16(self):
        assert compression_ratio({"w": torch.zeros((1024, 1024))}) < 0.27


class TestDataPipeline:
    def test_deterministic_and_step_keyed(self):
        cfg = DataConfig(vocab_size=1000, seq_len=32, global_batch=4)
        b1, b2, b3 = (make_batch(cfg, s, device="cpu") for s in (7, 7, 8))
        assert torch.equal(b1["tokens"], b2["tokens"])
        assert not torch.equal(b1["tokens"], b3["tokens"])
        other = make_batch(dataclasses.replace(cfg, seed=1), 7, device="cpu")
        assert not torch.equal(b1["tokens"], other["tokens"])

    def test_labels_are_shifted_tokens(self):
        b = make_batch(DataConfig(vocab_size=50, seq_len=16, global_batch=2), 0, device="cpu")
        assert torch.equal(b["labels"][:, :-1], b["tokens"][:, 1:])
        assert b["tokens"].shape == b["labels"].shape == (2, 16)
        assert b["tokens"].dtype == torch.int64

    def test_tokens_in_vocab(self):
        b = make_batch(DataConfig(vocab_size=100, seq_len=64, global_batch=4), 3, device="cpu")
        assert int(b["tokens"].min()) >= 0 and int(b["tokens"].max()) < 100

    def test_ngram_structure(self):
        toks = make_batch_numpy(DataConfig(vocab_size=1000, seq_len=64, global_batch=4), 5)["tokens"]
        pos = np.arange(8, 64, 8)
        np.testing.assert_array_equal(toks[:, pos], toks[:, pos - 4])
        # Zipf with exponent 1.1: about a fifth of the ids are below 10.
        assert np.mean(toks < 10) > 0.15


class TestCheckpoint:
    def test_save_restore_roundtrip(self, tmp_path):
        tree = {"a": torch.arange(6.0).reshape(2, 3), "b": {"c": torch.tensor(7, dtype=torch.int32)},
                "h": torch.randn(5).bfloat16()}
        ckpt.save(tmp_path, 5, tree)
        template = {"a": torch.zeros(2, 3), "b": {"c": torch.tensor(0, dtype=torch.int32)},
                    "h": torch.zeros(5, dtype=torch.bfloat16)}
        restored, step = ckpt.restore(tmp_path, template)
        assert step == 5
        assert torch.equal(restored["a"], tree["a"])
        assert int(restored["b"]["c"]) == 7
        assert restored["h"].dtype == torch.bfloat16 and torch.equal(restored["h"], tree["h"])

    def test_latest_pointer_and_multiple_steps(self, tmp_path):
        ckpt.save(tmp_path, 1, {"a": torch.zeros(2)})
        ckpt.save(tmp_path, 2, {"a": torch.ones(2)})
        assert ckpt.latest_step(tmp_path) == 2
        restored, step = ckpt.restore(tmp_path, {"a": torch.zeros(2)})
        assert step == 2 and torch.equal(restored["a"], torch.ones(2))
        assert ckpt.latest_step(tmp_path / "nothing") is None

    def test_async_saver(self, tmp_path):
        saver = ckpt.AsyncSaver()
        x = torch.full((4,), 2.0)
        saver.save_async(tmp_path, 3, {"x": x})
        x.fill_(9.0)                  # the snapshot was taken before the write
        saver.wait()
        restored, _ = ckpt.restore(tmp_path, {"x": torch.zeros(4)})
        assert torch.equal(restored["x"], torch.full((4,), 2.0))

    def test_async_saver_surfaces_errors(self, tmp_path):
        blocker = tmp_path / "file"
        blocker.write_text("not a directory")
        saver = ckpt.AsyncSaver()
        saver.save_async(blocker, 1, {"x": torch.zeros(1)})
        with pytest.raises(ckpt.AsyncSaverError):
            saver.wait()

    def test_atomic_no_tmp_left_and_overwrite(self, tmp_path):
        ckpt.save(tmp_path, 4, {"x": torch.zeros(3)})
        (tmp_path / "step_5.tmp").mkdir()     # a crashed save
        ckpt.save(tmp_path, 5, {"x": torch.ones(3)})
        ckpt.save(tmp_path, 5, {"x": torch.full((3,), 2.0)})
        names = sorted(p.name for p in tmp_path.iterdir())
        assert names == ["LATEST", "step_4", "step_5"]
        assert torch.equal(ckpt.restore(tmp_path, {"x": torch.zeros(3)})[0]["x"],
                           torch.full((3,), 2.0))

    def test_train_state_resumes_exactly(self, tmp_path):
        cfg = dataclasses.replace(get_config("rwkv6-1.6b").reduced(), num_layers=1)
        dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=2)
        step = tstep.make_train_step(cfg)
        a = tstep.init_train_state(cfg, 0, device="cpu", compress=False)
        a, _ = step(a, make_batch(dcfg, 0, device="cpu"))
        ckpt.save(tmp_path, 1, a)
        b, s = ckpt.restore(tmp_path, tstep.init_train_state(cfg, 9, device="cpu"))
        assert s == 1
        a, ma = step(a, make_batch(dcfg, 1, device="cpu"))
        b, mb = step(b, make_batch(dcfg, 1, device="cpu"))
        assert float(ma["loss"]) == float(mb["loss"])
        for x, y in zip(tree_leaves(a), tree_leaves(b)):
            assert torch.equal(x, y)


class TestFaultTolerance:
    def test_watchdog_timeout(self):
        with pytest.raises(StepTimeout):
            StepWatchdog(timeout_s=0.2).run(lambda: time.sleep(2.0))

    def test_watchdog_passthrough(self):
        assert StepWatchdog(timeout_s=5.0).run(lambda: 42) == 42

    def test_straggler_detector(self):
        det = StragglerDetector(threshold=2.0)
        for _ in range(10):
            det.observe(1.0)
        assert det.observe(5.0) is True
        assert det.observe(1.0) is False
        assert det.flagged == 1

    def test_restart_loop_survives_injected_failures(self):
        saved = {}
        fail_at, seen = {7, 13}, []

        def step_fn(state, step):
            if step in fail_at and step not in seen:
                seen.append(step)
                raise NodeFailure(f"injected at {step}")
            return {"x": state["x"] + 1.0}

        def save_fn(state, step):
            saved["state"], saved["step"] = state, step

        def restore_fn():
            return (saved["state"], saved["step"]) if "state" in saved else None

        state, stats = run_with_restarts(
            make_state=lambda: {"x": torch.tensor(0.0)}, step_fn=step_fn,
            save_fn=save_fn, restore_fn=restore_fn, num_steps=20,
            checkpoint_every=5, max_restarts=5)
        assert stats["restarts"] == 2
        assert float(state["x"]) == 20.0


def test_launcher_smoke_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "rwkv6-1.6b",
         "--smoke", "--device", "cpu", "--steps", "4", "--seq", "64"],
        env=env, capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    last = res.stdout.strip().splitlines()[-1]
    assert last.startswith("done: steps=4")
    first, final = (float(x) for x in last.split("loss ")[1].split(" -> "))
    assert final < first
