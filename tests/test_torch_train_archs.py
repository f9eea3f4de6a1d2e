"""Training of every arch in the port against the reference's, on the CPU.

For each of the ten reduced f32 configs (one module fixture an arch:
parameters from the reference's ``init_params`` through
``convert.params_from_jax``, one numpy batch from the step-keyed data
stream, two rows to each of the config's own microbatches):

* the port's ``make_loss_fn`` loss and every gradient leaf on the first
  microbatch against ``jax.value_and_grad`` of the reference's
  ``make_loss_fn`` (qwen2-vl with the patch embeddings and (3, B, T) M-RoPE
  positions of tests/test_arch_smoke.py, seamless-m4t with encoder frames);
* one ``make_train_step`` step over all the microbatches: its loss and
  grad norm against the mean of the reference's over the microbatches;
* ``remat`` "none", "full" and "dots" give equal grads.

Then the launcher (``--smoke --device cpu``) on recurrentgemma-2b and
gemma3-1b, and the port's ``train_lm`` example at a tiny width.  The CUDA
kernels' backward is held to its plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py's phase 2c).

Tolerances: GRAD_TOL = 1e-4 of each leaf's largest value (plus 1e-4
relative), as tests/test_torch_train.py (the same f32 math in another
order agrees to about 1e-6 here); the loss to 1e-5 relative, the grad norm
to 1e-4 relative.  The remat variants recompute the same CPU arithmetic,
so their grads are held equal bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.model import model as JM
from repro.train import step as jstep
from repro_torch.configs.registry import get_config, list_archs
from repro_torch.data.pipeline import DataConfig, make_batch_numpy
from repro_torch.examples import train_lm
from repro_torch.launch import train as train_launch
from repro_torch.model import convert
from repro_torch.optim import adamw
from repro_torch.train import step as tstep
from repro_torch.tree import tree_leaves

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)

GRAD_TOL = 1e-4
SEQ = 32


def _close_leaves(got, want, tol=GRAD_TOL):
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.detach().float().numpy()
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol * max(1e-3, np.abs(w).max()))


def _numpy_batch(cfg, b, seed=0):
    """tokens and labels from the data stream, and the arch's extra inputs
    as tests/test_arch_smoke.py makes them."""
    nb = make_batch_numpy(DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                     global_batch=b, seed=seed), 0)
    rng = np.random.default_rng(seed)
    if cfg.frontend == "vision":
        nb["frontend_embeds"] = rng.standard_normal((b, SEQ // 4, cfg.d_model)).astype(np.float32)
        nb["positions"] = np.broadcast_to(np.arange(SEQ, dtype=np.int32)[None, None],
                                          (3, b, SEQ)).copy()
    if cfg.is_enc_dec:
        nb["enc_embeds"] = rng.standard_normal((b, SEQ, cfg.d_model)).astype(np.float32)
    return nb


def _jbatch(nb):
    return {k: jnp.asarray(v.astype(np.int32) if v.dtype.kind in "iu" else v)
            for k, v in nb.items()}


def _tbatch(nb):
    return {k: torch.from_numpy(v.astype(np.int64) if v.dtype.kind in "iu" else v)
            for k, v in nb.items()}


def _micro(nb, i, n):
    """Microbatch i of n: rows i * B/n .. (i + 1) * B/n (batch axis 1 for
    M-RoPE positions), as both train steps split them."""
    def rows(k, v):
        axis = 1 if k == "positions" else 0
        m = v.shape[axis] // n
        return np.take(v, np.arange(i * m, (i + 1) * m), axis=axis)
    return {k: rows(k, v) for k, v in nb.items()}


@pytest.fixture(scope="module", params=list_archs())
def arch(request):
    """The reduced config, the reference's parameters, a batch of two rows
    a microbatch, and the reference's loss and grads on each microbatch
    (the MoE layer's capacity counts the tokens of a call, so a microbatched
    step is the mean over microbatches, not the whole batch's loss)."""
    cfg_j = jax_config(request.param).reduced()
    cfg = get_config(request.param).reduced()
    n = cfg.microbatch
    nb = _numpy_batch(cfg, 2 * n)
    params_j = JM.init_params(cfg_j, jax.random.key(0))
    fn = jax.jit(jax.value_and_grad(jstep.make_loss_fn(cfg_j)))
    per = [fn(params_j, _jbatch(_micro(nb, i, n))) for i in range(n)]
    losses = [float(loss) for loss, _ in per]
    grads = [[np.asarray(g) for g in jax.tree.leaves(gr)] for _, gr in per]
    params_np = jax.tree.map(np.asarray, params_j)
    return cfg, params_np, nb, losses, grads


def _params(params_np):
    params = convert.params_from_jax(params_np)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    return params


def _loss_and_grads(cfg, params_np, nb):
    params = _params(params_np)
    loss = tstep.make_loss_fn(cfg)(params, _tbatch(nb))
    return loss, torch.autograd.grad(loss, tree_leaves(params))


def test_loss_and_grads_match_reference(arch):
    cfg, params_np, nb, losses_j, grads_j = arch
    loss, grads = _loss_and_grads(cfg, params_np, _micro(nb, 0, cfg.microbatch))
    assert loss.item() == pytest.approx(losses_j[0], rel=1e-5)
    _close_leaves(grads, grads_j[0])


def test_train_step_matches_reference(arch):
    cfg, params_np, nb, losses_j, grads_j = arch
    params = _params(params_np)
    state = tstep.TrainState(params, adamw.init_state(params), None)
    assert cfg.microbatch > 1
    state, metrics = tstep.make_train_step(cfg)(state, _tbatch(nb))
    mean = [np.mean(np.stack(leaf).astype(np.float64), axis=0) for leaf in zip(*grads_j)]
    norm_j = float(np.sqrt(sum(float((g ** 2).sum()) for g in mean)))
    assert float(metrics["loss"]) == pytest.approx(float(np.mean(losses_j)), rel=1e-5)
    assert float(metrics["grad_norm"]) == pytest.approx(norm_j, rel=1e-4)
    assert all(bool(torch.isfinite(p).all()) for p in tree_leaves(state.params))


def test_remat_policies_give_equal_grads(arch):
    cfg, params_np, nb, _, _ = arch
    grads = {}
    micro = _micro(nb, 0, cfg.microbatch)
    for remat in ("none", "full", "dots"):
        _, grads[remat] = _loss_and_grads(dataclasses.replace(cfg, remat=remat), params_np, micro)
    for remat in ("full", "dots"):
        assert all(torch.equal(a, b) for a, b in zip(grads["none"], grads[remat])), remat


@pytest.mark.parametrize("name", ["recurrentgemma-2b", "gemma3-1b"])
def test_launcher_smoke_trains_on_cpu(name, capsys):
    assert train_launch.main(["--arch", name, "--smoke", "--device", "cpu", "--steps", "2",
                              "--seq", "32"]) == 0
    assert "done: steps=2 restarts=0" in capsys.readouterr().out


def test_train_lm_example_runs_at_a_tiny_width(tmp_path, capsys):
    assert train_lm.main(["--d-model", "64", "--steps", "2", "--seq", "16", "--batch", "2",
                          "--ckpt-dir", str(tmp_path), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "qwen2-100m" in out and "done: steps=2 restarts=0" in out
