"""The port's dense layers sharded on a (data, model) mesh, on the CPU.

Meshes of repeated ``cpu`` devices, (data=2, model=4) and (data=4,
model=2), under the train and prefill rules of ``make_rules``, with
``fsdp_gather_weights`` off (the activations move) and on (the weights
are all-gathered), for the nine decoder-only archs' reduced f32 configs
(``microbatch=2`` so that a batch of 8 rows splits over both meshes'
data axes in every microbatch; the port's seeded ``init_params``, handed
to the reference as numpy and back through ``convert.params_from_jax``):

* the forward's logits against the port's unsharded forward and the
  reference's ``forward`` (TOL = 1e-4, as tests/test_torch_archs.py);
* the train step's loss and every gradient leaf against the port's
  unsharded loss and grads and the mean of the reference's over the
  microbatches (loss to 1e-5 relative, grads to GRAD_TOL = 1e-4 of each
  leaf's largest value, as tests/test_torch_train_archs.py), then one
  ``make_train_step`` step against the unsharded step: both moments to
  GRAD_TOL, every updated parameter by tests/test_torch_train.py's rule for
  a first AdamW step;
* the MoE gather path's dropped (token, k) set equals the reference's on
  every shard, at a capacity factor that drops;
* every layer kind's logged hops (kind, axis, count, elements, dtype)
  equal their closed forms (``repro_torch.analysis.dense_hops``), and
  ``fsdp_gather_weights`` moves weight bytes where its absence moves
  activation bytes;
* ``checkpoint.restore(..., shardings=)`` places a sharded train state,
  saved from a (4, 2) mesh, onto a (2, 4) mesh shard for shard as the
  reference's elastic restore does (``jax.device_put`` onto a
  ``NamedSharding`` of 8 fake host devices, in a subprocess).
"""

import dataclasses
import os
import subprocess
import sys
import textwrap
from collections import Counter
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.model import model as JM
from repro.model import moe as JMoE
from repro.model.sharding import init_mk as jax_mk
from repro.train import step as jstep
from repro_torch.analysis import dense_hops
from repro_torch.checkpoint import checkpoint as C
from repro_torch.configs.registry import get_config, list_archs
from repro_torch.core.device_comm import record_hops
from repro_torch.launch import mesh as mesh_mod
from repro_torch.model import convert
from repro_torch.model import model as M
from repro_torch.model import moe as MoE
from repro_torch.model import sharding as S
from repro_torch.optim import adamw
from repro_torch.train import step as T
from repro_torch.tree import tree_leaves, tree_map

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)

TOL = 1e-4
GRAD_TOL = 1e-4
SEQ, B, N_MICRO = 16, 8, 2
MESHES = [(2, 4), (4, 2)]
DECODER = [a for a in list_archs() if not get_config(a).is_enc_dec]
SRC = str(Path(__file__).resolve().parents[1] / "src")


def _close(got, want, tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(1e-3, np.abs(want).max()))


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, SEQ))
    nb = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
    if cfg.frontend == "vision":
        nb["frontend_embeds"] = rng.standard_normal((B, SEQ // 4, cfg.d_model)).astype(
            np.float32)
        pos = np.broadcast_to(np.arange(SEQ)[None, None], (3, B, SEQ)).copy()
        pos[:, :, 4:] += 3                                   # the streams differ
        pos[1] += 1
        nb["positions"] = pos
    return nb


def _t(nb):
    return {k: torch.from_numpy(v) for k, v in nb.items()}


def _j(nb):
    return {k: jnp.asarray(v.astype(np.int32) if v.dtype.kind in "iu" else v)
            for k, v in nb.items()}


def _kw(batch):
    return {k: v for k, v in batch.items() if k in ("frontend_embeds", "positions")}


def _micro(nb, i):
    def rows(k, v):
        axis = 1 if k == "positions" else 0
        m = v.shape[axis] // N_MICRO
        return np.take(v, np.arange(i * m, (i + 1) * m), axis=axis)
    return {k: rows(k, v) for k, v in nb.items()}


@pytest.fixture(scope="module", params=DECODER)
def arch(request):
    """The reduced configs, the reference's params, a batch, the
    reference's logits and mean loss and grads over the microbatches, and
    the port's unsharded loss, grads and one train step."""
    cfg_j = dataclasses.replace(jax_config(request.param).reduced(), microbatch=N_MICRO)
    cfg = dataclasses.replace(get_config(request.param).reduced(), microbatch=N_MICRO)
    leaves = [p.numpy() for p in tree_leaves(M.init_params(cfg, 0, device="cpu"))]
    params_np = jax.tree.unflatten(jax.tree.structure(JM.abstract_params(cfg_j)), leaves)
    params_j = jax.tree.map(jnp.asarray, params_np)
    nb = _batch(cfg)
    jb = _j(nb)
    ref_logits = np.asarray(JM.forward(params_j, cfg_j, jb["tokens"], **_kw(jb)))
    fn = jax.jit(jax.value_and_grad(jstep.make_loss_fn(cfg_j)))
    per = [fn(params_j, _j(_micro(nb, i))) for i in range(N_MICRO)]
    ref_loss = float(np.mean([float(loss) for loss, _ in per]))
    ref_grads = [np.mean([np.asarray(g) for g in gs], axis=0)
                 for gs in zip(*(jax.tree.leaves(gr) for _, gr in per))]
    state = _state(cfg, params_np)
    loss, grads = _unsharded_grads(cfg, state.params, _t(nb))
    stepped, metrics = T.make_train_step(cfg)(_state(cfg, params_np), _t(nb))
    return dict(cfg=cfg, params_np=params_np, nb=nb, ref_logits=ref_logits,
                ref_loss=ref_loss, ref_grads=ref_grads, loss=loss, grads=grads,
                stepped=stepped, metrics=metrics)


def _state(cfg, params_np):
    params = convert.params_from_jax(params_np)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    return T.TrainState(params, adamw.init_state(params))


def _unsharded_grads(cfg, params, batch):
    lf = T.make_loss_fn(cfg)
    leaves = tree_leaves(params)
    acc, total = [torch.zeros(p.shape) for p in leaves], 0.0
    for i in range(N_MICRO):
        mb = {k: v[:, i * 4:(i + 1) * 4] if k == "positions" else v[i * 4:(i + 1) * 4]
              for k, v in batch.items()}
        loss = lf(params, mb)
        for a, g in zip(acc, torch.autograd.grad(loss, leaves)):
            a.add_(g)
        total += loss.item()
    return total / N_MICRO, [a / N_MICRO for a in acc]


def _mesh(shape, device="cpu"):
    return mesh_mod.make_debug_mesh(*shape, device=device)


@pytest.mark.parametrize("fsdp", [False, True], ids=["move-activations", "gather-weights"])
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_forward_and_train_step_match(arch, shape, fsdp):
    cfg = dataclasses.replace(arch["cfg"], fsdp_gather_weights=fsdp)
    nb, batch = arch["nb"], _t(arch["nb"])
    mesh = _mesh(shape)
    # The prefill forward: logits against the port's and the reference's.
    rules = S.make_rules(mesh, "prefill")
    with S.sharding_context(mesh, rules):
        params = S.device_put_tree(convert.params_from_jax(arch["params_np"]),
                                   M.param_pspecs(cfg, rules), mesh)
        logits = M.forward(params, cfg, batch["tokens"], **_kw(batch))
    assert logits.spec == S.P("data", None, "model")
    got = S.to_global(logits)
    _close(got, arch["ref_logits"])
    plain = M.forward(convert.params_from_jax(arch["params_np"]), cfg, batch["tokens"],
                      **_kw(batch))
    _close(got, plain)
    # The train step: loss and grads, then one step.
    rules = S.make_rules(mesh, "train")
    with S.sharding_context(mesh, rules):
        state = T.shard_train_state(_state(cfg, arch["params_np"]), cfg, mesh, rules)
        loss, grads = T.sharded_loss_and_grads(state.params, batch, T.make_loss_fn(cfg),
                                               N_MICRO)
        grads = [S.to_global(g) for g in tree_leaves(grads)]
        assert loss.item() == pytest.approx(arch["ref_loss"], rel=1e-5)
        assert loss.item() == pytest.approx(arch["loss"], rel=1e-5)
        for g, w, u in zip(grads, arch["ref_grads"], arch["grads"], strict=True):
            _close(g, w, GRAD_TOL)
            _close(g, u, GRAD_TOL)
        state, metrics = T.make_train_step(cfg)(state, batch)
    assert metrics["loss"].item() == pytest.approx(arch["metrics"]["loss"].item(), rel=1e-5)
    assert metrics["grad_norm"].item() == pytest.approx(arch["metrics"]["grad_norm"].item(),
                                                        rel=1e-4)
    want = arch["stepped"]
    for tree, ref in ((state.opt.mu, want.opt.mu), (state.opt.nu, want.opt.nu)):
        for a, w in zip(tree_leaves(tree), tree_leaves(ref), strict=True):
            _close(S.to_global(a), w.numpy(), GRAD_TOL)
    # tests/test_torch_train.py's rule for a first AdamW step, which moves a
    # parameter by about lr * g / |g|: 1e-5 where |mu| > 1e-7 (a gradient
    # above 1e-6), and 2 * lr, the largest first step, everywhere.
    lr = float(metrics["lr"])
    for a, w, mu in zip(tree_leaves(state.params), tree_leaves(want.params),
                        tree_leaves(want.opt.mu), strict=True):
        diff = (S.to_global(a) - w).abs().detach().numpy()
        assert diff.max() <= 2 * lr
        assert diff[mu.abs().numpy() > 1e-7].max(initial=0.0) <= 1e-5
    assert S.to_global(state.opt.step).item() == 1


# --------------------------------------------------------------------------
# The MoE dropped set
# --------------------------------------------------------------------------

def _ref_dropped(pj, cfg_j, x, cf):
    """The reference's dropped (token, k) pairs, rebuilt in numpy with its
    rule (stable sort by expert, each keeping its first ``cap``)."""
    n = x.shape[0] * x.shape[1]
    e, k = cfg_j.num_experts, cfg_j.num_experts_per_tok
    logits = jnp.asarray(x.reshape(n, -1)) @ pj["router"]
    _, ex = (np.asarray(a) for a in JMoE._topk_routing(logits, k))
    cap = -(-max(1, int(n * k * cf / e)) // 8) * 8
    flat = ex.reshape(-1)
    order = np.argsort(flat, kind="stable")
    rank = np.empty(n * k, np.int64)
    for expert in range(e):
        idx = order[flat[order] == expert]
        rank[idx] = np.arange(idx.size)
    return cap, (rank >= cap).reshape(n, k)


@pytest.mark.parametrize("name,fsdp", [("dbrx-132b", False), ("qwen3-moe-235b-a22b", True)])
def test_moe_dropped_set_is_the_reference(name, fsdp, monkeypatch):
    cf = 0.3
    cfg_j = jax_config(name).reduced()
    cfg = dataclasses.replace(get_config(name).reduced(), fsdp_gather_weights=fsdp)
    pj = JMoE.init_moe(jax_mk(jax.random.key(3), jnp.float32), cfg_j, "moe")
    x = np.random.default_rng(3).standard_normal((8, 12, cfg.d_model)).astype(np.float32)
    want = np.asarray(JMoE.apply_moe(pj, jnp.asarray(x), cfg_j, capacity_factor=cf))
    cap, dropped = _ref_dropped(pj, cfg_j, x, cf)
    assert 0 < dropped.sum() < dropped.size
    seen = []
    place = MoE.place
    monkeypatch.setattr(MoE, "place", lambda *a, **k: seen.append(place(*a, **k)) or seen[-1])
    mesh = _mesh((2, 4))
    rules = S.make_rules(mesh, "prefill")
    with S.sharding_context(mesh, rules):
        specs = MoE.init_moe(S.spec_mk(rules), cfg, "moe")
        params = S.device_put_tree(convert.params_from_jax(jax.tree.map(np.asarray, pj)),
                                   specs, mesh)
        xs = S.device_put(torch.from_numpy(x), S.NamedSharding(mesh, S.P("data")))
        got = S.to_global(MoE.apply_moe(params, xs, cfg, capacity_factor=cf))
    _close(got, want)
    assert len(seen) == 8                        # every shard routes every token
    for route in seen:
        assert route.cap == cap
        assert np.array_equal((route.slot == cfg.num_experts * cap).numpy(), dropped)


# --------------------------------------------------------------------------
# The collectives against their closed forms
# --------------------------------------------------------------------------

LAYERS = [("mlp", "qwen2-0.5b"), ("mlp", "nemotron-4-15b"), ("attn", "qwen2-0.5b"),
          ("attn", "gemma3-1b"), ("rwkv", "rwkv6-1.6b"), ("rec", "recurrentgemma-2b"),
          ("moe", "qwen3-moe-235b-a22b"), ("moe_a2a", "dbrx-132b"), ("embed", "qwen2-0.5b"),
          ("logits", "gemma3-1b"), ("logits", "minitron-8b")]


def _layer(kind, cfg, params, x, tokens):
    from repro_torch.model import attention, layers, moe_a2a, recurrent

    blk = lambda: tree_map(lambda v: v.unbind()[0] if v.ndim else v,  # noqa: E731
                           params["decoder"]["scanned"][0])
    if kind == "mlp":
        return layers.apply_mlp(blk()["ffn"], x, cfg)
    if kind == "attn":
        return attention.apply_attention(blk()["attn"], x, cfg, kind="attn")[0]
    if kind == "rwkv":
        return recurrent.apply_rwkv_block(blk()["rwkv"], x, cfg)[0]
    if kind == "rec":
        return recurrent.apply_rglru_block(blk()["rec"], x, cfg)[0]
    if kind == "moe":
        return MoE.apply_moe(blk()["ffn"], x, cfg)
    if kind == "moe_a2a":
        return moe_a2a.apply_moe_sharded(blk()["ffn"], x, cfg)
    if kind == "embed":
        return layers.embed_tokens(params["tok"], tokens, cfg)
    return layers.logits_projection(params["tok"], x, cfg)


@pytest.mark.parametrize("fsdp", [False, True], ids=["move-activations", "gather-weights"])
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind,name", LAYERS, ids=[f"{k}-{n}" for k, n in LAYERS])
def test_layer_hops_equal_their_closed_forms(kind, name, shape, fsdp):
    cfg = dataclasses.replace(get_config(name).reduced(), fsdp_gather_weights=fsdp,
                              moe_impl="a2a" if kind == "moe_a2a" else "gather")
    if kind == "rec":
        cfg = dataclasses.replace(cfg, pattern=("rec",))
    if kind == "attn":
        cfg = dataclasses.replace(cfg, pattern=("attn",))
    mesh = _mesh(shape)
    rules = S.make_rules(mesh, "train")
    gen = torch.Generator().manual_seed(0)
    with S.sharding_context(mesh, rules):
        params = S.device_put_tree(M.init_params(cfg, 0, device="cpu"),
                                   M.param_pspecs(cfg, rules), mesh)
        x = S.device_put(torch.randn(B, SEQ, cfg.d_model, generator=gen),
                         S.NamedSharding(mesh, S.P("data")))
        tokens = S.device_put(torch.randint(0, cfg.vocab_size, (B, SEQ), generator=gen),
                              S.NamedSharding(mesh, S.P("data")))
        with record_hops() as hops:
            _layer(kind, cfg, params, x, tokens)
    got = Counter((h.kind, h.axis, h.elements, h.itemsize) for h in hops)
    assert got == dense_hops.layer_hops(cfg, kind, *shape, B, SEQ, 4)
    assert all(h.axis in ("data", "model") for h in hops)


TRAIN_HOPS = [("rwkv6-1.6b", "full", (2, 4), True), ("gemma3-1b", "dots", (4, 2), False),
              ("recurrentgemma-2b", "full", (4, 2), False), ("dbrx-132b", "none", (2, 4), False),
              ("qwen3-moe-235b-a22b", "full", (2, 4), True)]


@pytest.mark.parametrize("name,remat,shape,fsdp", TRAIN_HOPS,
                         ids=[f"{n}-{r}-{s[0]}x{s[1]}-{f}" for n, r, s, f in TRAIN_HOPS])
def test_train_step_hops_equal_their_closed_form(name, remat, shape, fsdp):
    """A whole sharded train step (two microbatches): the forwards, the
    recompute of each period up to its last saved tensor, the backward's
    transposes, the data-parallel all-reduce of every replicated leaf and
    the clip's norm (``dense_hops.train_hops``)."""
    cfg = dataclasses.replace(get_config(name).reduced(), microbatch=N_MICRO, remat=remat,
                              fsdp_gather_weights=fsdp,
                              moe_impl="a2a" if name == "dbrx-132b" else "gather")
    toks = torch.randint(0, cfg.vocab_size, (B, SEQ), generator=torch.Generator().manual_seed(0))
    mesh = _mesh(shape)
    rules = S.make_rules(mesh, "train")
    with S.sharding_context(mesh, rules):
        state = T.shard_train_state(T.init_train_state(cfg, 0, device="cpu"), cfg, mesh, rules)
        with record_hops() as hops:
            T.make_train_step(cfg)(state, {"tokens": toks, "labels": toks.roll(-1, 1)})
    specs = tree_leaves(M.param_pspecs(cfg, rules))
    leaves = []
    for p, spec in zip(tree_leaves(M.init_params(cfg, 0, device="cpu")), specs, strict=True):
        axes = {a for part in spec if part for a in (part if isinstance(part, tuple) else (part,))}
        local = p.numel()
        for a in axes:
            local //= mesh.shape[a]
        leaves.append((local, tuple(a for a in ("data", "model") if a not in axes)))
    got = Counter((h.kind, h.axis, h.elements, h.itemsize) for h in hops)
    assert got == dense_hops.train_hops(cfg, *shape, B, SEQ, 4, leaves)


@pytest.mark.parametrize("name", ["qwen2-0.5b", "rwkv6-1.6b", "recurrentgemma-2b"])
def test_weight_gathering_moves_weights_where_its_absence_moves_activations(name):
    """The bytes one forward sends over the data axis at 32 and 64 tokens a
    row: with ``fsdp_gather_weights`` all-gathers of weight shards alone,
    the same at both lengths; without, the activations, twice the bytes at
    twice the tokens."""
    moved = {}
    for fsdp in (False, True):
        cfg = dataclasses.replace(get_config(name).reduced(), fsdp_gather_weights=fsdp)
        mesh = _mesh((4, 2))
        rules = S.make_rules(mesh, "train")
        for t in (32, 64):
            with S.sharding_context(mesh, rules):
                params = S.device_put_tree(M.init_params(cfg, 0, device="cpu"),
                                           M.param_pspecs(cfg, rules), mesh)
                with record_hops() as hops:
                    M.forward(params, cfg, torch.zeros(B, t, dtype=torch.long))
            moved[fsdp, t] = Counter()
            for h in hops:
                if h.axis == "data":
                    moved[fsdp, t][h.kind] += h.bytes
    # Gathering: the weights' all-gathers, the same at both lengths.  RWKV's
    # decay LoRA takes no gather_for_use in the reference either: its
    # activations cross the data axis in both modes.
    lora = {"all_to_all", "reduce_scatter"} if name == "rwkv6-1.6b" else set()
    assert set(moved[True, 32]) == {"all_gather"} | lora
    assert moved[True, 32]["all_gather"] == moved[True, 64]["all_gather"] > 0
    # Moving activations: their all-to-alls and reduce-scatters, twice the
    # bytes at twice the tokens.
    for kind in ("all_to_all", "reduce_scatter"):
        assert moved[False, 64][kind] == 2 * moved[False, 32][kind] > 0
        assert moved[False, 32][kind] > moved[True, 32][kind]


# --------------------------------------------------------------------------
# restore(shardings=) against the reference's elastic restore
# --------------------------------------------------------------------------

RESTORE_SCRIPT = textwrap.dedent(
    """
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.checkpoint import checkpoint as C
    from repro.configs.registry import get_config
    from repro.model.sharding import make_rules
    from repro.train import step as T

    mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("data", "model"))
    cfg = get_config(sys.argv[2]).reduced()
    specs = T.train_state_pspecs(cfg, make_rules(mesh, "train"))
    shardings = jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                             is_leaf=lambda x: isinstance(x, P))
    tree, step = C.restore(sys.argv[1], T.abstract_train_state(cfg), shardings=shardings)
    out = {}
    pos = {d.id: np.argwhere(mesh.devices == d)[0] for d in mesh.devices.flat}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(C._path_str(p) for p in path)
        for sh in leaf.addressable_shards:
            i, j = pos[sh.device.id]
            out[f"{key}@{i},{j}"] = np.asarray(sh.data)
    np.savez(sys.argv[3], **out)
    print("RESTORE_REF_OK", step)
    """
)


def test_restore_with_shardings_places_as_the_reference(tmp_path):
    name = "qwen2-0.5b"
    cfg = dataclasses.replace(get_config(name).reduced(), microbatch=N_MICRO)
    toks = torch.randint(0, cfg.vocab_size, (B, SEQ), generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks, "labels": toks.roll(-1, 1)}
    src, dst = _mesh((4, 2)), _mesh((2, 4))
    with S.sharding_context(src, S.make_rules(src, "train")):
        state = T.shard_train_state(T.init_train_state(cfg, 0, device="cpu"), cfg, src,
                                    S.make_rules(src, "train"))
        state, _ = T.make_train_step(cfg)(state, batch)
        C.save(tmp_path / "ckpt", 1, state)
    rules = S.make_rules(dst, "train")
    shardings = tree_map(lambda s: S.NamedSharding(dst, s), T.train_state_pspecs(cfg, rules))
    with S.sharding_context(dst, rules):
        got, step = C.restore(tmp_path / "ckpt", state, shardings=shardings)
    assert step == 1
    env = {"PYTHONPATH": SRC, "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "HOME": os.environ.get("HOME", "/tmp"), "JAX_PLATFORMS": "cpu"}
    out = tmp_path / "ref.npz"
    res = subprocess.run([sys.executable, "-c", RESTORE_SCRIPT, str(tmp_path / "ckpt"), name,
                          str(out)], capture_output=True, text=True, env=env, timeout=600)
    assert res.returncode == 0, f"stdout:\n{res.stdout}\nstderr:\n{res.stderr[-3000:]}"
    with np.load(out) as z:
        ref = dict(z)
    from repro_torch.tree import tree_paths

    n = 0
    for key, leaf in tree_paths(got):
        spec = tuple(tree_leaves(T.train_state_pspecs(cfg, rules))[n])
        while spec and spec[-1] is None:
            spec = spec[:-1]
        assert leaf.mesh is dst and tuple(leaf.sharding.spec) == spec
        for cell in leaf.cells():
            want = ref[f"{key}@{cell[0]},{cell[1]}"]
            have = leaf.shards[cell]
            assert have.requires_grad == key.startswith("params/")
            np.testing.assert_array_equal(have.detach().numpy(), want)
        n += 1
    assert len(ref) == 8 * n
    # The restored state trains on: its next step equals the saved state's.
    with S.sharding_context(dst, rules):
        _, m_restored = T.make_train_step(cfg)(got, batch)
    with S.sharding_context(src, S.make_rules(src, "train")):
        _, m_saved = T.make_train_step(cfg)(state, batch)
    assert m_restored["loss"].item() == pytest.approx(m_saved["loss"].item(), rel=1e-6)
