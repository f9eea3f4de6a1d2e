"""The port's decode rules and its encoder-decoder arch sharded on a (data,
model) mesh, on the CPU.

Meshes of repeated ``cpu`` devices (``launch.mesh.make_debug_mesh``),
(data=2, model=4) and (data=4, model=2) under ``make_rules(mesh,
"decode")`` (batch over data, the KV sequence over model) and (2, 4)
under ``"decode_long"`` (batch whole, the KV sequence over both axes), for
the reduced f32 configs of rwkv6-1.6b, recurrentgemma-2b, gemma3-1b,
qwen2-0.5b, qwen3-moe-235b-a22b and seamless-m4t-large-v2 (the local
archs' window cut to 8 in both frameworks, so that their 16-slot rings
wrap; the port's seeded ``init_params``, handed to the reference as numpy
and back through ``convert.params_from_jax``).  Each case runs a ragged
prompt window (4 rows of 8, 5, 8 and 3 tokens), a second window of 8
tokens a row and then 3 single-token steps:

* the logits against the port's unsharded ``decode_step`` and the
  reference's (TOL = 1e-4, as tests/test_torch_archs.py), the state after
  the last step, gathered, against the unsharded state;
* the hops of the window and of a single step equal their closed forms
  (``repro_torch.analysis.dense_hops.decode_hops``);
* across a single step, every KV slot that no row writes is bit-identical
  on every shard.

Seamless's sharded forward (prefill rules) and one train step (train
rules) are held to the port's unsharded ones and the reference's, their
hops to ``dense_hops.forward_hops`` and ``train_hops``.
"""

import dataclasses
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.model import layers as JL
from repro.model import model as JM
from repro.model import transformer as JT
from repro.train import step as jstep
from repro_torch.analysis import dense_hops
from repro_torch.configs.registry import get_config
from repro_torch.core.device_comm import record_hops
from repro_torch.launch import mesh as mesh_mod
from repro_torch.model import attention as A
from repro_torch.model import convert
from repro_torch.model import model as M
from repro_torch.model import sharding as S
from repro_torch.train import step as T
from repro_torch.tree import tree_leaves

jax.config.update("jax_platform_name", "cpu")
torch.set_num_threads(1)

TOL = 1e-4
GRAD_TOL = 1e-4
B, K, MAX_LEN, FRAMES, STEPS = 4, 8, 64, 16, 3
WINDOW = 8
COUNTS = np.array([8, 5, 8, 3], np.int32)
ARCHS = ["rwkv6-1.6b", "recurrentgemma-2b", "gemma3-1b", "qwen2-0.5b",
         "qwen3-moe-235b-a22b", "seamless-m4t-large-v2"]
CASES = [("decode", (2, 4)), ("decode", (4, 2)), ("decode_long", (2, 4))]


def _cfgs(name):
    cfg_j, cfg = jax_config(name).reduced(), get_config(name).reduced()
    if cfg.attn_window:
        cfg_j = dataclasses.replace(cfg_j, attn_window=WINDOW)
        cfg = dataclasses.replace(cfg, attn_window=WINDOW)
    return cfg_j, cfg


def _inputs(cfg):
    rng = np.random.default_rng(0)
    window = rng.integers(0, cfg.vocab_size, (2, B, K)).astype(np.int32)
    steps = rng.integers(0, cfg.vocab_size, (STEPS, B, 1)).astype(np.int32)
    mask = np.arange(K)[None] < COUNTS[:, None]
    frames = rng.standard_normal((B, FRAMES, cfg.d_model)).astype(np.float32)
    return window, steps, mask, frames


def _jax_encode(pj, cfg_j, frames):
    """The reference's encoder half (its ``forward``'s lines before the
    decoder)."""
    enc_cfg = dataclasses.replace(cfg_j, pattern=("attn",), num_experts=0)
    ex, _ = JT.apply_stack(pj["encoder"], jnp.asarray(frames), enc_cfg, causal=False,
                           num_layers=cfg_j.encoder_layers)
    return JL.rms_norm(pj["enc_final_norm"], ex, cfg_j.norm_eps)


def _decode_all(step, state, window, steps, mask, enc_out, tensor):
    """The ragged window, the full one, then STEPS single tokens: every
    call's logits."""
    logits, state = step(state, tensor(window[0]), tensor(np.zeros(B, np.int32)),
                         tensor(mask), enc_out)
    out = [logits]
    logits, state = step(state, tensor(window[1]), tensor(COUNTS), None, enc_out)
    out.append(logits)
    for i in range(STEPS):
        logits, state = step(state, tensor(steps[i]), tensor(COUNTS + K + i), None, enc_out)
        out.append(logits)
    return out, state


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    """The configs, the port's params as numpy, the inputs, and the
    reference's and the port's unsharded logits and final state."""
    cfg_j, cfg = _cfgs(request.param)
    # decode_long on (2, 4) splits the KV sequence widest: over all 8 shards.
    widest = mesh_mod.make_debug_mesh(2, 4, device="cpu")
    iw = M.split_insert_window(cfg, K, widest, S.make_rules(widest, "decode_long"))
    leaves = [p.numpy() for p in tree_leaves(M.init_params(cfg, 0, device="cpu"))]
    params_np = jax.tree.unflatten(jax.tree.structure(JM.abstract_params(cfg_j)), leaves)
    pj = jax.tree.map(jnp.asarray, params_np)
    window, steps, mask, frames = _inputs(cfg)
    enc_j = _jax_encode(pj, cfg_j, frames) if cfg.is_enc_dec else None

    def step_j(state, tokens, lengths, token_mask, enc_out):
        return JM.decode_step(pj, cfg_j, state, tokens, lengths, enc_out=enc_out,
                              token_mask=token_mask, max_len=MAX_LEN)

    ref, _ = _decode_all(step_j, JM.init_decode_state(cfg_j, B, MAX_LEN, iw), window, steps,
                         mask, enc_j, jnp.asarray)
    pt = convert.params_from_jax(params_np)
    enc_t = M.encode(pt, cfg, torch.from_numpy(frames)) if cfg.is_enc_dec else None

    def step_t(state, tokens, lengths, token_mask, enc_out):
        return M.decode_step(pt, cfg, state, tokens.long(), lengths, enc_out=enc_out,
                             token_mask=token_mask, max_len=MAX_LEN)

    plain, state = _decode_all(step_t, M.init_decode_state(cfg, B, MAX_LEN, iw, device="cpu"),
                               window, steps, mask, enc_t, torch.from_numpy)
    return dict(cfg=cfg, iw=iw, params_np=params_np, inputs=(window, steps, mask),
                enc_out=enc_t, ref=[np.asarray(x) for x in ref], plain=plain, state=state)


def _close(got, want, tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    want = want.detach().float().numpy() if isinstance(want, torch.Tensor) else np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * max(1e-3, np.abs(want).max()))


def _hops(log):
    return Counter((h.kind, h.axis, h.elements, h.itemsize) for h in log)


def _kv_leaves(state):
    return [leaf for node in M.state_nodes(state) if isinstance(node, A.KVCache)
            for leaf in (node.k, node.v)]


def _untouched_slots_kept(before, after, lengths):
    """Every shard's slots of a KV leaf that no row's single token (at
    position ``lengths[b]``, its ring slot that mod the cache's length)
    lands on hold the bits they held."""
    for old, new in zip(before, after, strict=True):
        s = new.shape[-2]
        for c in new.cells():
            lo = S.offset(new, new.ndim - 2, c)
            rows = S.offset(new, new.ndim - 4, c)
            n = new.shards[c]
            for b in range(n.shape[-4]):
                keep = torch.ones(n.shape[-2], dtype=torch.bool)
                slot = int(lengths[rows + b]) % s - lo
                if 0 <= slot < n.shape[-2]:
                    keep[slot] = False
                assert torch.equal(old[c][..., b, :, keep, :], n[..., b, :, keep, :])


@pytest.mark.parametrize("mode,shape", CASES, ids=[f"{m}-{s[0]}x{s[1]}" for m, s in CASES])
def test_sharded_decode_matches(arch, mode, shape):
    cfg, iw = arch["cfg"], arch["iw"]
    window, steps, mask = arch["inputs"]
    mesh = mesh_mod.make_debug_mesh(*shape, device="cpu")
    rules = S.make_rules(mesh, mode)
    logs, before = [], None
    with S.sharding_context(mesh, rules):
        params = S.device_put_tree(convert.params_from_jax(arch["params_np"]),
                                   M.param_pspecs(cfg, rules), mesh)
        state = M.shard_decode_state(M.init_decode_state(cfg, B, MAX_LEN, iw, device="cpu"),
                                     mesh, rules)

        def step(st, tokens, lengths, token_mask, enc_out):
            nonlocal before
            if len(logs) == 3:              # the second single step: snapshot every shard
                before = [{c: leaf.shards[c].clone() for c in leaf.cells()}
                          for leaf in _kv_leaves(st)]
            with record_hops() as log:
                out = M.decode_step(params, cfg, st, tokens.long(), lengths, enc_out=enc_out,
                                    token_mask=token_mask, max_len=MAX_LEN)
            logs.append(log)
            if before is not None and len(logs) == 4:
                _untouched_slots_kept(before, _kv_leaves(out[1]), lengths)
            return out

        got, state = _decode_all(step, state, window, steps, mask, arch["enc_out"],
                                 torch.from_numpy)
    assert got[0].spec == S.P(rules["batch"], None, "model")
    for g, plain, ref in zip(got, arch["plain"], arch["ref"], strict=True):
        g = S.to_global(g)
        _close(g, plain)
        _close(g, ref)
    specs = tree_leaves(M.state_pspecs(arch["state"], rules))
    for a, w, spec in zip(tree_leaves(state), tree_leaves(arch["state"]), specs, strict=True):
        assert S.is_sharded(a) and a.spec == spec          # still in its spec layout
        _close(S.to_global(a), w)
    for log, t in ((logs[0], K), (logs[2], 1)):
        assert _hops(log) == dense_hops.decode_hops(cfg, *shape, B, t, 4, mode, s_enc=FRAMES)
        assert all(h.axis in ("data", "model") for h in log)


@pytest.mark.parametrize("mode,shape", CASES)
@pytest.mark.parametrize("k", [1, 8, 16])
def test_split_insert_window_is_the_least_that_splits(mode, shape, k):
    """``split_insert_window`` gives the least insert window >= k whose
    local ring splits over the KV sequence's shards, and the state built
    with it splits; a config without a local window keeps k."""
    mesh = mesh_mod.make_debug_mesh(*shape, device="cpu")
    rules = S.make_rules(mesh, mode)
    n = S.axes_size(mesh, rules["kv_seq"])
    cfg = _cfgs("gemma3-1b")[1]
    iw = M.split_insert_window(cfg, k, mesh, rules)
    assert iw >= k and (WINDOW + iw - 1) % n == 0
    assert all((WINDOW + w - 1) % n for w in range(k, iw))
    state = M.shard_decode_state(M.init_decode_state(cfg, B, MAX_LEN, iw, device="cpu"),
                                 mesh, rules)
    assert all(S.is_sharded(x) for x in tree_leaves(state))
    assert M.split_insert_window(_cfgs("rwkv6-1.6b")[1], k, mesh, rules) == k


def test_combine_merges_partials_exactly():
    """``combine_partials`` over both axes of a (2, 4) mesh equals the
    softmax of the whole row, in two hops an axis of their closed form;
    one shard's partial left out moves it."""
    gen = torch.Generator().manual_seed(0)
    logits = torch.randn(3, 5, 64, generator=gen) * 3
    v = torch.randn(3, 5, 64, 7, generator=gen)
    want = torch.einsum("bhs,bhsd->bhd", torch.softmax(logits, -1), v)[..., None, :]
    mesh = mesh_mod.make_debug_mesh(2, 4, device="cpu")

    def partials(drop=None):
        parts = [np.empty((2, 4), dtype=object) for _ in range(3)]
        for c in np.ndindex(2, 4):
            i = S.shard_index(mesh, c, ("data", "model"))
            lg, vv = logits[..., i * 8:(i + 1) * 8], v[..., i * 8:(i + 1) * 8, :]
            m = lg.amax(-1, keepdim=True)
            p = torch.exp(lg - m) * (0.0 if c == drop else 1.0)
            o = torch.einsum("bhs,bhsd->bhd", p, vv)
            for arr, z in zip(parts, (m, p.sum(-1, keepdim=True), o)):
                arr[c] = z[..., None, :]
        return [S.Sharded(mesh, ((), (), (), ()), arr, arr[0, 0].shape) for arr in parts]

    with record_hops() as log:
        out = S.combine_partials(*partials(), ("data", "model"))
    for c in out.cells():
        _close(out.shards[c], want, 1e-6)
    rows = 3 * 5
    assert _hops(log) == Counter({("all_reduce", "data", rows, 4): 4,
                                  ("all_reduce", "data", rows * 8, 4): 4,
                                  ("all_reduce", "model", rows * 3 // 2, 4): 2,
                                  ("all_reduce", "model", rows * 8 * 3 // 2, 4): 2})
    bad = S.combine_partials(*partials(drop=(1, 2)), ("data", "model"))
    assert (bad.shards[0, 0] - want).abs().max() > 1e-3


# --------------------------------------------------------------------------
# seamless-m4t under prefill and train rules
# --------------------------------------------------------------------------

SEQ, TRAIN_B, N_MICRO, ENC = 16, 8, 2, 24


@pytest.fixture(scope="module")
def seamless():
    name = "seamless-m4t-large-v2"
    cfg_j = dataclasses.replace(jax_config(name).reduced(), microbatch=N_MICRO)
    cfg = dataclasses.replace(get_config(name).reduced(), microbatch=N_MICRO)
    leaves = [p.numpy() for p in tree_leaves(M.init_params(cfg, 0, device="cpu"))]
    params_np = jax.tree.unflatten(jax.tree.structure(JM.abstract_params(cfg_j)), leaves)
    pj = jax.tree.map(jnp.asarray, params_np)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (TRAIN_B, SEQ)).astype(np.int32)
    nb = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1),
          "enc_embeds": rng.standard_normal((TRAIN_B, ENC, cfg.d_model)).astype(np.float32)}
    ref_logits = np.asarray(JM.forward(pj, cfg_j, jnp.asarray(tokens),
                                       enc_tokens_embeds=jnp.asarray(nb["enc_embeds"])))
    fn = jax.jit(jax.value_and_grad(jstep.make_loss_fn(cfg_j)))
    half = TRAIN_B // N_MICRO
    per = [fn(pj, {k: jnp.asarray(v[i * half:(i + 1) * half]) for k, v in nb.items()})
           for i in range(N_MICRO)]
    ref_loss = float(np.mean([float(loss) for loss, _ in per]))
    ref_grads = [np.mean([np.asarray(g) for g in gs], axis=0)
                 for gs in zip(*(jax.tree.leaves(gr) for _, gr in per))]
    batch = {k: torch.from_numpy(v.astype(np.int64) if v.dtype.kind == "i" else v)
             for k, v in nb.items()}
    pt = convert.params_from_jax(params_np)
    plain = M.forward(pt, cfg, batch["tokens"], enc_tokens_embeds=batch["enc_embeds"])
    for p in tree_leaves(pt):
        p.requires_grad_(True)
    lf = T.make_loss_fn(cfg)
    loss, grads = 0.0, None
    for i in range(N_MICRO):
        mb = {k: v[i * half:(i + 1) * half] for k, v in batch.items()}
        li = lf(pt, mb)
        g = [x / N_MICRO for x in torch.autograd.grad(li, tree_leaves(pt))]
        grads = g if grads is None else [a + b for a, b in zip(grads, g)]
        loss += li.item() / N_MICRO
    return dict(cfg=cfg, params_np=params_np, batch=batch, ref_logits=ref_logits,
                ref_loss=ref_loss, ref_grads=ref_grads, plain=plain.detach(), loss=loss,
                grads=grads)


SEAMLESS = [((2, 4), False), ((4, 2), True)]


@pytest.mark.parametrize("shape,fsdp", SEAMLESS,
                         ids=[f"{s[0]}x{s[1]}-{'gather' if f else 'move'}" for s, f in SEAMLESS])
def test_seamless_forward_and_train_step_sharded(seamless, shape, fsdp):
    cfg = dataclasses.replace(seamless["cfg"], fsdp_gather_weights=fsdp)
    batch = seamless["batch"]
    mesh = mesh_mod.make_debug_mesh(*shape, device="cpu")
    rules = S.make_rules(mesh, "prefill")
    with S.sharding_context(mesh, rules):
        params = S.device_put_tree(convert.params_from_jax(seamless["params_np"]),
                                   M.param_pspecs(cfg, rules), mesh)
        with record_hops() as log:
            logits = M.forward(params, cfg, batch["tokens"],
                               enc_tokens_embeds=batch["enc_embeds"])
    assert logits.spec == S.P("data", None, "model")
    _close(S.to_global(logits), seamless["ref_logits"])
    _close(S.to_global(logits), seamless["plain"])
    assert _hops(log) == dense_hops.forward_hops(cfg, *shape, TRAIN_B, SEQ, 4, s_enc=ENC)
    rules = S.make_rules(mesh, "train")
    with S.sharding_context(mesh, rules):
        state = T.shard_train_state(_state(seamless), cfg, mesh, rules)
        with record_hops() as log:
            loss, grads = T.sharded_loss_and_grads(state.params, batch, T.make_loss_fn(cfg),
                                                   N_MICRO)
    assert loss.item() == pytest.approx(seamless["ref_loss"], rel=1e-5)
    assert loss.item() == pytest.approx(seamless["loss"], rel=1e-5)
    for g, w, u in zip(tree_leaves(grads), seamless["ref_grads"], seamless["grads"],
                       strict=True):
        _close(S.to_global(g), w, GRAD_TOL)
        _close(S.to_global(g), u, GRAD_TOL)
    leaves = []
    for p, spec in zip(tree_leaves(M.init_params(cfg, 0, device="cpu")),
                       tree_leaves(M.param_pspecs(cfg, rules)), strict=True):
        axes = {a for part in spec if part for a in (part if isinstance(part, tuple) else (part,))}
        leaves.append((p.numel() // int(np.prod([mesh.shape[a] for a in axes] or [1])),
                       tuple(a for a in ("data", "model") if a not in axes)))
    # The step's hops but the clip's global norm, one element all-reduced
    # over each axis (a group a row of the other axis), which the update
    # makes after the gradients.
    want = dense_hops.train_hops(cfg, *shape, TRAIN_B, SEQ, 4, leaves, s_enc=ENC)
    want -= Counter({("all_reduce", "data", 1, 4): shape[1],
                     ("all_reduce", "model", 1, 4): shape[0]})
    assert _hops(log) == +want


def _state(seamless):
    from repro_torch.optim import adamw

    params = convert.params_from_jax(seamless["params_np"])
    for p in tree_leaves(params):
        p.requires_grad_(True)
    return T.TrainState(params, adamw.init_state(params))
