"""The port's MoE layer (``repro_torch.model.moe``) against the reference's
``repro.model.moe``, on the CPU.

Configs: the reduced dbrx-132b and qwen3-moe-235b-a22b (d_model 128, four
experts top-2, d_ff 256, f32), and a wider variant of each (16 experts
top-4, 32 experts top-8) so that capacity drops and ties reach past the
first few experts.  Parameters come from the reference's ``init_moe``
through ``convert.params_from_jax``; inputs from numpy with fixed seeds.

Tolerance, f32: 1e-5 relative per element plus 1e-5 of the layer's
largest output (:func:`_close`).  The reference's init draws the (E, D, F)
expert stacks at scale E ** -0.5, so outputs reach a few hundred, and the
same products summed in another order differ by up to about 5e-7 of the
largest; routing (the experts, the dropped set, the capacity) exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.model import moe as JMoE
from repro.model.sharding import init_mk
from repro_torch.configs.registry import get_config
from repro_torch.model import convert
from repro_torch.model import moe as MoE
from repro_torch.model.model import init_mk as torch_mk

jax.config.update("jax_platform_name", "cpu")
# Tiny tensors: one intra-op thread, so parallel test workers do not
# oversubscribe the cores.
torch.set_num_threads(1)

TOL = 1e-5
ARCHS = ("dbrx-132b", "qwen3-moe-235b-a22b")
#: (experts, top-k) of the wider variants.
WIDE = {"dbrx-132b": (16, 4), "qwen3-moe-235b-a22b": (32, 8)}


def _cfgs(arch, wide=False):
    cj, ct = jax_config(arch).reduced(), get_config(arch).reduced()
    if wide:
        e, k = WIDE[arch]
        cj = dataclasses.replace(cj, num_experts=e, num_experts_per_tok=k)
        ct = dataclasses.replace(ct, num_experts=e, num_experts_per_tok=k)
    return cj, ct


def _params(cfg_j, seed=0):
    pj = JMoE.init_moe(init_mk(jax.random.key(seed), jnp.float32), cfg_j, "moe")
    return pj, convert.params_from_jax(jax.tree.map(np.asarray, pj))


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * float(np.abs(want).max()))


def _x(seed, b, t, d=128):
    return np.random.default_rng(seed).standard_normal((b, t, d)).astype(np.float32)


def _ref_dropped(pj, cfg_j, x, cf):
    """The reference's routing, and its dropped (token, k) pairs rebuilt
    from it in numpy with the reference's rule: stable sort by expert, each
    expert keeping its first ``cap`` assignments."""
    n = x.shape[0] * x.shape[1]
    e, k = cfg_j.num_experts, cfg_j.num_experts_per_tok
    logits = jnp.asarray(x.reshape(n, -1)) @ pj["router"]
    w, ex = (np.asarray(a) for a in JMoE._topk_routing(logits, k))
    cap = max(1, int(n * k * cf / e))
    cap = -(-cap // 8) * 8
    flat = ex.reshape(-1)
    order = np.argsort(flat, kind="stable")
    rank = np.empty(n * k, np.int64)
    for expert in range(e):
        idx = order[flat[order] == expert]
        rank[idx] = np.arange(idx.size)
    return w, ex, cap, (rank >= cap).reshape(n, k)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("wide", [False, True], ids=["reduced", "wide"])
@pytest.mark.parametrize("cf", [8.0, 0.05], ids=["no-drops", "drops"])
def test_apply_moe_matches_reference(arch, wide, cf):
    cfg_j, cfg = _cfgs(arch, wide)
    pj, pt = _params(cfg_j)
    x = _x(1, 3, 40)
    want = np.asarray(JMoE.apply_moe(pj, jnp.asarray(x), cfg_j, capacity_factor=cf))
    got = MoE.apply_moe(pt, torch.from_numpy(x), cfg, capacity_factor=cf).numpy()
    _close(got, want)

    w, ex, cap, dropped = _ref_dropped(pj, cfg_j, x, cf)
    route = MoE.dispatch(pt, torch.from_numpy(x.reshape(-1, 128)), cfg, cf)
    assert route.cap == cap == MoE.capacity(120, cfg, cf)
    assert np.array_equal(route.expert.numpy(), ex)
    np.testing.assert_allclose(route.weight.numpy(), w, rtol=1e-6, atol=1e-7)
    got_dropped = (route.slot == cfg.num_experts * cap).numpy()
    assert np.array_equal(got_dropped, dropped)
    if cf < 1:
        assert 0 < dropped.sum() < dropped.size
        # A token whose every assignment was dropped passes through as 0.
        lost = dropped.all(axis=1)
        assert np.array_equal(got.reshape(-1, 128)[lost], np.zeros((lost.sum(), 128)))
    else:
        assert not dropped.any()
    # The kept slots are distinct and inside their expert's buffer.
    kept = route.slot[~torch.from_numpy(dropped)]
    assert kept.unique().numel() == kept.numel()
    assert torch.equal(kept // cap, route.expert[~torch.from_numpy(dropped)])


@pytest.mark.parametrize("arch", ARCHS)
def test_ties_pick_the_lower_expert(arch):
    """A zero router gives every token the same probability for every
    expert: top-k must take experts 0..k-1, in that order, as
    ``jax.lax.top_k`` does, and the whole layer must follow."""
    cfg_j, cfg = _cfgs(arch, wide=True)
    pj, _ = _params(cfg_j)
    pj = {**pj, "router": jnp.zeros_like(pj["router"])}
    pt = convert.params_from_jax(jax.tree.map(np.asarray, pj))
    x = _x(2, 2, 12)
    k = cfg.num_experts_per_tok
    _, ex = MoE._topk_routing(torch.zeros(24, cfg.num_experts), k)
    assert np.array_equal(ex.numpy(), np.tile(np.arange(k), (24, 1)))
    for cf in (8.0, 0.25):
        want = np.asarray(JMoE.apply_moe(pj, jnp.asarray(x), cfg_j, capacity_factor=cf))
        got = MoE.apply_moe(pt, torch.from_numpy(x), cfg, capacity_factor=cf).numpy()
        _close(got, want)


def test_partial_ties_match_top_k():
    logits = np.array([[1.0, 3.0, 3.0, 0.0, 3.0],
                       [2.0, 2.0, 2.0, 2.0, 2.0],
                       [0.0, 1.0, 0.0, 1.0, -1.0],
                       [5.0, -2.0, 5.0, 5.0, 0.0]], np.float32)
    for k in (1, 2, 3, 4):
        wj, ej = JMoE._topk_routing(jnp.asarray(logits), k)
        wt, et = MoE._topk_routing(torch.from_numpy(logits), k)
        assert np.array_equal(et.numpy(), np.asarray(ej)), k
        np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("n", [1, 7, 64, 1000])
@pytest.mark.parametrize("cf", [0.05, 1.25, 3.0])
def test_capacity_is_the_reference_formula(n, cf):
    for arch in ARCHS:
        for cfg in (get_config(arch), get_config(arch).reduced()):
            e, k = cfg.num_experts, cfg.num_experts_per_tok
            want = -(-max(1, int(n * k * cf / e)) // 8) * 8
            assert MoE.capacity(n, cfg, cf) == want
    assert MoE.capacity(n, get_config("dbrx-132b")) == MoE.capacity(n, get_config("dbrx-132b"),
                                                                    1.25)


def test_load_balance_loss_matches_reference():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((50, 16)).astype(np.float32)
    experts = rng.integers(0, 16, (50, 4)).astype(np.int32)
    want = float(JMoE.load_balance_loss(jnp.asarray(logits), jnp.asarray(experts), 16))
    got = float(MoE.load_balance_loss(torch.from_numpy(logits), torch.from_numpy(experts), 16))
    assert abs(got - want) <= 1e-6 * max(1.0, abs(want))


def test_init_moe_layout_matches_reference():
    for arch in ARCHS:
        cfg_j, cfg = _cfgs(arch)
        pj, _ = _params(cfg_j)
        mk = torch_mk(torch.Generator().manual_seed(0), torch.float32, torch.device("cpu"))
        pt = MoE.init_moe(mk, cfg, "moe")
        assert {k: tuple(v.shape) for k, v in pt.items()} == {
            k: tuple(v.shape) for k, v in pj.items()}


def test_combine_is_deterministic_and_bf16_follows_reference():
    """Two calls give the same bits; in bf16 the layer rounds as the
    reference does (expert GEMMs in bf16, the weighted sum in f32): within
    two bf16 ulps (2 ** -7 relative) of each output, plus 2 ** -7 of the
    largest for outputs near 0."""
    cfg_j, cfg = _cfgs("qwen3-moe-235b-a22b", wide=True)
    cfg_j = dataclasses.replace(cfg_j, dtype="bfloat16")
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    pj, _ = _params(cfg_j)
    pj = jax.tree.map(lambda a: a.astype(jnp.bfloat16), pj)
    pt = convert.params_from_jax(jax.tree.map(np.asarray, pj))
    x = _x(4, 2, 16)
    xt = torch.from_numpy(x).bfloat16()
    a = MoE.apply_moe(pt, xt, cfg)
    assert torch.equal(a, MoE.apply_moe(pt, xt, cfg))
    assert a.dtype == torch.bfloat16
    want = np.asarray(JMoE.apply_moe(pj, jnp.asarray(x, jnp.bfloat16), cfg_j), np.float32)
    np.testing.assert_allclose(a.float().numpy(), want, rtol=2 ** -7,
                               atol=2 ** -7 * float(np.abs(want).max()))


def test_a2a_without_mesh_is_the_gather_path():
    # moe_impl="a2a" is ported (tests/test_torch_moe_a2a.py): apply_ffn no
    # longer refuses it, and without a mesh it is the gather path bit for bit.
    from repro_torch.model import transformer as tf

    cfg_j, cfg = _cfgs("dbrx-132b")
    _, pt = _params(cfg_j)
    x = torch.from_numpy(_x(3, 2, 16))
    a2a = dataclasses.replace(cfg, moe_impl="a2a")
    assert torch.equal(tf.apply_ffn(pt, x, a2a), MoE.apply_moe(pt, x, cfg))
