"""The port's expert-parallel MoE (``repro_torch.model.moe_a2a``) and its
exchange (``core.device_comm.all_to_all``) against the reference's, on the
CPU.

The reference's side is ``tests/test_moe_a2a.py``'s: ``apply_moe_sharded``
on a (data=2, model=4) mesh of 8 host devices, the reduced dbrx with
d_model 32, d_ff 64, 8 experts top-2, run once in a subprocess (the main
process stays one-device).  It returns numpy arrays: the outputs at a
capacity factor of 8.0 (nothing drops) and 1.0, the grads of the outputs'
sum, and each shard's dropped (token, k) assignments rebuilt from the
reference's own routing with its per-shard capacity rule.  The port runs
on a (2, 4) mesh of "cpu" shards in this process, with the same params
(``convert.params_from_jax``).

At x of (4, 16, 32) each shard routes 8 tokens, and the exchange's floor
of 8 rows a buffer means nothing can drop, so the capacity case also runs
x of (4, 64, 32): 32 tokens a shard, 8 rows a buffer, and drops.

Tolerance: 2e-4 relative and absolute, the reference's own between its
a2a and its gather MoE (the expert products summed in another order);
grads at 2e-4 of their largest value.  The fallbacks to the gather path
are bit for bit.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_config
from repro_torch.core import device_comm
from repro_torch.core.device_comm import all_to_all, record_hops
from repro_torch.launch.mesh import make_debug_mesh, make_seq_mesh
from repro_torch.model import convert
from repro_torch.model import moe as MoE
from repro_torch.model import moe_a2a as A2A
from repro_torch.model.model import init_mk
from repro_torch.model.sharding import make_rules, sharding_context

torch.set_num_threads(1)

SRC = str(Path(__file__).resolve().parents[1] / "src")
TOL = 2e-4
DP, TP = 2, 4

SCRIPT = textwrap.dedent(
    """
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses
    import jax, jax.numpy as jnp, numpy as np

    from repro.configs.registry import get_config
    from repro.model import moe as moe_mod
    from repro.model.moe_a2a import apply_moe_sharded
    from repro.model.sharding import init_mk, make_rules, sharding_context

    if hasattr(jax.sharding, "AxisType"):
        mesh = jax.make_mesh((2, 4), ("data", "model"),
                             axis_types=(jax.sharding.AxisType.Auto,) * 2)
    else:
        mesh = jax.make_mesh((2, 4), ("data", "model"))
    cfg = dataclasses.replace(
        get_config("dbrx-132b").reduced(),
        d_model=32, d_ff=64, num_experts=8, num_experts_per_tok=2,
        moe_capacity_factor=8.0)
    tight = dataclasses.replace(cfg, moe_capacity_factor=1.0)
    params = moe_mod.init_moe(init_mk(jax.random.key(0), jnp.float32), cfg, "moe")
    x = np.random.default_rng(0).standard_normal((4, 16, 32)).astype(np.float32)
    x2 = np.random.default_rng(1).standard_normal((4, 64, 32)).astype(np.float32)
    rules = make_rules(mesh, "train")
    out = {f"p_{k}": np.asarray(v) for k, v in params.items()}
    out["x"], out["x2"] = x, x2

    def sharded(c):
        return jax.jit(lambda p, v: apply_moe_sharded(p, v, c))

    with mesh, sharding_context(mesh, rules):
        out["a2a"] = np.asarray(sharded(cfg)(params, jnp.asarray(x)))
        out["tight"] = np.asarray(sharded(tight)(params, jnp.asarray(x)))
        out["tight2"] = np.asarray(sharded(tight)(params, jnp.asarray(x2)))
        gp, gx = jax.jit(jax.grad(
            lambda p, v: apply_moe_sharded(p, v, cfg).sum(), argnums=(0, 1)
        ))(params, jnp.asarray(x))
    for k, v in gp.items():
        out[f"g_{k}"] = np.asarray(v)
    out["g_x"] = np.asarray(gx)

    # Each shard's dropped assignments at cf 1.0, from the reference's
    # routing and its per-shard rule: stable sort by expert, each expert
    # keeping its first cap, cap = max(8, int(n * k * cf / e)) rounded to 8.
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    for name, xv in (("x", x), ("x2", x2)):
        b, t, d = xv.shape
        drops = []
        for i in range(2):
            for j in range(4):
                xs = xv[i * b // 2:(i + 1) * b // 2, j * t // 4:(j + 1) * t // 4]
                n = xs.shape[0] * xs.shape[1]
                logits = jnp.asarray(xs.reshape(n, d)) @ params["router"]
                _, ex = moe_mod._topk_routing(logits, k)
                flat = np.asarray(ex).reshape(-1)
                cap = -(-max(8, int(n * k * 1.0 / e)) // 8) * 8
                order = np.argsort(flat, kind="stable")
                pos = np.empty(n * k, np.int64)
                seen = np.zeros(e, np.int64)
                for a in order:
                    pos[a] = seen[flat[a]]
                    seen[flat[a]] += 1
                drops.append((pos >= cap).reshape(n, k))
        out[f"drops_{name}"] = np.stack(drops)
    np.savez(sys.argv[1], **out)
    print("MOE_A2A_REF_OK")
    """
)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("moe_a2a") / "ref.npz"
    env = {"PYTHONPATH": SRC, "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "HOME": os.environ.get("HOME", "/tmp"), "JAX_PLATFORMS": "cpu"}
    res = subprocess.run([sys.executable, "-c", SCRIPT, str(path)], capture_output=True,
                         text=True, env=env, timeout=600)
    assert res.returncode == 0, f"stdout:\n{res.stdout}\nstderr:\n{res.stderr[-3000:]}"
    with np.load(path) as z:
        return dict(z)


def _cfg(cf=8.0):
    import dataclasses

    return dataclasses.replace(
        get_config("dbrx-132b").reduced(), d_model=32, d_ff=64, num_experts=8,
        num_experts_per_tok=2, moe_capacity_factor=cf)


def _params(ref, grad=False):
    p = convert.params_from_jax({k[2:]: ref[k] for k in ref if k.startswith("p_")})
    for v in p.values():
        v.requires_grad_(grad)
    return p


def _sharded(params, x, cfg, mesh=None, mode="train"):
    mesh = mesh or make_debug_mesh(DP, TP, device="cpu")
    with sharding_context(mesh, make_rules(mesh, mode)):
        return A2A.apply_moe_sharded(params, x, cfg)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=tol, atol=tol)


def test_matches_reference_without_drops(ref):
    p = _params(ref)
    _close(_sharded(p, torch.from_numpy(ref["x"]), _cfg()), ref["a2a"])


@pytest.mark.parametrize("name", ["x", "x2"])
def test_matches_reference_with_the_same_drops(ref, name, monkeypatch):
    p, x = _params(ref), torch.from_numpy(ref[name])
    routes = []
    real = MoE.dispatch

    def recording(*a, **kw):
        routes.append(real(*a, **kw))
        return routes[-1]

    # Each shard's routing, data row by data row, shards in axis order.
    monkeypatch.setattr(MoE, "dispatch", recording)
    got = _sharded(p, x, _cfg(1.0))
    _close(got, ref["tight" if name == "x" else "tight2"])
    e = 8
    drops = np.stack([(r.slot == e * r.cap).numpy() for r in routes])
    np.testing.assert_array_equal(drops, ref[f"drops_{name}"])
    # 8 tokens a shard cannot fill a buffer of 8 rows; 32 tokens do.
    assert drops.any() == (name == "x2")
    assert {r.cap for r in routes} == {8}


def test_grads_match_reference(ref):
    p = _params(ref, grad=True)
    x = torch.from_numpy(ref["x"]).requires_grad_(True)
    _sharded(p, x, _cfg()).sum().backward()
    for k, v in p.items():
        want = ref[f"g_{k}"]
        _close(v.grad, want, TOL * max(1.0, float(np.abs(want).max())))
    _close(x.grad, ref["g_x"], TOL * max(1.0, float(np.abs(ref["g_x"]).max())))


def test_matches_the_gather_path_without_drops(ref):
    p, x = _params(ref), torch.from_numpy(ref["x"])
    _close(_sharded(p, x, _cfg()), MoE.apply_moe(p, x, _cfg()).numpy())


@pytest.mark.parametrize("case", ["no_mesh", "no_model_axis", "batch", "experts", "seq"])
def test_fallbacks_are_the_gather_path_bit_for_bit(ref, case):
    p, cfg = _params(ref), _cfg(1.0)
    x = torch.from_numpy(ref["x2"])
    if case == "no_mesh":
        got = A2A.apply_moe_sharded(p, x, cfg)
    elif case == "no_model_axis":
        got = _sharded(p, x, cfg, make_seq_mesh(4, device="cpu"), mode="prefill")
    elif case == "batch":                    # B = 3 over a data extent of 2
        x = x[:3]
        got = _sharded(p, x, cfg)
    elif case == "experts":                  # 8 experts over tp = 3
        x = x[:, :48]
        got = _sharded(p, x, cfg, make_debug_mesh(2, 3, device="cpu"))
    else:                                    # T = 18 over tp = 4
        x = x[:, :18]
        got = _sharded(p, x, cfg)
    with record_hops() as hops:
        assert torch.equal(got, MoE.apply_moe(p, x, cfg))
    assert hops == []


def test_a2a_capacity_is_the_reference_rule_per_shard():
    for n in (1, 7, 8, 31, 32, 100, 1000):
        for cf in (0.05, 1.0, 1.25, 8.0):
            c = max(8, int(n * 2 * cf / 8))
            assert A2A.a2a_capacity(n, _cfg(cf)) == -(-c // 8) * 8
    # Per shard: at x of (4, 64) on (2, 4) a shard routes 32 tokens.
    assert A2A.a2a_capacity(32, _cfg(1.0)) == 8 < MoE.capacity(256, _cfg(1.0)) == 64


def test_exchanges_and_elements_per_shard(ref):
    p = _params(ref, grad=True)
    x = torch.from_numpy(ref["x"]).requires_grad_(True)
    with record_hops() as fwd:
        out = _sharded(p, x, _cfg())
    cap = A2A.a2a_capacity(8, _cfg())
    per_send = 8 * cap * 32                  # (E, cap, D) a shard
    # Two exchanges a data row, each moving (tp - 1) / tp of a shard's send.
    assert [(h.kind, h.elements) for h in fwd] == [("all_to_all", per_send * 3 // 4)] * 2 * DP
    with record_hops() as bwd:
        out.sum().backward()
    assert [(h.kind, h.elements) for h in bwd] == [("all_to_all", per_send * 3 // 4)] * 2 * DP
    assert not any(h.reverse for h in fwd + bwd)


def test_expert_weights_are_views():
    cfg = _cfg()
    mk = init_mk(torch.Generator().manual_seed(0), torch.float32, torch.device("cpu"))
    p = MoE.init_moe(mk, cfg, "moe")
    views = A2A._local_experts(p, 1, 2, torch.device("cpu"))
    for v, name in zip(views, ("w_gate", "w_up", "w_down")):
        assert v.data_ptr() == p[name][2].data_ptr()


# --------------------------------------------------------------------------
# all_to_all, in tests/test_torch_core.py's style
# --------------------------------------------------------------------------

def _np_all_to_all(xs, split, concat):
    n = len(xs)
    return [np.concatenate([np.split(x, n, axis=split)[j] for x in xs], axis=concat)
            for j in range(n)]


@pytest.mark.parametrize("n,split,concat", [(1, 0, 1), (2, 0, 1), (4, 0, 1), (4, 1, 0),
                                            (3, 2, 0), (4, 1, 1)])
def test_all_to_all_is_the_tiled_exchange(n, split, concat):
    rng = np.random.default_rng(n + 10 * split + concat)
    shape = [4, 8, 6]
    shape[split] = n * 2
    xs = [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]
    with record_hops() as hops:
        got = all_to_all([torch.from_numpy(x) for x in xs], split, concat)
    for g, w in zip(got, _np_all_to_all(xs, split, concat)):
        np.testing.assert_array_equal(g.numpy(), w)
    assert hops == [device_comm.Hop(int(np.prod(shape)) * (n - 1) // n, tuple(range(n)),
                                    "all_to_all")]


def test_all_to_all_inverse_and_refusals():
    xs = [torch.randn(4, 6, 3) for _ in range(4)]
    back = all_to_all(all_to_all(xs, 0, 1), 1, 0)
    assert all(torch.equal(a, b) for a, b in zip(xs, back))
    with pytest.raises(ValueError, match="share a shape"):
        all_to_all([torch.zeros(4, 2), torch.zeros(4, 3)], 0, 1)
    with pytest.raises(ValueError, match="does not split"):
        all_to_all([torch.zeros(3, 2)] * 2, 0, 1)


def test_all_to_all_gradcheck():
    xs = tuple(torch.randn(4, 2, 3, dtype=torch.float64, requires_grad=True) for _ in range(4))
    weights = [torch.randn(1, 8, 3, dtype=torch.float64) for _ in range(4)]

    def fn(*a):
        return sum((y * w).sum() for y, w in zip(all_to_all(list(a), 0, 1), weights))

    assert torch.autograd.gradcheck(fn, xs)
    with record_hops() as hops:
        fn(*xs).backward()
    assert [h.kind for h in hops] == ["all_to_all"] * 2
