"""Flash attention's bf16 backward, host side on the CPU: the plan
(``repro_torch.kernels.local_attention.kernel.plan_flash_bwd``), its
shared-memory mirror (``bwd_smem_bytes``), the constants it shares with
``csrc/flash_attention_bwd.cu`` and the integers the wrapper hands the C
entry point.  They need no card and import no JAX: the plan is a pure
function of the shapes and the SM count, which the source launches as it
is given (``tests/test_torch_cuda.py`` holds the C figure equal to the
mirror on the card)."""

import re
from pathlib import Path

import pytest
import torch

from repro_torch.kernels.local_attention import kernel as FA

SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels"
          / "local_attention" / "csrc" / "flash_attention_bwd.cu")
#: (b, hq, hkv, t, s, d) the training paths run: Gemma3-1B's microbatch,
#: RecurrentGemma-2B's, qwen2-0.5b's and minitron-8b's GQA, seamless's MHA,
#: the train_lm example's width in bf16's nearest, qwen3-moe's 64/4.
SHAPES = [(4, 4, 1, 2048, 2048, 256), (2, 10, 1, 1024, 1024, 256), (1, 14, 2, 2048, 2048, 64),
          (1, 32, 8, 2048, 2048, 128), (1, 16, 16, 1024, 1024, 64), (1, 16, 16, 256, 1024, 64),
          (2, 64, 4, 1024, 1024, 128), (1, 7, 1, 257, 257, 128), (1, 4, 4, 200, 200, 32)]


def _blocks(plan, b, hkv, s):
    return b * hkv * plan.cluster * -(-s // plan.kv_tile)


@pytest.mark.parametrize("b,hq,hkv,t,s,d", SHAPES)
def test_cluster_divides_the_group_and_is_at_most_8(b, hq, hkv, t, s, d):
    for sms in (132, 114, 16, 1000):
        plan = FA.plan_flash_bwd(b, hq, hkv, t, s, d, sms)
        group = hq // hkv
        assert 1 <= plan.cluster <= FA.MAX_CLUSTER and group % plan.cluster == 0
        # The smallest such cluster whose grid reaches BWD_WAVES blocks an SM,
        # else the largest.
        fits = [c for c in range(1, 9) if group % c == 0]
        smaller = [c for c in fits if c < plan.cluster]
        assert all(_blocks(FA._plan(d, c, 2, 2), b, hkv, s) < FA.BWD_WAVES * sms
                   for c in smaller)
        if plan.cluster != max(fits):
            assert _blocks(plan, b, hkv, s) >= FA.BWD_WAVES * sms


@pytest.mark.parametrize("name,shape,cluster,blocks", [
    ("gemma3-1b", (4, 4, 1, 2048, 2048, 256), 4, 512),
    ("recurrentgemma-2b", (2, 10, 1, 1024, 1024, 256), 5, 160),
    ("qwen2-0.5b", (1, 14, 2, 2048, 2048, 64), 7, 224),
])
def test_training_shapes_cover_132_sms(name, shape, cluster, blocks):
    """At Gemma3's training microbatch one block a key tile gives 128 blocks
    on 132 SMs; the plan's cluster of 4 gives 512, each walking one of the
    group's 4 query heads.  RecurrentGemma: group 10, a cluster of 5, two
    heads a block; qwen2: group 7, a cluster of 7."""
    b, hq, hkv, t, s, d = shape
    plan = FA.plan_flash_bwd(*shape, 132)
    assert plan.cluster == cluster
    assert _blocks(plan, b, hkv, s) == blocks >= 132
    if name == "gemma3-1b":
        assert _blocks(plan, b, hkv, s) >= 4 * 128


@pytest.mark.parametrize("d", FA.HEAD_DIMS)
def test_shared_memory_fits_at_every_head_width(d):
    plan = FA.plan_flash_bwd(1, 4, 1, 1024, 1024, d, 132)
    assert FA.bwd_smem_bytes(d, "dkdv", plan.kv_stages) <= FA.SMEM_LIMIT == 232448
    assert FA.bwd_smem_bytes(d, "dq", plan.dq_stages) <= FA.SMEM_LIMIT
    # The deepest ring that fits: one stage more does not (or the cap).
    for kernel, st in (("dkdv", plan.kv_stages), ("dq", plan.dq_stages)):
        assert 2 <= st <= FA.BWD_MAX_STAGES
        assert st == FA.BWD_MAX_STAGES or FA.bwd_smem_bytes(d, kernel, st + 1) > FA.SMEM_LIMIT
    # The cluster's f32 partials (dV and dK rows, D + 8 floats apart) fit in
    # the tiles of the shallowest ring, which they reuse.
    kv = FA.BWD_KV_TILE[d]
    assert 2 * kv * (d + 8) * 4 <= FA.bwd_smem_bytes(d, "dkdv", 2) - 1024 - 256


def test_smem_figures_at_d_256():
    """D = 256: K and V 64 KB, two stages of Q and dO (64 KB each, with a
    KB of lse and delta rows), P^T and dS^T 16 KB; the dQ block's Q and dO
    128 KB and three stages of 32-key K and V tiles."""
    assert FA.bwd_smem_bytes(256, "dkdv", 2) == 1024 + 65536 + 2 * 66560 + 16384 + 256
    assert FA.bwd_smem_bytes(256, "dq", 3) == 1024 + 131072 + 3 * 32768 + 256
    plan = FA.plan_flash_bwd(4, 4, 1, 2048, 2048, 256, 132)
    assert (plan.kv_tile, plan.kv_stages, plan.dq_keys, plan.dq_stages) == (64, 2, 32, 3)
    with pytest.raises(ValueError):
        FA.bwd_smem_bytes(256, "dv", 2)


def test_plans_are_deterministic_and_cached():
    FA.plan_flash_bwd.cache_clear()
    first = FA.plan_flash_bwd(4, 4, 1, 2048, 2048, 256, 132)
    assert FA.plan_flash_bwd(4, 4, 1, 2048, 2048, 256, 132) is first
    assert FA.plan_flash_bwd.cache_info().hits == 1
    # T enters no choice.
    assert FA.plan_flash_bwd(4, 4, 1, 77, 2048, 256, 132) == first
    for bad in ((0, 4, 1, 8, 8, 64, 132), (1, 4, 3, 8, 8, 64, 132), (1, 4, 1, 8, 8, 96, 132),
                (1, 4, 1, 8, 8, 64, 0)):
        with pytest.raises(ValueError):
            FA.plan_flash_bwd(*bad)


@pytest.mark.parametrize("b,hq,hkv,t,s,d", SHAPES)
def test_flash_bwd_plans_list_every_cluster(b, hq, hkv, t, s, d):
    plans = FA.flash_bwd_plans(b, hq, hkv, t, s, d)
    group = hq // hkv
    assert sorted({p.cluster for p in plans}) == [c for c in range(1, 9) if group % c == 0]
    for sms in (16, 132, 1000):
        assert FA.plan_flash_bwd(b, hq, hkv, t, s, d, sms) in plans
    assert len(set(plans)) == len(plans)


def test_constants_match_the_source():
    src = SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("MAX_STAGES") == FA.BWD_MAX_STAGES
    assert const("MAX_CLUSTER") == FA.MAX_CLUSTER
    assert const("SMEM_LIMIT") == FA.SMEM_LIMIT
    assert const("PAD_ROWS") == FA.BWD_DQ_ROWS
    assert const("ALIGN_SLACK") == 1024 and const("BAR_BYTES") == 256
    assert "static constexpr int BKV = D == 256 ? 64 : 128;" in src
    assert "static constexpr int BQ = 64;" in src
    assert "static constexpr int DQ_ROWS = 128;" in src
    assert "static constexpr int DQ_KEYS = D == 256 ? 32 : 64;" in src
    assert {d: FA.BWD_KV_TILE[d] for d in FA.HEAD_DIMS} == {32: 128, 64: 128, 128: 128, 256: 64}
    assert FA.BWD_Q_TILE == 64


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_wrapper_hands_the_plan_to_the_entry_point(monkeypatch, dtype):
    """The plumbing on the CPU, the library and the device checks stubbed:
    after the ten pointers, B, Hq, Hkv, T, S, D, causal, window, scale,
    dtype, then the plan's kv_tile, kv_stages, dq_keys, dq_stages and
    cluster (zeros in f32); the scratch holds lse2 and delta for rows padded
    to 128 in bf16, delta in f32.  ``launch_bwd_plan`` counts no launch."""
    calls = []

    class Lib:
        @staticmethod
        def flash_attention_bwd(*args):
            calls.append(list(args[10:-1]))
            return 0

    monkeypatch.setattr(FA, "load_library", lambda name: Lib())
    monkeypatch.setattr(FA, "launch_stream", lambda dev: 0)
    monkeypatch.setattr(FA, "_check_bwd_args", lambda *a: None)
    monkeypatch.setattr(FA, "sm_count", lambda dev: 132)
    scratch = []
    real_empty = torch.empty

    def spy_empty(shape, **kw):
        out = real_empty(shape, **kw)
        scratch.append(tuple(out.shape))
        return out

    monkeypatch.setattr(FA.torch, "empty", spy_empty)
    q = torch.zeros((2, 10, 300, 256), dtype=dtype)
    k = torch.zeros((2, 1, 300, 256), dtype=dtype)
    lse = torch.zeros((2, 10, 300))
    code = 1 if dtype == torch.bfloat16 else 0
    if dtype == torch.bfloat16:
        plans = FA.flash_bwd_plans(2, 10, 1, 300, 300, 256)
        for plan in plans:
            dq, dk, dv = FA.launch_bwd_plan(q, k, k, q, lse, q, plan=plan, window=2048)
            assert dq.shape == q.shape and dk.shape == dv.shape == k.shape
        assert [c[-5:] for c in calls] == [
            [p.kv_tile, p.kv_stages, p.dq_keys, p.dq_stages, p.cluster] for p in plans]
        assert scratch == [(2 * 2 * 10 * 384,)] * len(plans)
        with pytest.raises(ValueError, match="not a plan"):
            FA.launch_bwd_plan(q, k, k, q, lse, q, plan=FA._plan(256, 3, 2, 3))
    else:
        FA._launch_bwd(q, k, k, q, lse, q, True, None, None, None)
        assert calls[0][-5:] == [0, 0, 0, 0, 0] and scratch == [(2 * 10 * 300,)]
    assert calls[0][:10] == [2, 10, 1, 300, 300, 256, 1, 2048 if code else 0,
                             pytest.approx(256 ** -0.5), code]
