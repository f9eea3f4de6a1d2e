"""``repro_torch.launch.hillclimb`` and the production dry run's per-card
trace, on the CPU.

* The port's ``_variants()`` are the reference's: the same three cells,
  archs, shapes and ten variant names, and each transform changes the same
  config fields to the same values.
* ``run_variant`` gives ``ok: true`` for a reduced config on a small meta
  mesh, and writes its row.
* On a (2, 4) mesh of ``meta`` devices, the representative shard's trace
  (``launch.mesh.representative``) equals each enumerated shard's: FLOPs,
  bytes and launches exactly, hops exactly (each collective is logged once
  a group); the peak of live bytes within 10%: the single controller holds
  a group's collective outputs together and runs autograd's nodes across
  the shards in one order, where the representative runs one card's.
* A production-mesh row (a prefill and a decode cell of gemma3-1b, a
  decode cell of seamless-m4t-large-v2) carries one card's costs, its
  collective bytes by op and by axis, a collective term summed over each
  axis's link rate, and a peak.
"""

import dataclasses
import json
import os
from collections import Counter

import pytest
import torch

from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import get_config
from repro_torch.launch import dryrun, hillclimb
from repro_torch.launch import mesh as mesh_mod

torch.set_num_threads(1)

FIELDS = ("moe_impl", "microbatch", "remat", "fsdp_gather_weights", "head_pad",
          "prefill_chunks")


def _reference_variants():
    """The reference's ``_variants()``.  Its module sets ``XLA_FLAGS`` on
    import; the test process's value is put back at once."""
    before = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import hillclimb as ref
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    return ref._variants()


def test_variants_are_the_reference_variants():
    from repro.configs.registry import get_config as jax_config

    mine, ref = hillclimb._variants(), _reference_variants()
    assert list(mine) == list(ref) == ["moe", "vl", "rwkv"]
    assert sum(len(v[2]) for v in mine.values()) == 13
    for cell, (arch, shape, variants) in mine.items():
        r_arch, r_shape, r_variants = ref[cell]
        assert (arch, shape) == (r_arch, r_shape)
        assert list(variants) == list(r_variants)
        base, r_base = get_config(arch), jax_config(arch)
        for name, transform in variants.items():
            got, want = transform(base), r_variants[name](r_base)
            for f in FIELDS:
                assert getattr(got, f) == getattr(want, f), (cell, name, f)


def test_run_variant_on_a_small_meta_mesh(tmp_path):
    arch, shape_name, variants = hillclimb._variants()["moe"]
    cfg = dataclasses.replace(get_config(arch).reduced(), microbatch=2)
    shape = ShapeConfig(name=shape_name, seq_len=16, global_batch=8, kind="train")
    mesh = mesh_mod.make_debug_mesh(2, 4, device="meta")
    rows = {}
    for name in ("baseline", "a2a", "a2a_wgather"):
        rows[name] = hillclimb.run_variant(arch, shape_name, name, variants[name], tmp_path,
                                           mesh=mesh, cfg=cfg, shape=shape, verbose=False)
        assert rows[name]["ok"], rows[name].get("traceback")
        assert rows[name]["mesh"] == "2x4" and rows[name]["peak_bytes"] > 0
        assert rows[name]["roofline"]["collective_s"] > 0
        on_disk = json.loads((tmp_path / f"{arch}__{shape_name}__{name}.json").read_text())
        assert on_disk["ok"] and on_disk["collectives_by_op"] == rows[name]["collectives_by_op"]
    # The a2a exchanges its tokens over the model axis; the gather path
    # makes no all-to-all there.
    assert rows["a2a"]["collectives_by_axis"]["model"]["all-to-all"] > 0
    assert "all-to-all" not in rows["baseline"]["collectives_by_axis"]["model"]


@pytest.mark.parametrize("name,fsdp,kind", [
    ("qwen2-0.5b", False, "prefill"), ("qwen2-0.5b", True, "prefill"),
    ("rwkv6-1.6b", True, "prefill"), ("recurrentgemma-2b", False, "prefill"),
    ("qwen3-moe-235b-a22b", False, "train"), ("qwen3-moe-235b-a22b", True, "train"),
    ("gemma3-1b", False, "decode"), ("seamless-m4t-large-v2", True, "decode")])
def test_representative_shard_equals_the_enumerated_shards(name, fsdp, kind):
    cfg = dataclasses.replace(get_config(name).reduced(), fsdp_gather_weights=fsdp,
                              microbatch=2, prefill_chunks=1)
    shape = ShapeConfig(name="t", seq_len=16, global_batch=8, kind=kind)
    mesh = mesh_mod.make_debug_mesh(2, 4, device="meta")
    every, hops = dryrun.trace_sharded_step(cfg, shape, mesh)
    one, rep_hops = dryrun.trace_sharded_step(cfg, shape, mesh_mod.representative(mesh))
    rep = one.per_card()
    assert len(every.cells) == 8 and len(one.cells) == 1
    assert rep["flops"] > 0 and rep["bytes_accessed"] > 0
    for cell, tally in every.cells.items():
        card = tally.as_dict()
        for key in ("flops", "flops_by_class", "bytes_accessed", "launches"):
            assert card[key] == rep[key], (cell, key)
        assert card["peak_live_bytes"] == pytest.approx(rep["peak_live_bytes"], rel=0.1)
    groups = {"data": 4, "model": 2}
    want = Counter((h.kind, h.axis, h.elements) for h in rep_hops)
    got = Counter((h.kind, h.axis, h.elements) for h in hops)
    assert got == Counter({k: n * groups[k[1]] for k, n in want.items()})


PRODUCTION_CELLS = [("gemma3-1b", "prefill_32k"), ("gemma3-1b", "decode_32k"),
                    ("seamless-m4t-large-v2", "decode_32k")]


@pytest.mark.parametrize("arch,shape", PRODUCTION_CELLS, ids=[f"{a}-{s}" for a, s in
                                                              PRODUCTION_CELLS])
def test_production_rows_trace_one_card(arch, shape):
    row = dryrun.run_production_cell(arch, shape, verbose=False)
    pc, mem = row["per_card"], row["memory"]
    assert mem["peak_estimate_bytes"] == mem["state_bytes_per_card"] + mem[
        "peak_live_bytes_per_card"] > mem["state_bytes_per_card"]
    assert pc["roofline"]["collective_s"] > 0 and pc["cost"]["flops"] > 0
    assert set(pc["collectives_by_axis"]) == {"data", "model"}
    by_op = {op: v["bytes"] for op, v in pc["collectives"].items() if isinstance(v, dict)}
    assert sum(by_op.values()) == pc["collectives"]["total_bytes"] == sum(
        sum(ops.values()) for ops in pc["collectives_by_axis"].values())
    link = mesh_mod.LINK_BW
    assert pc["roofline"]["collective_s"] == pytest.approx(sum(
        sum(ops.values()) / link[a] for a, ops in pc["collectives_by_axis"].items()))


