"""The port's static audits (``repro_torch.analysis``) held against the
reference's (``repro.analysis``) on the CPU.

* **plumbing** — the findings table renders the reference's text;
* **agreement** — ringslack and paging give the reference's severities and
  metrics on all ten archs; the WKV decode window's state bytes equal the
  reference's ``crosscheck_decode_state`` metric;
* **resources** — every arch at full width is clean on an H100 (and on
  smaller cards), and every kernel entry point a main path launches,
  forward and backward, has launches declared by its own planner;
* **mutations** — a 300 KB launch, a cluster that does not divide its grid,
  a planner that raises, ``PagedController.free_slot`` made a no-op, the
  ring-slack rule made to return nothing and a slack-less state are each
  caught as an ERROR at their own location;
* **the CLI** — run in a subprocess: the host tier without torch, the
  reference's JSON rows, the default and single-arch sweeps.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.analysis import findings as RF
from repro.analysis import paging as ref_paging
from repro.analysis import resources as ref_resources
from repro.analysis import ringslack as ref_ringslack
from repro.configs.registry import get_config as ref_config
from repro_torch.analysis import findings as F
from repro_torch.analysis import paging, resources, ringslack
from repro_torch.analysis.registry import DEFAULT_ARCHS, PASS_MODULES, get_pass, run_passes
from repro_torch.configs.registry import get_config, list_archs
from repro_torch.kernels import common

ROOT = Path(__file__).resolve().parents[1]
ARCHS = [get_config(a).name for a in list_archs()]
#: Every kernel entry point of the port: the thirteen Pallas counterparts
#: and the three backward kernels.
ENTRY_POINTS = {
    "wkv_cuda", "wkv_train_cuda", "wkv_summary_cuda", "wkv_train_summary_cuda",
    "wkv_decode_cuda", "wkv_decode_window_cuda", "wkv_bwd_cuda", "elevator_scan_cuda",
    "elevator_decode_window_cuda", "token_shift_cuda", "flash_attention_cuda",
    "matmul_fwd_cuda", "stencil2d_cuda", "flash_attention_bwd_cuda",
    "elevator_scan_bwd_cuda", "token_shift_bwd_cuda",
}


def _sig(findings):
    """(severity, metrics) of each finding, in order."""
    return [(f.severity.name, dict(f.metrics)) for f in findings]


def _env():
    return {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}


def _cli(*args, module="repro_torch.analysis", flags=()):
    return subprocess.run([sys.executable, *flags, "-m", module, *args], capture_output=True,
                          text=True, cwd=ROOT, env=_env(), timeout=300)


# --------------------------------------------------------------------------
# plumbing
# --------------------------------------------------------------------------

def _same_findings(mod):
    return [
        mod.info("p", "src/a.py:f", "fine", n=1),
        mod.warn("p", "src/b.py:g", "iffy"),
        mod.error("q", "src/c.py:h", "broken", bytes=7),
        mod.info("resources", "src/d.cu:launch", "a long location", blocks_per_sm=2),
    ]


@pytest.mark.parametrize("title", [None, "T"])
def test_format_table_matches_the_reference(title):
    mine, ref = _same_findings(F), _same_findings(RF)
    assert F.format_table(mine, title=title) == RF.format_table(ref, title=title)
    assert F.format_table([], title=title) == RF.format_table([], title=title)
    assert F.worst(mine).name == RF.worst(ref).name
    assert [f.location for f in F.errors(mine)] == [f.location for f in RF.errors(ref)]
    assert [s.name for s in F.Severity] == [s.name for s in RF.Severity]


def test_registry_order_and_defaults():
    assert list(PASS_MODULES) == ["hostsafety", "resources", "ringslack", "paging",
                                  "dtype_flow", "collectives", "donation", "fleet",
                                  "retrace"]
    from repro.analysis.registry import DEFAULT_ARCHS as REF_DEFAULT
    from repro.analysis.registry import PASS_MODULES as REF_PASSES

    assert DEFAULT_ARCHS == REF_DEFAULT
    assert list(REF_PASSES) == list(PASS_MODULES)
    for name in PASS_MODULES:
        assert get_pass(name).PASS == name
    with pytest.raises(KeyError):
        get_pass("nonesuch")


# --------------------------------------------------------------------------
# agreement with the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_ringslack_matches_the_reference(arch):
    mine = ringslack.run(get_config(arch))
    assert _sig(mine) == _sig(ref_ringslack.run(ref_config(arch)))
    assert all(f.pass_name == "ringslack" for f in mine)
    assert not F.errors(mine)


@pytest.mark.parametrize("arch", ARCHS)
def test_paging_matches_the_reference(arch):
    mine = paging.run(get_config(arch))
    assert _sig(mine) == _sig(ref_paging.run(ref_config(arch)))
    assert not F.errors(mine)


def test_paging_numbers_at_full_shapes():
    """The pool beats the dense footprint on every arch with attention; the
    numbers come from the reference's pass, not from this file."""
    for arch in ("gemma3-1b", "recurrentgemma-2b"):
        (got,) = paging.run(get_config(arch))
        (want,) = ref_paging.run(ref_config(arch))
        assert got.metrics == want.metrics
        assert got.metrics["pool_bytes"] < got.metrics["dense_bytes"]


def test_decode_state_bytes_equal_the_references():
    """The port's B=1, K=64 decode window moves the state bytes the
    reference's ``crosscheck_decode_state`` counts for its window."""
    ref = [f for f in ref_resources.run(ref_config("rwkv6-1.6b")) if "state_bytes" in f.metrics]
    mine = [f for f in resources.run(get_config("rwkv6-1.6b"))
            if "state_bytes" in f.metrics and "B=1 K=64" in f.message]
    assert len(ref) == 1 and len(mine) == 1
    assert mine[0].metrics["state_bytes"] == ref[0].metrics["state_bytes"]
    assert mine[0].severity == F.Severity.INFO


# --------------------------------------------------------------------------
# resources on the full configs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_resources_clean_on_the_h100(arch):
    findings = resources.run(get_config(arch), sms=common.H100_SMS)
    assert findings and not [f for f in findings if f.severity >= F.Severity.WARN], (
        F.format_table(findings))
    for f in findings:
        if "blocks_per_sm" in f.metrics:
            assert f.metrics["blocks_per_sm"] >= 1
            assert f.metrics["smem_bytes"] <= common.SMEM_LIMIT


@pytest.mark.parametrize("sms", [78, 114])
def test_resources_clean_on_smaller_cards(sms):
    for arch in DEFAULT_ARCHS:
        assert not F.errors(resources.run(get_config(arch), sms=sms))


def test_every_entry_point_has_launches():
    """Each of the sixteen entry points is declared, by some arch's main
    paths, and each arch declares the kernels its layers launch."""
    by_arch = {a: {x.kernel for x in resources.launches(get_config(a), common.H100_SMS)}
               for a in ARCHS}
    assert set().union(*by_arch.values()) == ENTRY_POINTS
    assert set(resources.load_specs()) == ENTRY_POINTS
    demo = {"matmul_fwd_cuda", "stencil2d_cuda"}
    wkv = {k for k in ENTRY_POINTS if k.startswith("wkv_")}
    rg = {"elevator_scan_cuda", "elevator_decode_window_cuda", "token_shift_cuda",
          "elevator_scan_bwd_cuda", "token_shift_bwd_cuda", "flash_attention_cuda",
          "flash_attention_bwd_cuda"}
    assert by_arch["rwkv6-1.6b"] == wkv | demo
    assert by_arch["recurrentgemma-2b"] == rg | demo
    assert by_arch["gemma3-1b"] == {"flash_attention_cuda", "flash_attention_bwd_cuda"} | demo
    for arch in ("qwen2-0.5b", "minitron-8b", "nemotron-4-15b", "qwen2-vl-7b", "dbrx-132b",
                 "qwen3-moe-235b-a22b", "seamless-m4t-large-v2"):
        assert by_arch[arch] == {"flash_attention_cuda"} | demo


def test_launches_follow_the_planners():
    """Spot checks against the planners and the source's grids: the WKV
    forward's column tile, the flash backward's GQA cluster, the matmul's
    persistent grid, the stencil's rows."""
    from repro_torch.kernels.local_attention import kernel as FA
    from repro_torch.kernels.stencil2d import kernel as ST
    from repro_torch.kernels.wkv import kernel as WK

    sms = common.H100_SMS
    rw = resources.launches(get_config("rwkv6-1.6b"), sms)
    prefill = next(x for x in rw if x.kernel == "wkv_cuda" and "prefill" in x.shape)
    col = WK.plan_columns(4, 32, 256, 16, torch.bfloat16, sms)
    assert prefill.grid == (64 // col, 4 * 32, 1)
    g3 = resources.launches(get_config("gemma3-1b"), sms)
    dkdv = [x for x in g3 if x.kernel == "flash_attention_bwd_cuda" and x.cluster_size > 1]
    plan = FA.plan_flash_bwd(4, 4, 1, 2048, 2048, 256, sms)
    assert len(dkdv) == 1 and dkdv[0].cluster == (plan.cluster, 1, 1)
    assert dkdv[0].grid[0] % plan.cluster == 0
    mm = [x for x in rw if x.kernel == "matmul_fwd_cuda" and "bf16" in x.shape]
    assert mm[0].grid == (sms, 1, 1) and mm[0].dynamic_smem > 48 * 1024
    st = [x for x in rw if x.kernel == "stencil2d_cuda"]
    assert [dict(x.meta)["rows"] for x in st] == [ST.plan_stencil(256, 512, torch.float32, sms),
                                                  16]


# --------------------------------------------------------------------------
# mutation drills
# --------------------------------------------------------------------------

def _mutant(**kw):
    base = dict(kernel="mutant_cuda",
                location="src/repro_torch/kernels/mutant/csrc/mutant.cu:launch", shape="mutant B=1", grid=(8, 1, 1), threads=128, dynamic_smem=1024,
                library="mutant", occupancy=(0,))
    return common.KernelLaunch(**{**base, **kw})


def test_mutation_300kb_of_dynamic_shared_memory(monkeypatch):
    resources.load_specs()
    monkeypatch.setitem(common.KERNEL_LAUNCH_SPECS, "mutant_cuda",
                        lambda cfg, sms: [_mutant(dynamic_smem=300 * 1024)])
    errs = F.errors(resources.run(get_config("rwkv6-1.6b")))
    assert errs, "the resources pass missed a 300 KB block"
    assert all("mutant.cu" in e.location for e in errs), F.format_table(errs)
    assert len(errs) == 1 and "exceed" in errs[0].message
    assert errs[0].metrics["smem_bytes"] > common.SMEM_LIMIT


def test_mutation_cluster_that_does_not_divide_its_grid(monkeypatch):
    resources.load_specs()
    monkeypatch.setitem(common.KERNEL_LAUNCH_SPECS, "mutant_cuda",
                        lambda cfg, sms: [_mutant(grid=(10, 1, 1), cluster=(4, 1, 1))])
    errs = F.errors(resources.run(get_config("gemma3-1b")))
    assert len(errs) == 1 and "does not divide" in errs[0].message, F.format_table(errs)
    assert errs[0].location.endswith("mutant.cu:launch")


@pytest.mark.parametrize("bad", [dict(threads=48), dict(grid=(1, 70000, 1)),
                                 dict(cluster=(16, 1, 1), grid=(16, 1, 1))])
def test_mutation_malformed_block_or_grid(monkeypatch, bad):
    resources.load_specs()
    monkeypatch.setitem(common.KERNEL_LAUNCH_SPECS, "mutant_cuda",
                        lambda cfg, sms: [_mutant(**bad)])
    errs = F.errors(resources.run(get_config("gemma3-1b")))
    assert len(errs) == 1 and errs[0].location.endswith("mutant.cu:launch"), F.format_table(errs)


def test_mutation_planner_that_raises(monkeypatch):
    resources.load_specs()

    def refuses(cfg, sms):
        raise ValueError("no tile fits")

    monkeypatch.setitem(common.KERNEL_LAUNCH_SPECS, "wkv_bwd_cuda", refuses)
    errs = F.errors(resources.run(get_config("rwkv6-1.6b")))
    assert len(errs) == 1 and errs[0].location == "src/repro_torch/kernels:wkv_bwd_cuda"
    assert "no tile fits" in errs[0].message


def test_mutation_no_spec_applies(monkeypatch):
    specs = resources.load_specs()
    for name in list(specs):
        if name not in common.EVERY_ARCH_SPECS:
            monkeypatch.setitem(specs, name, lambda cfg, sms: [])
    errs = F.errors(resources.run(get_config("gemma3-1b")))
    assert len(errs) == 1 and errs[0].location.endswith("common.py:KERNEL_LAUNCH_SPECS")


def test_mutation_decode_state_drift(monkeypatch):
    """A decode window that moved twice the state it declares is caught."""
    from repro_torch.kernels.wkv import decode as WD

    real = WD.decode_launch

    def doubled(*a, **kw):
        import dataclasses

        got = real(*a, **kw)
        return dataclasses.replace(got, state_bytes=2 * got.state_bytes)

    monkeypatch.setattr(WD, "decode_launch", doubled)
    errs = F.errors(resources.run(get_config("rwkv6-1.6b")))
    assert errs and all("drifted" in e.message and "wkv_decode.cu" in e.location for e in errs)


def test_mutation_free_slot_made_a_no_op(monkeypatch):
    from repro_torch.serve.paging import PagedController

    monkeypatch.setattr(PagedController, "free_slot", lambda self, slot: None)
    errs = F.errors(paging.run(get_config("gemma3-1b")))
    assert errs, "paging pass missed the leaked pages"
    assert any("leaked" in e.message or "survived" in e.message for e in errs)
    assert all(e.location.endswith("PagedController") for e in errs)


def test_mutation_ring_slack_rule_returns_nothing(monkeypatch):
    from repro_torch.model import model as M

    monkeypatch.setattr(M, "_check_ring_slack", lambda *a, **kw: None)
    errs = F.errors(ringslack.run(get_config("gemma3-1b")))
    assert len(errs) == 1 and "check is dead" in errs[0].message
    assert errs[0].location.endswith("_check_ring_slack")


def test_mutation_slackless_ring(monkeypatch):
    from repro_torch.model import model as M

    orig = M.init_decode_state

    def ignores_insert_window(cfg, batch, max_len, insert_window=1, *a, **kw):
        return orig(cfg, batch, max_len, 1, *a, **kw)

    monkeypatch.setattr(M, "init_decode_state", ignores_insert_window)
    errs = F.errors(ringslack.run(get_config("recurrentgemma-2b")))
    assert errs and all("ring contract" in e.message for e in errs)
    assert all(e.location.endswith("_check_ring_slack") for e in errs)


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------

def test_cli_host_tier_imports_no_torch():
    r = _cli("--passes", "hostsafety", "--strict", flags=("-X", "importtime"))
    assert r.returncode == 0, r.stdout + r.stderr
    imported = {ln.split("|")[-1].strip() for ln in r.stderr.splitlines() if "|" in ln}
    assert "repro_torch.analysis.registry" in imported
    assert not {m for m in imported if m == "torch" or m.startswith("torch.")}
    assert "host" in r.stdout and "lock-discipline" in r.stdout


def test_cli_json_rows_in_the_references_shape():
    mine = _cli("--passes", "hostsafety", "--json")
    ref = _cli("--passes", "hostsafety", "--json", module="repro.analysis")
    assert mine.returncode == 0 and ref.returncode == 0, mine.stderr + ref.stderr
    rows, ref_rows = json.loads(mine.stdout), json.loads(ref.stdout)
    assert rows and ref_rows
    assert {tuple(sorted(r)) for r in rows} == {tuple(sorted(r)) for r in ref_rows}
    assert {r["arch"] for r in rows} == {r["arch"] for r in ref_rows} == {"host"}
    assert {r["severity"] for r in rows} <= {"INFO", "WARN", "ERROR"}
    arch = _cli("--arch", "rwkv6-1.6b", "--passes", "resources,ringslack", "--json")
    assert arch.returncode == 0, arch.stderr
    rows = json.loads(arch.stdout)
    assert {tuple(sorted(r)) for r in rows} == {tuple(sorted(r)) for r in ref_rows}
    assert {r["pass"] for r in rows} == {"resources", "ringslack"}


def test_cli_single_arch_strict():
    r = _cli("--arch", "gemma3-1b", "--strict", "--device", "cpu")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "gemma3-1b" in r.stdout and "planned for 132 SMs" in r.stdout


def test_cli_default_archs_strict_and_its_exit_contract():
    r = _cli("--strict", "--sms", "114", "--device", "cpu")
    assert r.returncode == 0, r.stdout + r.stderr
    assert all(a in r.stdout for a in DEFAULT_ARCHS)
    # An ERROR sets the exit status: a card of no SMs, which the stencil's
    # planner refuses.
    bad = _cli("--arch", "rwkv6-1.6b", "--passes", "resources", "--sms", "0")
    assert bad.returncode == 1, bad.stdout + bad.stderr
    assert "error" in bad.stdout and "stencil2d_cuda" in bad.stdout


def test_run_passes_routes_the_sm_count():
    findings = run_passes(get_config("rwkv6-1.6b"), ["hostsafety", "resources"], sms=114)
    assert {f.pass_name for f in findings} == {"hostsafety", "resources"}
    assert not F.errors(findings)
