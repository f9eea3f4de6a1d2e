"""The port's ``collectives`` pass (``repro_torch.analysis.collectives``)
against the reference's, on the CPU.

* the pass is clean on the sequence-parallel WKV path at n = 1, 2 and 4
  shards (``meta`` shards, the reference's reduced size), and finds the
  reverse hops of the backward;
* mutation drills, each caught as an ERROR at its own location: an
  activation-sized ``all_to_all`` planted on the seq axis (a gather-class
  hop), a doubled state summary planted as a hop (over the per-hop
  budget), and a cost model that disagrees with the hop count;
* ``python -m repro_torch.analysis --passes collectives --strict`` in a
  subprocess;
* the findings against the reference's ``collectives.run`` on 8 fake host
  devices (one subprocess, one module fixture) at the same (b, h, t, dh,
  n): the same severities in the same order at the same locations (the
  port's paths), the same largest operand and budget, the same modeled
  bytes, and the counted bytes equal once the reference's final-state
  psum, which the single controller does not make, is added.
"""

import dataclasses
import inspect
import json
import os
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import pytest
import torch

from repro_torch.analysis import collectives as C
from repro_torch.analysis import findings as F
from repro_torch.configs.registry import get_config
from repro_torch.core import cost_model, device_comm
from repro_torch.kernels.wkv import seqpar

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
RWKV = "rwkv6-1.6b"

REF_SCRIPT = textwrap.dedent(
    """
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json
    import jax, numpy as np
    from jax.sharding import Mesh
    from repro.configs.registry import get_config
    from repro.analysis import collectives as C
    out = {}
    for n in (1, 2, 4):
        mesh = Mesh(np.array(jax.devices()[:n]), ("seq",))
        out[n] = [dict(severity=f.severity.name, location=f.location,
                       message=f.message, metrics=f.metrics)
                  for f in C.run(get_config("rwkv6-1.6b"), mesh=mesh)]
    print(json.dumps(out))
    """
)


@pytest.fixture(scope="module")
def ref():
    env = {"PYTHONPATH": SRC, "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
           "HOME": os.environ.get("HOME", "/tmp"), "JAX_PLATFORMS": "cpu"}
    res = subprocess.run([sys.executable, "-c", REF_SCRIPT], capture_output=True,
                         text=True, env=env, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return {int(k): v for k, v in json.loads(res.stdout.splitlines()[-1]).items()}


def _run(n):
    return C.run(get_config(RWKV), n=n)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_clean_on_the_seq_path(n):
    found = _run(n)
    assert not F.errors(found), F.format_table(found)
    assert {f.pass_name for f in found} == {"collectives"}
    if n > 1:
        cross = [f for f in found if f.location == C.COST_LOCATION]
        assert len(cross) == 1 and cross[0].metrics["divergence_pct"] == 0.0


@pytest.mark.parametrize("n", [2, 4])
def test_backward_has_reverse_hops_and_forward_none(n):
    from repro_torch.core.device_comm import record_hops
    from repro_torch.launch.mesh import make_seq_mesh

    args = C.seq_inputs(1, 2, 16 * n, 64, "meta")
    with record_hops() as fwd:
        out, s = seqpar.wkv_seqshard(*args, mesh=make_seq_mesh(n, device="meta"),
                                     seq_axis="seq", chunk=8)
    with record_hops() as bwd:
        torch.autograd.grad(out.sum() + s.sum(), args)
    assert C.has_reverse_hops(bwd) and not C.has_reverse_hops(fwd)


def test_no_rwkv_layers_is_an_info():
    (f,) = C.run(get_config("gemma3-1b"))
    assert f.severity == F.Severity.INFO and "no seq-parallel" in f.message


def _planted(monkeypatch, line):
    """``wkv_seqshard`` from a copy of seqpar with ``line`` run right after
    the summaries compose."""
    src = inspect.getsource(seqpar)
    anchor = "    carry_a, carry_b = device_linear_scan_carry(a_seg, s0, monoid=DIAG_STATE)\n"
    assert src.count(anchor) == 1
    mutant = types.ModuleType("seqpar_planted")
    mutant.__dict__.update(device_comm=device_comm, torch=torch)
    exec(compile(src.replace(anchor, anchor + line), "seqpar_planted", "exec"),
         mutant.__dict__)
    monkeypatch.setattr(seqpar, "wkv_seqshard", mutant.wkv_seqshard)


def test_drill_token_exchange_on_the_seq_axis(monkeypatch):
    _planted(monkeypatch, "    r = device_comm.all_to_all(r, 2, 2)\n")
    errs = F.errors(_run(4))
    assert errs and all(e.location == C.LOCATION for e in errs)
    assert all("gather collective 'all_to_all'" in e.message for e in errs)
    # 3/4 of each shard's (1, 32, 16, 64) tokens leave it, forward and back.
    assert [e.metrics["elements"] for e in errs] == [1 * 32 * 16 * 64 * 3 // 4] * 2


def test_drill_operand_over_budget(monkeypatch):
    _planted(monkeypatch, "    device_comm.device_shift([torch.cat([x, x]) for x in s0], 1)\n")
    errs = F.errors(_run(4))
    budget = 32 * 64 * 64
    over = [e for e in errs if "exceeds the per-hop budget" in e.message]
    assert over and all(e.location == C.LOCATION for e in over)
    assert over[0].metrics == {"elements": 2 * budget, "budget": budget}


def test_drill_cost_model_disagrees(monkeypatch):
    real = cost_model.wkv_seqshard_traffic

    def drifted(*a, **kw):
        naive, shared, direct = real(*a, **kw)
        bigger = dataclasses.replace(direct.traffic,
                                     fabric_bytes=2 * direct.traffic.fabric_bytes)
        return naive, shared, dataclasses.replace(direct, traffic=bigger)

    monkeypatch.setattr(cost_model, "wkv_seqshard_traffic", drifted)
    errs = F.errors(_run(4))
    assert len(errs) == 1 and errs[0].location == C.COST_LOCATION
    assert "drifted" in errs[0].message


def test_cli_collectives_strict():
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run([sys.executable, "-m", "repro_torch.analysis", "--passes",
                        "collectives", "--strict", "--arch", RWKV], capture_output=True,
                       text=True, env=env, cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "collectives" in r.stdout and "divergence 0.00%" in r.stdout


@pytest.mark.parametrize("n", [1, 2, 4])
def test_findings_agree_with_the_reference(ref, n):
    mine = _run(n)
    want = ref[n]
    assert [f.severity.name for f in mine] == [w["severity"] for w in want]
    assert [f.location for f in mine] == [
        w["location"].replace("src/repro/", "src/repro_torch/") for w in want]
    for f, w in zip(mine, want):
        if "max_elements" in w["metrics"]:
            assert f.metrics["max_elements"] == w["metrics"]["max_elements"]
            assert f.message.split("largest operand")[1] == w["message"].split(
                "largest operand")[1]
        if "modeled_bytes" in w["metrics"]:
            m = f.metrics
            assert m["modeled_bytes"] == w["metrics"]["modeled_bytes"]
            assert m["counted_bytes"] + m["psum_bytes"] == w["metrics"]["counted_bytes"]
            assert m["divergence_pct"] == w["metrics"]["divergence_pct"] == 0.0
    # The forward's hops: the reference's collectives less its one psum.
    fwd, ref_fwd = mine[0].metrics, want[0]["metrics"]
    assert fwd["collectives"] == ref_fwd["collectives"] - 1
    assert fwd["per_device_bytes"] + 32 * 64 * 64 * 4 == ref_fwd["per_device_bytes"]
