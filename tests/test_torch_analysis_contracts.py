"""The port's last four analysis passes (``donation``, ``fleet``,
``dtype_flow``, ``retrace``) and the roofline's two readers, held against
the reference's on the CPU.

* **clean tree** — donation and retrace on the three default archs, fleet
  and dtype_flow on all ten: findings, none of them errors;
* **agreement** — dtype_flow's I/O dtypes equal ``jax.eval_shape`` of the
  reference's dispatch, and its recurrent state groups the reference's
  ``audit_state_dtypes`` count on all ten archs; retrace's admission shapes
  and buckets equal the reference pass's ``admits`` / ``buckets`` for the
  same prompts (one module fixture); ``parse_collective_bytes`` of the seq
  path's hops over 4 "cpu" shards equals the collectives pass's counted
  bytes, and ``cost_analysis_dict`` the counter's totals;
* **mutations** — seven regressions, each caught as an ERROR by its own
  pass only, at the location that names the contract: a window that
  rebinds a state leaf, a shadow checksum that writes, a caller-side f32
  upcast around ``wkv_fused``, identity bucketing, snapshot meta fields 3
  and 4 swapped, an admission without its checksum rows, an unregistered
  dispatch;
* **plumbing** — ``run_passes`` routes ``device``, the executing passes
  default to the card, and the CLI with ``--device cpu`` reports every
  pass.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.analysis import donation, dtype_flow, fleet, retrace
from repro_torch.analysis import findings as F
from repro_torch.analysis.registry import DEFAULT_ARCHS, PASS_MODULES, run_passes
from repro_torch.configs.registry import get_config, list_archs
from repro_torch.model import model as M
from repro_torch.serve import engine as E

ROOT = Path(__file__).resolve().parents[1]
ARCHS = [get_config(a).name for a in list_archs()]
NEW_PASSES = {"dtype_flow": dtype_flow, "donation": donation, "fleet": fleet,
              "retrace": retrace}
#: The passes that execute dispatches, and so take ``device``.
EXECUTING = ("donation", "fleet", "retrace")
RWKV = "rwkv6-1.6b"


def _run(name, cfg, **kw):
    if name in EXECUTING:
        kw.setdefault("device", "cpu")
    return NEW_PASSES[name].run(cfg, **kw)


def _assert_clean(findings, name, arch):
    assert findings, f"{name} was silent for {arch} (must report evidence)"
    assert all(f.pass_name == name for f in findings)
    errs = F.errors(findings)
    assert not errs, "\n" + F.format_table(errs, title=f"{arch}/{name}")


# --------------------------------------------------------------------------
# clean tree
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", DEFAULT_ARCHS)
@pytest.mark.parametrize("name", ["donation", "retrace"])
def test_executing_pass_clean_on_default_archs(name, arch):
    _assert_clean(_run(name, get_config(arch)), name, arch)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("name", ["fleet", "dtype_flow"])
def test_pass_clean_on_every_arch(name, arch):
    _assert_clean(_run(name, get_config(arch)), name, arch)


def test_donation_registers_every_dispatch():
    """The serve engine's seven entries and the train step, with the
    shadow checksum the one read-only entry; an encoder-decoder arch has
    the train step alone."""
    from repro_torch.analysis.registry import dispatch_entries

    entries = dispatch_entries(get_config(RWKV).reduced(), "cpu")
    assert [e.name for e in entries] == [
        "serve.prefill", "serve.window", "serve.serve_window", "serve.admit",
        "serve.shadow_checksum", "serve.paged_window", "serve.paged_admit", "train.step"]
    assert [e.name for e in entries if e.updated is None] == ["serve.shadow_checksum"]
    assert {(e.kind, e.paged) for e in entries if e.kind} == {
        ("admit", False), ("window", False), ("admit", True), ("window", True)}
    enc_dec = dispatch_entries(get_config("seamless-m4t-large-v2").reduced(), "cpu")
    assert [e.name for e in enc_dec] == ["train.step"]
    findings = donation.run(get_config("seamless-m4t-large-v2"), device="cpu")
    assert [f.severity.name for f in findings] == ["INFO"]


# --------------------------------------------------------------------------
# agreement with the reference
# --------------------------------------------------------------------------

def _ref_config(name):
    from repro.configs.registry import get_config as ref_get_config

    return ref_get_config(name)


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "recurrentgemma-2b"])
def test_dtype_flow_io_dtypes_equal_the_references_eval_shape(arch):
    import jax
    import jax.numpy as jnp

    from repro.kernels.elevator_scan import ops as ref_elev
    from repro.kernels.wkv import ops as ref_wkv

    cfg = get_config(arch)
    rcfg = _ref_config(arch)
    sds = jax.ShapeDtypeStruct
    b, t = 1, 64
    if "rwkv" in cfg.pattern:
        h = cfg.d_model // 64
        act = sds((b, h, t, 64), jnp.bfloat16)
        args = (act, act, act, act, sds((h, 64), jnp.bfloat16),
                sds((b, h, 64, 64), jnp.float32))
        want = {uk: tuple(str(x.dtype) for x in jax.tree.leaves(jax.eval_shape(
            lambda *a, _uk=uk: ref_wkv.wkv_fused(*a, chunk=16, use_kernel=_uk,
                                                 decode=False), *args)))
            for uk in (False, True)}
        what = {False: "wkv_fused[plain]", True: "wkv_fused[kernel]"}
    else:
        a = sds((b, t, rcfg.d_rnn), jnp.bfloat16)
        ref = tuple(str(x.dtype) for x in jax.tree.leaves(jax.eval_shape(
            lambda a_, x_: ref_elev.elevator_scan(a_, x_, None, use_kernel=False,
                                                  decode=False), a, a)))
        want = {False: ref, True: ref}
        what = {False: "elevator_scan[plain]", True: "elevator_scan[kernel]"}
    findings = dtype_flow.run(cfg)
    for uk, tag in what.items():
        got = [f.metrics["out_dtypes"] for f in findings
               if "out_dtypes" in f.metrics and tag in f.message]
        assert got == [want[uk]], (tag, got, want[uk])


@pytest.mark.parametrize("arch", ARCHS)
def test_dtype_flow_state_groups_equal_the_references(arch):
    from repro.analysis import dtype_flow as ref_dtype_flow

    mine = dtype_flow.audit_state_dtypes(get_config(arch).reduced())
    ref = ref_dtype_flow.audit_state_dtypes(_ref_config(arch).reduced())
    assert [f.severity.name for f in mine] == [f.severity.name for f in ref]
    assert [f.metrics.get("rec_groups") for f in mine] == [
        f.metrics.get("rec_groups") for f in ref]


@pytest.fixture(scope="module")
def retrace_pair():
    """The reference's retrace pass and the port's on rwkv6, same prompts."""
    from repro.analysis import retrace as ref_retrace

    ref = ref_retrace.run(_ref_config(RWKV))
    mine = retrace.run(get_config(RWKV), device="cpu")
    return mine, ref


def test_retrace_admits_and_buckets_equal_the_references(retrace_pair):
    mine, ref = retrace_pair
    assert [f.severity.name for f in mine] == [f.severity.name for f in ref] == ["INFO"]
    assert mine[0].metrics == ref[0].metrics == {"admits": 2, "buckets": 2}


def test_parse_collective_bytes_equals_the_collectives_count():
    from repro_torch.analysis import collectives as C
    from repro_torch.core.device_comm import record_hops
    from repro_torch.kernels.wkv.seqpar import wkv_seqshard
    from repro_torch.launch import roofline as R
    from repro_torch.launch.mesh import make_seq_mesh
    from repro_torch.launch.roofline_run import extrapolated_costs

    cfg = get_config(RWKV)
    mesh = make_seq_mesh(4, device="cpu")
    findings = C.run(cfg, mesh=mesh)
    counted = [f.metrics for f in findings if "per_device_bytes" in f.metrics]
    h = cfg.d_model // 64
    with record_hops() as hops:
        wkv_seqshard(*C.seq_inputs(1, h, 64, 64, "cpu"), mesh=mesh, seq_axis="seq", chunk=8)
    coll = R.parse_collective_bytes(hops)
    assert coll["collective-permute"]["bytes"] == coll["total_bytes"] == counted[0][
        "per_device_bytes"] > 0
    assert coll["collective-permute"]["count"] == counted[0]["collectives"]
    assert set(coll) == {"all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                         "collective-permute", "total_bytes"}
    assert R.parse_collective_bytes([])["total_bytes"] == 0
    # The roofline's cost reads them: a trace with these hops reports their bytes.
    from repro_torch.core.lowering import CostCounter

    tot = extrapolated_costs(RWKV, "decode_32k", CostCounter(), hops)["extrapolated"]
    assert tot["coll"] == coll["total_bytes"]
    assert tot["coll_by_op"]["collective-permute"] == coll["total_bytes"]


def test_all_to_all_hops_count_their_dtype():
    from repro_torch.core import device_comm
    from repro_torch.launch import roofline as R

    xs = [torch.zeros(4, 8, dtype=torch.bfloat16) for _ in range(4)]
    with device_comm.record_hops() as hops:
        device_comm.all_to_all(xs, 0, 0)
    coll = R.parse_collective_bytes(hops)
    assert coll["all-to-all"] == {"bytes": 32 * 3 // 4 * 2, "count": 1}


def test_cost_analysis_dict_is_the_counters_totals():
    from repro_torch.launch import dryrun
    from repro_torch.launch import roofline as R

    cell, counter, _ = dryrun.trace_cell(RWKV, "decode_32k")
    ca = R.cost_analysis_dict(counter)
    assert ca == {"flops": counter.total_flops, "bytes accessed": float(counter.total_bytes),
                  "flops_by_class": counter.flops_by_class()}
    assert ca["flops"] > 0 and cell.hops == []
    row = dryrun.run_cell(RWKV, "decode_32k", verbose=False)
    assert row["ok"] and row["roofline"]["collective_bytes"] == 0
    assert row["collectives_raw"]["total_bytes"] == 0
    assert row["roofline"]["flops"] == ca["flops"]


# --------------------------------------------------------------------------
# mutations: each caught by its own pass only, at its own location
# --------------------------------------------------------------------------

def _caught_only_by(name, location, cfg=None, **kw):
    """Run the four passes on rwkv6 (``kw`` to ``name``'s): errors from
    ``name`` alone, every one at ``location``."""
    cfg = cfg or get_config(RWKV)
    errs = {}
    for other in NEW_PASSES:
        errs[other] = F.errors(_run(other, cfg, **(kw if other == name else {})))
    assert errs[name], f"{name} missed the mutation"
    assert all(e.location.endswith(location) for e in errs[name]), F.format_table(errs[name])
    others = [e for p, es in errs.items() if p != name for e in es]
    assert not others, F.format_table(others)
    return errs[name]


def _first_node(state):
    key = "scanned" if state["scanned"] else "remainder"
    return key, state[key]


def test_mutation_window_rebinds_a_state_leaf(monkeypatch):
    orig = E.ServeSession._window

    def rebinding(self):
        out = orig(self)
        key, nodes = _first_node(self.state)
        nodes[0] = nodes[0]._replace(h=nodes[0].h.clone())   # a copy, not a write
        return out

    monkeypatch.setattr(E.ServeSession, "_window", rebinding)
    errs = _caught_only_by("donation", "ServeSession._window")
    assert {e.message.split(":")[0] for e in errs} == {"serve.serve_window",
                                                       "serve.paged_window"}
    assert all("rebound" in e.message for e in errs)


def test_mutation_shadow_checksum_that_writes(monkeypatch):
    orig = E.ServeSession._spot_check

    def writes(self):
        orig(self)
        _, nodes = _first_node(self.state)
        nodes[0].h.add_(1.0)

    monkeypatch.setattr(E.ServeSession, "_spot_check", writes)
    errs = _caught_only_by("donation", "ServeSession._spot_check")
    assert len(errs) == 1 and "read-only" in errs[0].message


def test_mutation_caller_side_upcast_around_wkv_fused(monkeypatch):
    from repro_torch.kernels.wkv import ops as wkv_ops

    orig = wkv_ops.wkv_fused

    def upcast_dispatch(r, k, v, w, u, h0, **kw):
        # The classic regression: "for safety" float32 on the I/O path.
        out, s = orig(r.float(), k.float(), v.float(), w.float(), u.float(), h0, **kw)
        return out.to(r.dtype), s

    monkeypatch.setattr(wkv_ops, "wkv_fused", upcast_dispatch)
    errs = _caught_only_by("dtype_flow", "kernels/wkv/ops.py:wkv_fused")
    assert len(errs) == 2 and all("upcast" in e.message for e in errs)
    assert all(e.metrics["upcasts"] == 4 for e in errs)


def test_mutation_identity_bucketing(monkeypatch):
    # Identity "bucketing": every distinct prompt length becomes its own
    # admission shape.  slots=1 serializes admissions so each request's
    # exact length reaches the shape.
    monkeypatch.setattr(E, "_bucket32", lambda length: max(int(length), 1))
    errs = _caught_only_by("retrace", "serve/engine.py:ServeEngine", slots=1)
    assert any("bucketing" in e.message and e.metrics.get("admits", 0) > 2
               for e in errs), F.format_table(errs)


def test_mutation_snapshot_meta_fields_swapped(monkeypatch):
    orig = E.ServeEngine._serve_meta

    def swapped(self, b, k_w, insert_window, n, seed, ctl):
        # Request count and seed trade places: every field is still there,
        # so only a layout-aware audit catches it before a handoff trusts
        # meta[3] as the request count.
        m = orig(self, b, k_w, insert_window, n, seed, ctl).copy()
        m[3], m[4] = m[4], m[3]
        return m

    monkeypatch.setattr(E.ServeEngine, "_serve_meta", swapped)
    errs = _caught_only_by("fleet", "serve/fleet.py:FleetRouter")
    assert len(errs) == 1 and "field order" in errs[0].message


def test_mutation_admit_without_checksum_rows(monkeypatch):
    orig = E.ServeSession._admit

    def unchained(self):
        # The admission's dispatch built without its checksum rows (and
        # without the chain check that reads them).
        every, self.checksum_every = self.checksum_every, 0
        try:
            return orig(self)
        finally:
            self.checksum_every = every

    monkeypatch.setattr(E.ServeSession, "_admit", unchained)
    errs = _caught_only_by("fleet", "ServeSession._admit")
    assert {e.message.split(": ")[1].split()[0] for e in errs} == {"serve.admit",
                                                                  "serve.paged_admit"}


def test_mutation_unregistered_dispatch(monkeypatch):
    orig = E.ServeSession._decode_window

    def with_compaction(self):
        # A new dispatch kind a replica issues, never registered for audit.
        self._dispatch("compact", lambda: None)
        return orig(self)

    monkeypatch.setattr(E.ServeSession, "_decode_window", with_compaction)
    errs = _caught_only_by("fleet", "serve/engine.py:audit_dispatch_entrypoints")
    assert len(errs) == 2 and all("'compact'" in e.message for e in errs)


# --------------------------------------------------------------------------
# plumbing
# --------------------------------------------------------------------------

def test_run_passes_routes_the_device():
    findings = run_passes(get_config(RWKV), ["dtype_flow", "donation", "fleet", "retrace"],
                          device="cpu", sms=114)
    assert [f.pass_name for f in findings if f.pass_name != "dtype_flow"][:1] == ["donation"]
    assert {f.pass_name for f in findings} == {"dtype_flow", "donation", "fleet", "retrace"}
    assert not F.errors(findings)


def test_executing_passes_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config(RWKV)
    for name in EXECUTING:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            NEW_PASSES[name].run(cfg)


def test_cli_reports_every_pass_on_the_cpu():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
    r = subprocess.run([sys.executable, "-m", "repro_torch.analysis", "--arch", RWKV,
                        "--strict", "--json", "--device", "cpu"],
                       capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    rows = json.loads(r.stdout)
    assert [p for p in PASS_MODULES if p in {x["pass"] for x in rows}] == list(PASS_MODULES)
    assert {x["severity"] for x in rows} == {"INFO"}
    held = [x for x in rows if x["pass"] == "donation"]
    assert len(held) == 8 and all(x["arch"] == RWKV for x in held)


def test_state_checksum_rows_are_what_fleet_holds():
    """The fleet pass's reading of a window's host array: its last two
    rows are the state's checksums before and after the dispatch."""
    rcfg = get_config(RWKV).reduced()
    eng = E.ServeEngine(rcfg, M.init_params(rcfg, 0, device="cpu"), max_len=64,
                        decode_window=4, device="cpu")
    kinds, rows = fleet.session_rows(eng, 2)
    assert kinds == {"admit", "window"}
    for kind in ("admit", "window"):
        host, entry, exit_ = rows[kind]
        assert host.shape[1] == 2 and (host[-2] == entry).all() and (host[-1] == exit_).all()
    assert (rows["window"][1] == rows["admit"][2]).all()
