"""Host-tier safety audit of the port (``repro_torch.analysis.hostsafety``),
held against the reference's pass (``repro.analysis.hostsafety``).

The port's tree audits with no ERROR and no WARN, and its lock inventory
matches the reference's pass over the reference's tree; the reference's
synthetic fixtures give the same tags and severities through both passes;
five reintroduced bugs (an unlocked watchdog result write, a dropped
generation fence, ``busy`` sampled before the round, the start-flag raise
dropped from ``ServeEngine._dispatch``, ``save_async`` handing its thread
the caller's tree) are each caught as an ERROR at their own location.

Both passes are pure AST: nothing here imports jax or torch.
"""

import re
import sys

import pytest

from repro.analysis import hostsafety as REF
from repro_torch.analysis import hostsafety as HS
from repro_torch.analysis.findings import Severity

# The reference's synthetic fixtures (tests/test_hostsafety.py).
from test_hostsafety import BARE_ACQUIRE_FIXTURE, LOCK_CYCLE_FIXTURE


def _errors(findings):
    return [f for f in findings if f.severity >= Severity.ERROR]


def _warns(findings):
    return [f for f in findings if f.severity == Severity.WARN]


def _tags(findings):
    """(tag, severity name) of every tagged finding, sorted."""
    out = []
    for f in findings:
        m = re.search(r"\[([a-z-]+)\]", f.message)
        if m:
            out.append((m.group(1), f.severity.name))
    return sorted(out)


def _mutated(rel, old, new):
    """The port's sources with ``old`` -> ``new`` applied in ``rel``; the
    anchor must occur exactly once, so a refactor that moves the code fails
    here instead of turning the drill into a no-op."""
    srcs = HS._read_tree_sources()
    assert rel in srcs, f"{rel} missing from HOST_MODULES sources"
    assert srcs[rel].count(old) == 1, (
        f"mutation anchor drifted in {rel}: {old!r} found {srcs[rel].count(old)} times")
    srcs[rel] = srcs[rel].replace(old, new)
    return srcs


def _the_error(findings, rule, loc_parts):
    """The first ERROR tagged ``rule``; every ERROR lies at ``loc_parts``
    (the drill is caught at its own location and nowhere else)."""
    errs = _errors(findings)
    tagged = [f for f in errs if f"[{rule}]" in f.message]
    assert tagged, f"mutation not caught: no [{rule}] ERROR in {[f.message for f in errs]}"
    for f in errs:
        for part in loc_parts:
            assert part in f.location, (
                f"{f.message[:40]} caught at {f.location}, expected {part!r} in it")
    return tagged[0]


# --------------------------------------------------------------------------
# clean tree
# --------------------------------------------------------------------------


def test_port_tree_has_no_error_and_no_warn():
    findings = HS.run()
    assert findings
    assert _errors(findings) == [] and _warns(findings) == []
    assert not any("[parse]" in f.message for f in findings)
    assert {f.pass_name for f in findings} == {"hostsafety"}


def test_host_modules_are_the_references_under_the_port():
    """The reference's host modules, ``repro`` -> ``repro_torch``, less the
    XLA-only ``launch/dryrun.py`` the port does not have."""
    want = tuple(m.replace("src/repro/", "src/repro_torch/") for m in REF.HOST_MODULES
                 if not m.endswith("launch/dryrun.py"))
    assert HS.HOST_MODULES == want
    assert set(HS._read_tree_sources()) == set(HS.HOST_MODULES)


def test_lock_inventory_matches_the_reference():
    """Locks, thread targets and nested acquisition edges of the port's tree
    equal the reference pass's counts over the reference's tree."""
    def summary(findings):
        f = next(f for f in findings if f.location.endswith(":lock-discipline"))
        return {k: f.metrics[k] for k in ("locks", "threads", "edges")}, "acyclic" in f.message

    assert summary(HS.run()) == summary(REF.run())


def test_in_place_summaries_report_real_coverage():
    findings = HS.run()
    retry = next(f for f in findings if f.location.endswith(":retry-after-start"))
    args = next(f for f in findings if f.location.endswith(":thread-args"))
    assert retry.metrics == {"wrappers": 1, "handlers": 2, "guarded": 1, "violations": 0}
    assert "started" in retry.message and "DispatchDropped" in retry.message
    assert args.metrics["threads"] == 2 and args.metrics["copies"] == 1
    assert args.metrics["violations"] == 0


def test_waivers_are_listed_not_silent():
    waived = [f for f in HS.run() if "[bare-acquire]" in f.message and "waived" in f.message]
    assert len(waived) == 2
    assert all("serve/interleave.py:InstrumentedLock" in f.location for f in waived)


# --------------------------------------------------------------------------
# the reference's synthetic fixtures through both passes
# --------------------------------------------------------------------------

FIXTURES = {
    "lock-cycle": {"fix/pair.py": LOCK_CYCLE_FIXTURE},
    "bare-acquire": {"fix/holder.py": BARE_ACQUIRE_FIXTURE.format(waiver="")},
    "waiver": {"fix/holder.py": BARE_ACQUIRE_FIXTURE.format(
        waiver="  # hostsafety: ok(fixture)")},
    "parse": {"fix/broken.py": "def f(:\n"},
}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_tags_and_severities_match_the_reference(name):
    mine = HS.run_on_sources(FIXTURES[name])
    ref = REF.run_on_sources(FIXTURES[name])
    assert _tags(mine) == _tags(ref)
    assert _tags(mine), "the fixture raised no tagged finding"
    waivers = [f.message for f in mine if f.location.endswith(":waivers")]
    assert waivers == [f.message for f in ref if f.location.endswith(":waivers")]


# --------------------------------------------------------------------------
# mutation drills
# --------------------------------------------------------------------------

WATCHDOG = "src/repro_torch/ft/watchdog.py"
WATCHDOG_RESULT_BLOCK = (
    "            with self._lock:\n"
    "                if gen != self._gen:        # fenced: step was abandoned\n"
    "                    self.stale_discarded += 1\n"
    "                    return\n"
    "                outcome.append((ok, value))"
)


def test_unlocked_watchdog_result_write():
    srcs = _mutated(WATCHDOG, WATCHDOG_RESULT_BLOCK,
                    "            if gen != self._gen:        # fenced: step was abandoned\n"
                    "                self.stale_discarded += 1\n"
                    "                return\n"
                    "            outcome.append((ok, value))")
    f = _the_error(HS.run_on_sources(srcs), "unlocked-thread-write",
                   [WATCHDOG, "StepWatchdog.run"])
    assert f.location == f"{WATCHDOG}:StepWatchdog.run.target"


def test_dropped_generation_fence():
    srcs = _mutated(WATCHDOG, WATCHDOG_RESULT_BLOCK,
                    "            with self._lock:\n"
                    "                outcome.append((ok, value))")
    _the_error(HS.run_on_sources(srcs), "stale-thread-write",
               [WATCHDOG, "StepWatchdog.run.target"])


def test_busy_sampled_before_the_round():
    srcs = _mutated(
        "src/repro_torch/serve/fleet.py",
        "                self.step_round()\n"
        "                after = sum(1 for r in self.record if r is not None)\n"
        "                # Post-round state: a round that completed nothing is\n"
        "                # still progress if work remains in flight (busy\n"
        "                # session) or schedulable (shared queue) — only the\n"
        "                # all-idle, all-drained case is a wedge.\n"
        "                busy = any(self.sessions[i].busy for i in self._live())",
        "                busy = any(self.sessions[i].busy for i in self._live())\n"
        "                self.step_round()\n"
        "                after = sum(1 for r in self.record if r is not None)")
    _the_error(HS.run_on_sources(srcs), "guard-epoch-mix",
               ["src/repro_torch/serve/fleet.py", "FleetRouter.run"])


def test_retry_after_start_raise_dropped():
    srcs = _mutated(
        "src/repro_torch/serve/engine.py",
        "                if started:\n"
        "                    raise StepTimeout(\n"
        "                        f\"{kind} dispatch timed out after it began updating the \"\n"
        "                        \"decode state in place; resume from a snapshot\") from None\n",
        "")
    f = _the_error(HS.run_on_sources(srcs), "retry-after-start",
                   ["src/repro_torch/serve/engine.py", "ServeEngine._dispatch"])
    assert "StepTimeout" in f.message and "'started'" in f.message


def test_retry_after_start_flag_dropped():
    """With no start flag at all, no except path can be checked: the
    wrapper itself is the finding."""
    srcs = _mutated("src/repro_torch/serve/engine.py",
                    "                    gate.started = True\n", "")
    _the_error(HS.run_on_sources(srcs), "retry-after-start",
               ["src/repro_torch/serve/engine.py", "ServeEngine._dispatch"])


def test_save_async_hands_its_thread_the_callers_tree():
    srcs = _mutated("src/repro_torch/checkpoint/checkpoint.py",
                    "args=(directory, step, host_tree, mesh_shape, gen)",
                    "args=(directory, step, tree, mesh_shape, gen)")
    f = _the_error(HS.run_on_sources(srcs), "unsnapshotted-thread-arg",
                   ["src/repro_torch/checkpoint/checkpoint.py", "AsyncSaver.save_async"])
    assert "'tree'" in f.message


def test_unannotated_scalar_is_not_presumed_immutable():
    """An argument whose annotation does not vouch for it is a finding: the
    rule takes no name as proof of immutability."""
    srcs = _mutated("src/repro_torch/checkpoint/checkpoint.py",
                    "                   mesh_shape: tuple | None = None):",
                    "                   mesh_shape=None):")
    f = _the_error(HS.run_on_sources(srcs), "unsnapshotted-thread-arg",
                   ["AsyncSaver.save_async"])
    assert "'mesh_shape'" in f.message


def test_mutations_do_not_break_parsing():
    assert not any("[parse]" in f.message for f in HS.run_on_sources(HS._read_tree_sources()))


def test_pass_imports_no_torch():
    """The pass and the findings it returns import no torch."""
    assert HS.TORCH_FREE
    for mod in (HS, sys.modules["repro_torch.analysis.findings"]):
        src = open(mod.__file__).read()
        assert "import torch" not in src and "repro_torch.kernels" not in src
