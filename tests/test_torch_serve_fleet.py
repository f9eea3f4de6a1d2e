"""The replica fleet in the port, on the CPU: a counterpart of every test of
tests/test_serve_fleet.py (snapshot handoff after a replica kill, greedy
and sampled, dense and paged; the bit flip the checksum chain detects; the
shared queue's deadlines; the AsyncSaver's failure surface, the stalled
writer included; the pinned bit flip and kill; the ReplicaMonitor's
policy; ``serve_fleet_drain``; ``read_snapshot_host``'s validation; the
router's own checks), on the reduced configs with the reference's
parameters converted.

Beyond the reference's own checks, each greedy fleet run is held to the
reference's own fleet run of the same drill: streams, outcomes, the fleet's
counters, every replica's counters (but ``stragglers``, which read the host
clock), the monitors' states and the final assignment.  Sampled streams use
the port's own draw, so they are held to the port's single engine.  The
checksum chain is reached through a planted flip, its values are the
reference's checksum of the states the chain saw, and a slot the chain frees
in the window it completes never resolves request -1.  The WKV traffic
functions and ``serve_fleet_drain`` equal the reference's.
"""

import dataclasses
import shutil
import tempfile
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.core import cost_model as JCM
from repro.model import model as JM
from repro.model.recurrent import RecState as JRecState
from repro.serve import chaos as JCH
from repro.serve import engine as JE
from repro.ft import watchdog as JW
from repro.serve import fleet as JF
from repro_torch.checkpoint import checkpoint as C
from repro_torch.configs.registry import get_config
from repro_torch.core import cost_model as CM
from repro_torch.core.cost_model import serve_fleet_drain
from repro_torch.ft import watchdog as W
from repro_torch.launch import serve as launcher
from repro_torch.model import convert
from repro_torch.model import model as M
from repro_torch.model.recurrent import RecState
from repro_torch.serve import health as H
from repro_torch.serve.chaos import ChaosInjector, ReplicaKilled, bitflip_slot_state
from repro_torch.serve.engine import OUTCOMES, Request, ServeEngine, ServeSession
from repro_torch.serve.fleet import FleetRouter, read_snapshot_host

jax.config.update("jax_platform_name", "cpu")
# Tiny tensors: one intra-op thread, so parallel test workers do not
# oversubscribe the cores.
torch.set_num_threads(1)

SPEC = [(5, 9), (12, 3), (7, 14), (3, 6), (9, 11)]
_SETUPS = {}

#: The window observations (1-based, per detector) that a straggler
#: detector flags; empty outside the planted drill.
_PLANTED: set = set()
#: The planted drill's windows: three consecutive flags after the warmup
#: window degrade a replica's monitor.
STRAGGLER_WINDOWS = {2, 3, 4}


def _planted_observe(self, step_time_s):
    """``StragglerDetector.observe`` with the host clock left out: the
    ``n``-th window of a detector is a straggler iff ``n`` is planted."""
    self._seen += 1
    flagged = self._seen in _PLANTED
    self.flagged += flagged
    return flagged


@pytest.fixture(scope="module", autouse=True)
def _deterministic_stragglers():
    """Both frameworks' straggler detectors on :func:`_planted_observe` for
    the module: the fleet's monitors read the flags, and a loaded host
    would otherwise flag windows at random, in either framework's run."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(W.StragglerDetector, "observe", _planted_observe)
        mp.setattr(JW.StragglerDetector, "observe", _planted_observe)
        yield


class _plant:
    """``with _plant(windows):`` flags those windows of every detector."""

    def __init__(self, windows):
        self.windows = set(windows)

    def __enter__(self):
        _PLANTED.update(self.windows)

    def __exit__(self, *exc):
        _PLANTED.clear()


def _setup(arch):
    """(reference config, port config, reference params, port params),
    built once per arch and worker."""
    if arch not in _SETUPS:
        cfg_j = jax_config(arch).reduced()
        pj = JM.init_params(cfg_j, jax.random.key(0))
        _SETUPS[arch] = (cfg_j, get_config(arch).reduced(), pj,
                         convert.params_from_jax(jax.tree.map(np.asarray, pj)))
    return _SETUPS[arch]


def _requests(vocab, spec=SPEC, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(tokens=rng.integers(0, vocab, (pl,)).astype(np.int32), max_new_tokens=nn)
            for pl, nn in spec]


def _engine(arch, paged=False):
    _, cfg, _, pt = _setup(arch)
    return ServeEngine(cfg, pt, max_len=96, decode_window=4, device="cpu", paged=paged)


def _assert_streams_equal(base, outs):
    assert len(base) == len(outs)
    for i, (b, o) in enumerate(zip(base, outs)):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(o),
                                      err_msg=f"request {i} diverged from the fault-free run")


def _no_stragglers(stats):
    """Every counter but the straggler flags, which read the host clock."""
    return {k: v for k, v in stats.items() if k != "stragglers"}


def _run_fleet(engines, reqs, *, chaos=None, snapshot_every=1, checksum_every=2, **kw):
    root = tempfile.mkdtemp(prefix="fleet_test_")
    try:
        fl = FleetRouter(engines, reqs, slots=2, snapshot_every=snapshot_every,
                         snapshot_root=root, checksum_every=checksum_every, chaos=chaos, **kw)
        outs = fl.run()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return fl, outs


def _fleet(arch, chaos=None, paged=False, n_rep=3, **kw):
    """The port's fleet of ``n_rep`` replicas of ``arch`` on SPEC."""
    engines = [_engine(arch, paged) for _ in range(n_rep)]
    return _run_fleet(engines, _requests(_setup(arch)[1].vocab_size), chaos=chaos, **kw)


def _summary(fl, outs):
    """What a greedy fleet run is held to the reference's run by."""
    return {
        "streams": [np.asarray(o.tokens).tolist() for o in outs],
        "outcomes": [o.outcome for o in outs],
        "recoveries": [o.recoveries for o in outs],
        "fleet": dict(fl.stats),
        "replicas": [_no_stragglers(s) for s in fl.stats_by_replica()],
        "monitors": [m.state for m in fl.monitors],
        "assigned": list(fl.assigned),
    }


def _kill(at):
    return lambda inj: [None, inj(seed=7, replica_kill_at=(at,)), None]


#: The reference's fleet drills, by name: (arch, chaos per replica as a
#: function of the injector class, paged, FleetRouter keywords).
DRILLS = {
    "kill": ("rwkv6-1.6b", _kill(1), False, {}),
    "kill_paged": ("gemma3-1b", _kill(1), True, {}),
    "handoff": ("rwkv6-1.6b", _kill(2), False, {}),
    "fault_free": ("rwkv6-1.6b", None, False, {}),
    "bitflip": ("rwkv6-1.6b", lambda inj: [inj(seed=7, bitflip_at=(1,)), None, None],
                False, {}),
}


def _port_drill(name):
    arch, chaos, paged, kw = DRILLS[name]
    return _fleet(arch, chaos=None if chaos is None else chaos(ChaosInjector), paged=paged,
                  seed=0, **kw)


@pytest.fixture(scope="module")
def reference_runs():
    """The reference's own greedy fleet runs of DRILLS on the same converted
    weights and requests, once per module: {name: summary}, and the shared
    queue's shed run under "shed".  The drills of one arch share their
    three engines (a fleet run leaves an engine as it found it but for its
    jit caches), so each compiles once."""
    runs, pools = {}, {}
    for name, (arch, chaos, paged, kw) in DRILLS.items():
        cfg_j, _, pj, _ = _setup(arch)
        engines = pools.setdefault((arch, paged), [
            JE.ServeEngine(cfg_j, pj, max_len=96, decode_window=4, paged=paged)
            for _ in range(3)])
        reqs = [JE.Request(tokens=r.tokens, max_new_tokens=r.max_new_tokens)
                for r in _requests(cfg_j.vocab_size)]
        root = tempfile.mkdtemp(prefix="fleet_ref_")
        try:
            fl = JF.FleetRouter(engines, reqs, slots=2, snapshot_every=1, snapshot_root=root,
                                checksum_every=2, seed=0,
                                chaos=None if chaos is None else chaos(JCH.ChaosInjector), **kw)
            runs[name] = _summary(fl, fl.run())
        finally:
            shutil.rmtree(root, ignore_errors=True)
    cfg_j = _setup("rwkv6-1.6b")[0]
    fl = JF.FleetRouter(pools[("rwkv6-1.6b", False)][:1],
                        [JE.Request(tokens=r.tokens, max_new_tokens=r.max_new_tokens)
                         for r in _requests(cfg_j.vocab_size)], slots=2, max_queue=1)
    runs["shed"] = _summary(fl, fl.run())
    # The planted stragglers: the fault-free drill with the same windows
    # flagged in every detector, the straggler counters compared too.
    with _plant(STRAGGLER_WINDOWS):
        reqs = [JE.Request(tokens=r.tokens, max_new_tokens=r.max_new_tokens)
                for r in _requests(cfg_j.vocab_size)]
        root = tempfile.mkdtemp(prefix="fleet_ref_")
        try:
            fl = JF.FleetRouter(pools[("rwkv6-1.6b", False)], reqs, slots=2, snapshot_every=1,
                                snapshot_root=root, checksum_every=2, seed=0)
            outs = fl.run()
            runs["stragglers"] = dict(_summary(fl, outs),
                                      flagged=[s["stragglers"] for s in fl.stats_by_replica()])
        finally:
            shutil.rmtree(root, ignore_errors=True)
    return runs


class TestSnapshotHandoffParity:
    """Three replicas, one killed mid-decode and its device state dropped:
    every in-flight request finishes on the survivors bit-identical to a
    fault-free single engine, greedy and sampled, dense and paged, and the
    greedy runs equal the reference's fleet in every respect."""

    @pytest.mark.parametrize("temperature,top_k", [(0.0, 0), (0.8, 16)])
    def test_replica_kill_dense(self, temperature, top_k, reference_runs):
        reqs = _requests(_setup("rwkv6-1.6b")[1].vocab_size)
        base = _engine("rwkv6-1.6b").serve(reqs, slots=2, seed=0, temperature=temperature,
                                           top_k=top_k, recoverable=True)
        fl, outs = _fleet("rwkv6-1.6b", chaos=_kill(1)(ChaosInjector), seed=0,
                          temperature=temperature, top_k=top_k)
        assert fl.stats["replica_deaths"] == 1
        assert fl.stats["handoffs"] + fl.stats["handoff_requeued_fresh"] >= 1
        assert fl.monitors[1].state == H.DEAD
        assert all(o.outcome in ("ok", "eos", "recovered") for o in outs)
        _assert_streams_equal(base, outs)
        # The dead replica's device state is gone, its close() never ran.
        assert fl.sessions[1].state is None and fl.sessions[1].closed
        if temperature == 0.0:
            assert _summary(fl, outs) == reference_runs["kill"]

    def test_replica_kill_paged(self, reference_runs):
        reqs = _requests(_setup("gemma3-1b")[1].vocab_size)
        base = _engine("gemma3-1b", paged=True).serve(reqs, slots=2, seed=0, recoverable=True)
        fl, outs = _port_drill("kill_paged")
        assert fl.stats["replica_deaths"] == 1
        assert all(o.outcome in ("ok", "eos", "recovered") for o in outs)
        _assert_streams_equal(base, outs)
        assert _summary(fl, outs) == reference_runs["kill_paged"]
        for i in (0, 2):
            assert fl.engines[i].last_paged_stats["page_table_violations"] == 0

    def test_handoff_resumes_accepted_prefix(self, reference_runs):
        """A killed replica's snapshot prefix is charged as a recovery: an
        orphan resumes mid-stream (``recovered``), not from scratch."""
        fl, outs = _port_drill("handoff")
        assert fl.stats["replica_deaths"] == 1
        assert fl.stats["handoffs"] >= 1
        rec = [o for o in outs if o.outcome == "recovered"]
        assert rec and all(o.recoveries >= 1 for o in rec)
        assert _summary(fl, outs) == reference_runs["handoff"]

    def test_fault_free_fleet_matches_single_engine(self, reference_runs):
        """Routing itself is invisible: with no chaos the fleet's streams
        equal the single recoverable engine's."""
        reqs = _requests(_setup("rwkv6-1.6b")[1].vocab_size)
        base = _engine("rwkv6-1.6b").serve(reqs, slots=2, seed=0, recoverable=True)
        fl, outs = _port_drill("fault_free")
        assert fl.stats["replica_deaths"] == 0
        assert fl.stats["handoffs"] == 0
        assert fl.stats["assignments"] == len(reqs)
        _assert_streams_equal(base, outs)
        assert _summary(fl, outs) == reference_runs["fault_free"]

    def test_planted_stragglers_degrade_as_the_reference(self, reference_runs):
        """The same windows flagged in both frameworks' detectors: the
        straggler -> monitor -> routing path gives the reference's
        degraded monitors, fleet counters and streams, and the streams
        still equal a fault-free single engine's."""
        reqs = _requests(_setup("rwkv6-1.6b")[1].vocab_size)
        base = _engine("rwkv6-1.6b").serve(reqs, slots=2, seed=0, recoverable=True)
        with _plant(STRAGGLER_WINDOWS):
            fl, outs = _port_drill("fault_free")
        got = dict(_summary(fl, outs),
                   flagged=[s["stragglers"] for s in fl.stats_by_replica()])
        assert H.DEGRADED in got["monitors"]
        assert sum(got["flagged"]) >= len(STRAGGLER_WINDOWS)
        _assert_streams_equal(base, outs)
        assert got == reference_runs["stragglers"]


class TestBitflipDetection:
    """One flipped state bit is invisible to the ``isfinite`` quarantine but
    breaks the checksum chain: detected within the spot-check cadence,
    rolled back and recovered bit-identical."""

    def test_bitflip_detected_and_recovered(self, reference_runs):
        reqs = _requests(_setup("rwkv6-1.6b")[1].vocab_size)
        base = _engine("rwkv6-1.6b").serve(reqs, slots=2, seed=0, recoverable=True)
        fl, outs = _port_drill("bitflip")
        inj = fl.sessions[0].chaos
        assert inj.counters["bitflip"] == 1
        per_rep = fl.stats_by_replica()
        assert sum(s["corruptions"] for s in per_rep) >= 1
        assert any(o.outcome == "recovered" for o in outs)
        assert all(o.outcome in ("ok", "eos", "recovered") for o in outs)
        _assert_streams_equal(base, outs)
        assert _summary(fl, outs) == reference_runs["bitflip"]


class TestChecksumChain:
    """The chain in the single engine: the planted flip reaches
    ``_corrupted`` through the chain (not called directly), the chain's
    values are the reference's checksums of the states it saw, and with the
    chain off a serve computes no checksum at all."""

    @pytest.mark.parametrize("arch", ["rwkv6-1.6b", "gemma3-1b"])
    def test_chain_values_equal_reference_checksums(self, arch):
        cfg_j = _setup(arch)[0]
        sess = ServeSession(_engine(arch), _requests(cfg_j.vocab_size), slots=2,
                            checksum_every=2, recoverable=True)
        treedef = jax.tree.structure(JM.init_decode_state(
            cfg_j, batch=sess.b, max_len=96, insert_window=sess.insert_window))
        seen = 0
        while sess.busy:
            sess.step()
            st_j = jax.tree.unflatten(treedef, [jnp.asarray(a) for a in jax.tree.leaves(
                convert.state_to_jax_numpy(sess.state))])
            want = np.asarray(JM.decode_state_checksum(st_j)).astype(np.int64)
            np.testing.assert_array_equal(sess._csum_base, want)
            seen += 1
        assert seen >= 3 and sess.stats["checksum_spot_checks"] >= 1
        assert sess.stats["corruptions"] == 0

    def test_planted_flip_reaches_corrupted_through_the_chain(self, monkeypatch):
        calls = []
        real = ServeSession._corrupted

        def spy(self, slot, rollback):
            calls.append((self.slot_req[slot], rollback))
            return real(self, slot, rollback)

        monkeypatch.setattr(ServeSession, "_corrupted", spy)
        eng = _engine("rwkv6-1.6b")
        reqs = _requests(eng.cfg.vocab_size)
        base = eng.serve(reqs, slots=2, recoverable=True)
        inj = ChaosInjector(seed=7, bitflip_at=(1,))
        outs = eng.serve(reqs, slots=2, chaos=inj, checksum_every=2)
        st = eng.last_serve_stats
        victim = inj.events[0][2]
        # The chain caught it at the flipped window's entry and rolled back
        # the tokens that window emitted.
        assert calls == [(victim, calls[0][1])] and calls[0][1] > 0
        assert st["corruptions"] == 1 and st["recoveries"] == 1
        assert outs[victim].outcome == "recovered"
        _assert_streams_equal(base, outs)

    def test_flip_goes_unseen_with_the_chain_off(self, monkeypatch):
        """The same flip without the chain is silent: no corruption counted,
        no checksum computed (the chain costs nothing when it is off)."""
        eng = _engine("rwkv6-1.6b")
        reqs = _requests(eng.cfg.vocab_size)
        calls = []
        real = M.decode_state_checksum
        monkeypatch.setattr(M, "decode_state_checksum", lambda st: calls.append(1) or real(st))
        eng.serve(reqs, slots=2, chaos=ChaosInjector(seed=7, bitflip_at=(1,)))
        assert calls == [] and eng.last_serve_stats["corruptions"] == 0
        eng.serve(reqs[:2], slots=2, checksum_every=1)
        assert calls
        st = eng.last_serve_stats
        assert st["corruptions"] == 0 and st["checksum_spot_checks"] >= 1

    @pytest.mark.parametrize("every", [0, 2])
    def test_one_host_copy_a_dispatch(self, every, monkeypatch):
        """The chain's checksums ride the dispatch's one host copy: a step
        copies once an admission and once a window, chain on or off, and a
        spot check (outside any dispatch) once more."""
        eng = _engine("rwkv6-1.6b")
        sess = ServeSession(eng, _requests(eng.cfg.vocab_size), slots=2,
                            checksum_every=every, recoverable=True)
        copies = []
        real = torch.Tensor.cpu
        monkeypatch.setattr(torch.Tensor, "cpu", lambda t, *a, **k: copies.append(1)
                            or real(t, *a, **k))
        while sess.busy:
            before = dict(sess.stats)
            del copies[:]
            sess.step()
            grew = {k: sess.stats[k] - before[k] for k in
                    ("admissions", "decode_dispatches", "checksum_spot_checks")}
            assert len(copies) == sum(grew.values()), grew
        assert sess.stats["checksum_spot_checks"] == (0 if every == 0 else
                                                      sess.stats["decode_dispatches"] // 2)

    def test_slot_freed_by_the_chain_never_resolves_minus_one(self, monkeypatch):
        """A flip in a slot whose request completes in the very window the
        chain catches it: the completion loop skips the freed slot (its
        request is requeued, never resolved as request -1)."""
        resolved = []
        real = ServeSession._resolve

        def spy(self, ri):
            resolved.append(ri)
            return real(self, ri)

        monkeypatch.setattr(ServeSession, "_resolve", spy)
        eng = _engine("rwkv6-1.6b")
        # Both requests end in window 1 (1 token at admission, 4 in window
        # 0, their last 2 in window 1); the flip lands on one of them just
        # before window 1, whose entry checksum catches it.
        reqs = _requests(eng.cfg.vocab_size, spec=[(5, 7), (6, 7)])
        base = eng.serve(reqs, slots=2, recoverable=True)
        resolved.clear()
        inj = ChaosInjector(seed=0, bitflip_at=(1,))
        outs = eng.serve(reqs, slots=2, chaos=inj, checksum_every=4)
        st = eng.last_serve_stats
        assert inj.events[0][:2] == ("bitflip", 1)
        victim = inj.events[0][2]
        assert st["corruptions"] == 1 and st["decode_dispatches"] == 3
        # The neighbour resolves in window 1, the victim after its recovery.
        assert resolved == [1 - victim, victim]
        assert outs[victim].outcome == "recovered"
        assert [o.outcome for o in outs].count("recovered") == 1
        _assert_streams_equal(base, outs)


class TestSharedQueueDeadline:
    """``deadline_ms`` counts from arrival at the fleet: a request that ages
    out in the shared queue dies there, typed ``deadline``."""

    def test_expiry_in_shared_queue(self):
        reqs = _requests(_setup("rwkv6-1.6b")[1].vocab_size)
        box = [0.0]
        fl = FleetRouter([_engine("rwkv6-1.6b")], reqs, slots=2, deadline_ms=100.0,
                         clock=lambda: box[0])
        box[0] = 0.2                       # 200 ms in the shared queue
        fl.step_round()
        outs = fl.run()
        assert "deadline" in OUTCOMES
        assert all(o.outcome == "deadline" for o in outs)
        assert all(o.size == 0 for o in outs)
        assert fl.stats["shared_deadline_hits"] == len(reqs)
        assert fl.stats_by_replica()[0]["decode_dispatches"] == 0

    def test_per_request_deadline_only_kills_the_expired(self):
        vocab = _setup("rwkv6-1.6b")[1].vocab_size
        reqs = _requests(vocab, spec=SPEC[:4])
        late = Request(tokens=np.random.default_rng(9).integers(0, vocab, (6,)).astype(np.int32),
                       max_new_tokens=8, deadline_ms=1.0)
        box = [0.0]
        fl = FleetRouter([_engine("rwkv6-1.6b")], reqs + [late], slots=2,
                         clock=lambda: box[0])
        fl.step_round()                    # assigns the first 4, decodes
        box[0] = 0.05                      # 50 ms: only `late` is expired
        outs = fl.run()
        assert outs[-1].outcome == "deadline"
        assert all(o.outcome in ("ok", "eos") for o in outs[:-1])
        assert fl.stats["shared_deadline_hits"] == 1


class TestAsyncSaverFailure:
    """A failed or stalled background snapshot write surfaces on the next
    ``save_async`` / ``wait``: a handoff source that failed silently is
    worse than none."""

    def test_background_failure_surfaces(self, tmp_path, monkeypatch):
        def boom(directory, step, tree, mesh_shape=None):
            raise OSError("disk gone")

        monkeypatch.setattr(C, "save", boom)
        saver = C.AsyncSaver()
        saver.save_async(tmp_path, 0, {"x": np.zeros(2)})
        with pytest.raises(C.AsyncSaverError):
            saver.wait()
        saver.wait()                       # delivered once; reusable after

    def test_failure_surfaces_on_next_save(self, tmp_path, monkeypatch):
        calls = []

        def boom(directory, step, tree, mesh_shape=None):
            calls.append(step)
            raise OSError("disk gone")

        monkeypatch.setattr(C, "save", boom)
        saver = C.AsyncSaver()
        saver.save_async(tmp_path, 0, {"x": np.zeros(2)})
        with pytest.raises(C.AsyncSaverError):
            saver.save_async(tmp_path, 1, {"x": np.zeros(2)})
        assert calls == [0]

    def test_stalled_writer_surfaces_and_is_abandoned(self, tmp_path, monkeypatch):
        """A hung writer surfaces as an AsyncSaverError within the join
        budget (``stalls``), and its late completion is fenced off by the
        generation (``stale_discarded``), never delivered."""
        release = threading.Event()
        entered = threading.Event()

        def stall(directory, step, tree, mesh_shape=None):
            entered.set()
            release.wait(10.0)

        monkeypatch.setattr(C, "save", stall)
        saver = C.AsyncSaver()
        saver.save_async(tmp_path, 0, {"x": np.zeros(2)})
        assert entered.wait(5.0)
        with pytest.raises(C.AsyncSaverError, match="stalled"):
            saver.wait(timeout_s=0.05)
        assert saver.stalls == 1
        release.set()
        deadline = time.monotonic() + 5.0
        while saver.stale_discarded == 0 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert saver.stale_discarded == 1
        saver.wait()


class TestInjectorContracts:
    """Pinned ``bitflip_at`` / ``replica_kill_at`` fire exactly once, and the
    schedule replays under a fixed seed."""

    @staticmethod
    def _state(b=2):
        return {"scanned": None, "remainder": [
            RecState(h=torch.ones(b, 4, 4), conv=torch.zeros(b, 2, 4))]}

    def test_pinned_bitflip_fires_exactly_once(self):
        inj = ChaosInjector(seed=0, bitflip_at=(3,))
        state = self._state()
        before = state["remainder"][0].h.clone()
        active = np.array([True, True])
        same, slot = inj.maybe_bitflip(state, active, 2, [0, 1])
        assert slot is None and same is state
        flipped, slot = inj.maybe_bitflip(state, active, 3, [0, 1])
        assert slot is not None
        assert not torch.equal(flipped["remainder"][0].h, before)
        _, slot2 = inj.maybe_bitflip(state, active, 3, [0, 1])
        assert slot2 is None
        assert inj.counters["bitflip"] == 1

    def test_pinned_replica_kill_fires_exactly_once(self):
        inj = ChaosInjector(seed=0, replica_kill_at=(5,))
        inj.check_replica_kill(4)
        with pytest.raises(ReplicaKilled):
            inj.check_replica_kill(5)
        inj.check_replica_kill(5)          # a retry at the same index: no-op
        assert inj.counters["replica_kill"] == 1
        assert inj.events == [("replica_kill", 5, None)]

    def test_bitflip_schedule_replays_under_fixed_seed(self):
        active = np.array([True, True])

        def schedule(seed):
            inj = ChaosInjector(seed=seed, bitflip_rate=0.4)
            out = []
            for i in range(20):
                state = self._state()
                flipped, slot = inj.maybe_bitflip(state, active, i, [0, 1])
                out.append((i, slot, flipped["remainder"][0].h.numpy().tobytes()))
            return out

        a, b = schedule(11), schedule(11)
        assert a == b
        assert any(slot is not None for _, slot, _ in a)
        # The reference's schedule for the same seed and calls.
        ref = JCH.ChaosInjector(seed=11, bitflip_rate=0.4)
        state_j = {"layer0": JRecState(h=jnp.ones((2, 4, 4)), conv=jnp.zeros((2, 2, 4)))}
        assert [ref.maybe_bitflip(state_j, active, i, [0, 1])[1] for i in range(20)] == [
            slot for _, slot, _ in a]

    def test_bitflip_slot_state_is_deterministic_and_local(self):
        s1, s2 = self._state(b=3), self._state(b=3)
        h0 = s1["remainder"][0].h.clone()
        bitflip_slot_state(s1, 1)
        bitflip_slot_state(s2, 1)
        h1, h2 = s1["remainder"][0].h, s2["remainder"][0].h
        assert torch.equal(h1, h2)
        # Other rows untouched; one low mantissa bit, so finite but wrong.
        assert torch.equal(h1[[0, 2]], h0[[0, 2]])
        assert not torch.equal(h1[1], h0[1])
        assert bool(torch.isfinite(h1).all())
        assert torch.equal(s1["remainder"][0].conv, torch.zeros(3, 2, 4))


class TestReplicaMonitor:
    """The escalation policy is deterministic and clock-free."""

    def test_fault_rate_degrades_then_heals(self):
        mon = H.ReplicaMonitor(window=4)
        assert mon.state == H.HEALTHY and mon.routable
        assert mon.observe(faults=1) == H.DEGRADED
        assert not mon.routable
        assert "fault rate" in mon.reason
        mon.observe()
        assert mon.observe() == H.HEALTHY
        assert mon.routable
        assert mon.transitions[-1] == (H.HEALTHY, "clean observation window")

    def test_consecutive_stragglers_degrade(self):
        mon = H.ReplicaMonitor(straggler_limit=3)
        assert mon.observe(straggler=True) == H.HEALTHY
        assert mon.observe(straggler=True) == H.HEALTHY
        assert mon.observe(straggler=True) == H.DEGRADED
        assert "stragglers" in mon.reason
        assert mon.observe() == H.HEALTHY

    def test_watchdog_timeout_ages_out_of_window(self):
        mon = H.ReplicaMonitor(window=3, dead_after_degraded=10)
        assert mon.observe(watchdog_timeout=True) == H.DEGRADED
        assert mon.observe() == H.DEGRADED
        assert mon.observe() == H.DEGRADED
        assert mon.observe() == H.HEALTHY

    def test_persistent_degradation_dies(self):
        mon = H.ReplicaMonitor(window=2, dead_after_degraded=3)
        assert mon.observe(faults=1) == H.DEGRADED
        assert mon.observe(faults=1) == H.DEGRADED
        assert mon.observe(faults=1) == H.DEAD
        assert "consecutive observations" in mon.reason
        assert mon.observe() == H.DEAD
        assert not mon.routable

    def test_mark_dead_is_idempotent_and_terminal(self):
        mon = H.ReplicaMonitor()
        mon.mark_dead("injected kill")
        mon.mark_dead("second call")
        assert mon.state == H.DEAD
        assert mon.reason == "injected kill"
        assert mon.transitions == [(H.DEAD, "injected kill")]
        assert mon.observe(faults=5) == H.DEAD

    def test_window_validation(self):
        with pytest.raises(ValueError):
            H.ReplicaMonitor(window=0)

    def test_concurrent_observation_no_torn_transitions(self):
        """Observers hammer ``observe()`` while readers race ``status()``:
        never a non-healthy state with an empty reason, never a heal after
        DEAD, and after ``mark_dead`` exactly (DEAD, its reason)."""
        mon = H.ReplicaMonitor(window=4, dead_after_degraded=10**9)
        stop = threading.Event()
        bad = []

        def reader():
            seen_dead = False
            while not stop.is_set():
                state, reason = mon.status()
                if state == H.DEAD:
                    seen_dead = True
                    if reason != "external death":
                        bad.append(("dead-with-wrong-reason", reason))
                elif seen_dead:
                    bad.append(("healed-after-dead", state))
                if state != H.HEALTHY and not reason:
                    bad.append(("state-without-reason", state))

        def observer(seed):
            rng = np.random.default_rng(seed)
            for _ in range(400):
                mon.observe(faults=int(rng.integers(0, 2)), straggler=bool(rng.integers(0, 2)))

        readers = [threading.Thread(target=reader) for _ in range(2)]
        observers = [threading.Thread(target=observer, args=(s,)) for s in range(3)]
        for t in readers + observers:
            t.start()
        for t in observers[:2]:
            t.join()
        mon.mark_dead("external death")
        observers[2].join()
        stop.set()
        for t in readers:
            t.join()
        assert bad == []
        assert mon.status() == (H.DEAD, "external death")
        assert mon.transitions[-1] == (H.DEAD, "external death")
        assert not mon.routable

    def test_transitions_equal_reference(self):
        """The same observation sequence walks the reference's monitor
        through the same transitions."""
        from repro.serve import health as JH

        rng = np.random.default_rng(5)
        obs = [dict(faults=int(rng.integers(0, 2)), straggler=bool(rng.random() < 0.4),
                    watchdog_timeout=bool(rng.random() < 0.05)) for _ in range(200)]
        mine = H.ReplicaMonitor(window=5, dead_after_degraded=12)
        ref = JH.ReplicaMonitor(window=5, dead_after_degraded=12)
        assert [mine.observe(**o) for o in obs] == [ref.observe(**o) for o in obs]
        assert mine.transitions == ref.transitions


class TestFleetDrainModel:
    """serve_fleet_drain: recovery-aware least-loaded placement against a
    depth-blind round-robin over survivors carrying recovery debt."""

    def test_aware_routes_around_recovery_debt(self):
        aware, blind = serve_fleet_drain([4, 4, 4, 4], [0, 8], window=4)
        assert (aware, blind) == (12, 16)

    def test_window_quantization(self):
        aware, blind = serve_fleet_drain([1], [0], window=4)
        assert aware == blind == 4

    def test_aware_never_worse_on_uniform_work(self):
        rng = np.random.default_rng(3)
        for _ in range(20):
            w = int(rng.integers(1, 12))
            work = [w] * int(rng.integers(1, 9))
            depths = rng.integers(0, 30, rng.integers(1, 4)).tolist()
            aware, blind = serve_fleet_drain(work, depths, window=4)
            assert aware <= blind
            assert (aware, blind) == JCM.serve_fleet_drain(work, depths, window=4)

    def test_validation(self):
        for args in (([4], []), ([4], [0], 0), ([0], [0]), ([4], [-1])):
            work, depths, *win = args
            with pytest.raises(ValueError):
                serve_fleet_drain(work, depths, window=win[0] if win else 4)
            with pytest.raises(ValueError):
                JCM.serve_fleet_drain(work, depths, window=win[0] if win else 4)


class TestWkvTrafficModel:
    """The WKV forward, backward and decode traffic functions, the last of
    the reference's cost model the port copies, equal the reference's."""

    @pytest.mark.parametrize("fn,args", [
        ("wkv_traffic", (2, 4, 256, 64, 16)),
        ("wkv_traffic", (1, 32, 100, 64)),
        ("wkv_bwd_traffic", (4, 32, 256, 64, 16)),
        ("wkv_bwd_traffic", (1, 2, 48, 32, 64, 2)),
        ("wkv_decode_traffic", (4, 32, 64)),
        ("wkv_decode_traffic", (1, 32, 64, 32, 2)),
    ])
    def test_equal_to_reference(self, fn, args):
        mine, ref = getattr(CM, fn)(*args), getattr(JCM, fn)(*args)
        assert [dataclasses.asdict(c) for c in mine] == [dataclasses.asdict(c) for c in ref]

    def test_decode_token_io_equal_to_reference(self):
        for args in ((4, 32, 64), (1, 32, 64, 8), (2, 4, 16, 3, 2)):
            assert CM.wkv_decode_token_io(*args) == JCM.wkv_decode_token_io(*args)


class TestReadSnapshotHost:
    """Handoff-source validation: no snapshot is None (a fresh re-run), a
    mismatched or corrupt one raises."""

    def _snapshot(self, tmp_path):
        eng = _engine("rwkv6-1.6b")
        reqs = _requests(eng.cfg.vocab_size, spec=SPEC[:3])
        outs = eng.serve(reqs, slots=2, snapshot_every=1, snapshot_dir=str(tmp_path),
                         recoverable=True)
        return outs, len(reqs)

    def test_no_snapshot_returns_none(self, tmp_path):
        assert read_snapshot_host(tmp_path, 5) is None

    def test_roundtrip_prefixes(self, tmp_path):
        outs, n = self._snapshot(tmp_path)
        snap = read_snapshot_host(tmp_path, n)
        assert snap is not None
        assert int(snap["meta"][3]) == n
        for i, o in enumerate(outs):
            got = snap["outputs"][i]
            np.testing.assert_array_equal(np.asarray(o)[: len(got)], np.asarray(got, np.int32),
                                          err_msg=f"snapshot output {i} is not a prefix")
            assert snap["outcomes"][i] in (None,) + OUTCOMES
        # The reference's reader takes the port's snapshot as it is.
        ref = JF.read_snapshot_host(tmp_path, n)
        assert ref["outputs"] == snap["outputs"] and ref["outcomes"] == snap["outcomes"]

    def test_rejects_wrong_request_count(self, tmp_path):
        _, n = self._snapshot(tmp_path)
        with pytest.raises(ValueError, match="refusing"):
            read_snapshot_host(tmp_path, n + 1)

    def _tamper(self, tmp_path, mutate):
        step = C.latest_step(tmp_path)
        npz = Path(tmp_path) / f"step_{step}" / "arrays.npz"
        with np.load(npz) as data:
            arrays = {k: data[k] for k in data.files}
        mutate(arrays)
        np.savez(npz, **arrays)

    def test_rejects_malformed_meta(self, tmp_path):
        _, n = self._snapshot(tmp_path)
        self._tamper(tmp_path, lambda a: a.update(meta=a["meta"][:5]))
        with pytest.raises(ValueError, match="shape"):
            read_snapshot_host(tmp_path, n)

    def test_rejects_missing_meta(self, tmp_path):
        _, n = self._snapshot(tmp_path)
        self._tamper(tmp_path, lambda a: a.pop("meta"))
        with pytest.raises(ValueError, match="meta"):
            read_snapshot_host(tmp_path, n)

    def test_rejects_inconsistent_offsets(self, tmp_path):
        _, n = self._snapshot(tmp_path)

        def bump(a):
            off = a["host/out_off"].copy()
            off[-1] += 1
            a["host/out_off"] = off

        self._tamper(tmp_path, bump)
        with pytest.raises(ValueError, match="inconsistent"):
            read_snapshot_host(tmp_path, n)


class TestFleetRouterValidation:
    def test_constructor_validation(self):
        eng = _engine("rwkv6-1.6b")
        reqs = _requests(eng.cfg.vocab_size, spec=SPEC[:2])
        with pytest.raises(ValueError, match="at least one"):
            FleetRouter([], reqs)
        with pytest.raises(ValueError, match="snapshot_root"):
            FleetRouter([eng], reqs, snapshot_every=1)
        with pytest.raises(ValueError, match="per engine"):
            FleetRouter([eng], reqs, chaos=[None, None])

    def test_shared_queue_shed_beyond_capacity(self, reference_runs):
        eng = _engine("rwkv6-1.6b")
        reqs = _requests(eng.cfg.vocab_size)
        fl = FleetRouter([eng], reqs, slots=2, max_queue=1)
        outs = fl.run()
        shed = [o for o in outs if o.outcome == "shed"]
        assert len(shed) == len(reqs) - 3
        assert fl.stats["shared_shed"] == len(shed)
        assert all(o.outcome in ("ok", "eos") for o in outs[:3])
        assert _summary(fl, outs) == reference_runs["shed"]

    def test_timeout_after_start_is_a_death(self, monkeypatch):
        """A StepTimeout raised after a dispatch began updating the state in
        place is not retried: in a fleet the replica dies and the
        survivors resume its requests from its last snapshot."""
        from repro_torch.ft.watchdog import StepTimeout

        vocab = _setup("rwkv6-1.6b")[1].vocab_size
        reqs = _requests(vocab)
        base = _engine("rwkv6-1.6b").serve(reqs, slots=2, recoverable=True)
        engines = [_engine("rwkv6-1.6b") for _ in range(2)]
        real = ServeSession._dispatch

        def dispatch(self, kind, fn):
            if self.eng is engines[0] and kind == "window" and self.stats[
                    "decode_dispatches"] == 1:
                raise StepTimeout("window dispatch timed out after it began")
            return real(self, kind, fn)

        monkeypatch.setattr(ServeSession, "_dispatch", dispatch)
        fl, outs = _run_fleet(engines, reqs)
        assert fl.stats["replica_deaths"] == 1 and fl.monitors[0].state == H.DEAD
        assert "StepTimeout" in fl.death_reasons[0]
        assert fl.stats["handoffs"] >= 1
        _assert_streams_equal(base, outs)


class TestLauncher:
    LANE_3E = ["--arch", "rwkv6-1.6b", "--smoke", "--continuous", "--replicas", "3",
               "--requests", "6", "--slots", "2", "--prompt-len", "10", "--new-tokens", "16",
               "--max-len", "96", "--decode-window", "4", "--snapshot-every", "1",
               "--checksum-every", "2", "--chaos-bitflip-at", "1",
               "--chaos-replica-kill-at", "3", "--device", "cpu"]

    def test_lane3e_fleet_drill_exits_zero(self, capsys):
        launcher.main(self.LANE_3E)
        out = capsys.readouterr().out
        assert "1 deaths" in out
        assert "fleet drill: every request completed on the survivors" in out

    def test_bitflip_without_checksums_exits_nonzero(self):
        args = [a for a in self.LANE_3E]
        i = args.index("--checksum-every")
        del args[i:i + 2]
        with pytest.raises(SystemExit, match="needs --checksum-every"):
            launcher.main(args)

    def test_single_engine_bitflip_is_detected(self, capsys):
        launcher.main(["--arch", "rwkv6-1.6b", "--smoke", "--continuous", "--device", "cpu",
                       "--requests", "4", "--slots", "2", "--prompt-len", "8",
                       "--new-tokens", "8", "--max-len", "64", "--decode-window", "2",
                       "--chaos-seed", "7", "--chaos-bitflip-at", "1", "--checksum-every", "2"])
        out = capsys.readouterr().out
        assert "'bitflip': 1" in out and "all faults recovered" in out

    def test_replica_flag_validation(self):
        with pytest.raises(SystemExit, match="--replicas must be"):
            launcher.main(["--arch", "rwkv6-1.6b", "--smoke", "--device", "cpu",
                           "--replicas", "0"])
        with pytest.raises(SystemExit, match="requires --continuous"):
            launcher.main(["--arch", "rwkv6-1.6b", "--smoke", "--device", "cpu",
                           "--replicas", "2"])
        with pytest.raises(SystemExit, match="needs --snapshot-every"):
            launcher.main(["--arch", "rwkv6-1.6b", "--smoke", "--continuous", "--device",
                           "cpu", "--replicas", "2", "--requests", "2",
                           "--chaos-replica-kill-at", "1"])
