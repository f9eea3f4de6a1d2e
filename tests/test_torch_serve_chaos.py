"""Fault isolation in the port's serve engine, on the CPU: a counterpart of
every test of tests/test_serve_chaos.py (injected NaN, dropped dispatch,
hang, request drop and preemption, each confining its blast radius to one
slot; snapshot and restore; deadlines and shedding; the watchdog's fence
and the straggler warmup; the injector's schedule), on the reduced configs
with the reference's parameters converted.

The quarantine drills are also held against the reference's own run of
the same drill: the same injections, the same counters, the same greedy
streams.  Sampled streams use the port's own draw, so they are held to
the port's fault-free run only.
"""

import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.model import model as JM
from repro.serve import chaos as JCH
from repro.serve import engine as JE
from repro_torch.checkpoint.checkpoint import AsyncSaver
from repro_torch.configs.registry import get_config
from repro_torch.ft.watchdog import StepTimeout, StepWatchdog, StragglerDetector
from repro_torch.launch import serve as launcher
from repro_torch.model import convert
from repro_torch.model import model as M
from repro_torch.serve import chaos as CH
from repro_torch.serve import engine as E
from repro_torch.serve.chaos import ChaosInjector, EnginePreempted
from repro_torch.serve.engine import Request, ServeEngine, ServeSession

jax.config.update("jax_platform_name", "cpu")
# Tiny tensors: one intra-op thread, so parallel test workers do not
# oversubscribe the cores.
torch.set_num_threads(1)

ARCHS = ["rwkv6-1.6b", "gemma3-1b", "recurrentgemma-2b"]
SPEC = [(5, 9), (12, 3), (7, 14), (3, 6), (9, 11)]
_SETUPS = {}


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


def _engine(arch, **kw):
    _, cfg, _, pt = _setup(arch)
    return ServeEngine(cfg, pt, max_len=96, decode_window=4, device="cpu", **kw)


def _assert_streams_equal(base, outs):
    for i, (b, o) in enumerate(zip(base, outs)):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(o),
                                      err_msg=f"request {i} diverged from fault-free run")


def _reference_serve(arch, reqs, chaos=None, **kw):
    cfg_j, _, pj, _ = _setup(arch)
    eng = JE.ServeEngine(cfg_j, pj, max_len=96, decode_window=4)
    outs = eng.serve([JE.Request(tokens=r.tokens, max_new_tokens=r.max_new_tokens)
                      for r in reqs], chaos=chaos, **kw)
    return outs, eng.last_serve_stats


class TestQuarantineRecovery:
    """NaN in the state: quarantined inside the window, recovered by
    re-prefill, every stream (the victim's too) bit-identical to the
    fault-free run, and the drill the reference's own."""

    @pytest.mark.parametrize("arch", ARCHS)
    def test_nan_poison_recovers_bit_identical(self, arch):
        reqs = _requests(_setup(arch)[1].vocab_size)
        eng = _engine(arch)
        base = eng.serve(reqs, slots=3, seed=0)
        assert all(r.outcome in ("ok", "eos") for r in base)

        chaos = ChaosInjector(seed=1, nan_at=(2,))
        outs = eng.serve(reqs, slots=3, seed=0, chaos=chaos)
        assert chaos.counters["nan"] == 1
        stats = eng.last_serve_stats
        assert stats["quarantines"] == 1 and stats["recoveries"] == 1
        victims = [r for r in outs if r.recoveries > 0]
        assert len(victims) == 1 and victims[0].outcome == "recovered"
        _assert_streams_equal(base, outs)

        # The reference's run of the same drill: same faults, same
        # counters, same streams and outcomes.
        ref_chaos = JCH.ChaosInjector(seed=1, nan_at=(2,))
        ref, ref_stats = _reference_serve(arch, reqs, slots=3, seed=0, chaos=ref_chaos)
        assert chaos.events == ref_chaos.events
        # Every counter but the straggler flags, which read the host clock.
        assert ({k: v for k, v in stats.items() if k != "stragglers"}
                == {k: v for k, v in ref_stats.items() if k != "stragglers"})
        assert [(r.outcome, r.recoveries) for r in outs] == [
            (r.outcome, r.recoveries) for r in ref]
        _assert_streams_equal(ref, outs)

    def test_two_faults_same_request_allowed(self):
        reqs = _requests(_setup(ARCHS[0])[1].vocab_size)
        eng = _engine(ARCHS[0])
        base = eng.serve(reqs, slots=3, seed=0)
        chaos = ChaosInjector(seed=3, nan_at=(1, 3))
        outs = eng.serve(reqs, slots=3, seed=0, chaos=chaos)
        assert eng.last_serve_stats["quarantines"] == 2
        assert sum(r.recoveries for r in outs) == 2
        _assert_streams_equal(base, outs)

    def test_poison_rate_schedule_equals_reference(self):
        """A rate-driven drill (one draw per window, then a slot choice)
        replays the reference's schedule draw for draw."""
        arch = ARCHS[0]
        reqs = _requests(_setup(arch)[1].vocab_size)
        chaos = ChaosInjector(seed=3, nan_rate=0.5)
        outs = _engine(arch).serve(reqs, slots=3, chaos=chaos)
        ref_chaos = JCH.ChaosInjector(seed=3, nan_rate=0.5)
        ref, _ = _reference_serve(arch, reqs, slots=3, chaos=ref_chaos)
        assert chaos.events == ref_chaos.events and chaos.counters["nan"] >= 5
        _assert_streams_equal(ref, outs)


class TestDispatchFaults:
    """Dropped and hung dispatches: retried (a hang through the watchdog's
    fence), with no effect on any stream: the injection fires before the
    dispatch starts updating the state in place."""

    def test_drop_and_hang_retry_bit_identical(self):
        reqs = _requests(_setup(ARCHS[0])[1].vocab_size)
        eng = _engine(ARCHS[0])
        base = eng.serve(reqs, slots=3, seed=0)

        chaos = ChaosInjector(seed=1, hang_at=(1,), drop_at=(3,), hang_poll_s=0.001)
        # A real window under a loaded test run stays well inside 1 s.
        outs = eng.serve(reqs, slots=3, seed=0, chaos=chaos, watchdog_timeout_s=1.0)
        stats = eng.last_serve_stats
        assert stats["watchdog_timeouts"] == 1
        assert stats["dispatch_drops"] == 1
        assert stats["dispatch_retries"] == 2
        assert all(r.outcome in ("ok", "eos") for r in outs)
        _assert_streams_equal(base, outs)

    def test_retry_budget_exhaustion_raises(self):
        reqs = _requests(_setup(ARCHS[0])[1].vocab_size, [(5, 4)])
        eng = _engine(ARCHS[0])
        chaos = ChaosInjector(seed=1, drop_rate=1.0)
        with pytest.raises(RuntimeError, match="after .* retries"):
            eng.serve(reqs, slots=1, seed=0, chaos=chaos,
                      max_dispatch_retries=2, retry_backoff_s=0.001)
        assert eng.last_serve_stats["dispatch_retries"] == 3

    def _dispatch(self, eng, fn, watchdog, stats):
        return eng._dispatch("window", fn, chaos=None, watchdog=watchdog, straggler=None,
                             stats=stats, max_retries=3, backoff_s=0.001, index=0)

    def test_timeout_after_start_is_not_retried(self):
        """A dispatch that times out after it started (it may have updated
        the state in place) raises at once and never runs again."""
        eng, release = _engine(ARCHS[0]), threading.Event()
        calls, stats = [], dict.fromkeys(E.SERVE_STAT_KEYS, 0)

        def slow():
            calls.append(threading.current_thread())
            release.wait(2.0)
            return "late"

        with pytest.raises(StepTimeout, match="resume from a snapshot"):
            self._dispatch(eng, slow, StepWatchdog(0.05), stats)
        release.set()
        assert len(calls) == 1
        assert (stats["watchdog_timeouts"], stats["dispatch_retries"]) == (1, 0)

    def test_worker_runs_in_inference_mode_with_hooks(self, monkeypatch):
        """The watched call runs in a worker thread that enters inference
        mode (it is per thread) and calls the dispatch hook around ``fn``."""
        seen = []
        monkeypatch.setattr(E, "dispatch_hook", lambda phase, kind: seen.append((phase, kind)))
        eng, stats = _engine(ARCHS[0]), dict.fromkeys(E.SERVE_STAT_KEYS, 0)

        def fn():
            seen.append((threading.current_thread() is threading.main_thread(),
                         torch.is_inference_mode_enabled()))
            return 7

        assert self._dispatch(eng, fn, StepWatchdog(5.0), stats) == 7
        assert seen == [("pre", "window"), (False, True), ("post", "window")]


class TestSnapshotRestore:
    """Preempt mid-serve, restore from the snapshot, finish with streams
    bit-identical to the uninterrupted run: the sampling noise is a
    function of (seed, request, token index), so no RNG state is saved."""

    def test_preempt_restore_bit_identical(self, tmp_path):
        reqs = _requests(_setup(ARCHS[0])[1].vocab_size)
        eng = _engine(ARCHS[0])
        base = eng.serve(reqs, slots=3, seed=0, temperature=0.8, top_k=5)

        chaos = ChaosInjector(seed=1, preempt_after=2)
        with pytest.raises(EnginePreempted):
            eng.serve(reqs, slots=3, seed=0, temperature=0.8, top_k=5,
                      snapshot_every=1, snapshot_dir=str(tmp_path), chaos=chaos)
        interrupted = eng.last_serve_stats
        assert interrupted["snapshots"] >= 1

        outs = eng.serve(reqs, slots=3, seed=0, temperature=0.8, top_k=5,
                         restore_from=str(tmp_path))
        resumed = eng.last_serve_stats
        # The restored run continues the counters, not restarts them.
        assert resumed["decode_dispatches"] > interrupted["decode_dispatches"]
        _assert_streams_equal(base, outs)

    def test_restore_rejects_mismatched_serve(self, tmp_path):
        reqs = _requests(_setup(ARCHS[0])[1].vocab_size)
        eng = _engine(ARCHS[0])
        with pytest.raises(EnginePreempted):
            eng.serve(reqs, slots=3, seed=0, snapshot_every=1, snapshot_dir=str(tmp_path),
                      chaos=ChaosInjector(preempt_after=1))
        with pytest.raises(ValueError, match="snapshot meta"):
            eng.serve(reqs, slots=3, seed=7, restore_from=str(tmp_path))
        with pytest.raises(FileNotFoundError):
            eng.serve(reqs, slots=3, seed=0, restore_from=str(tmp_path / "none"))

    def test_stepped_session_with_async_saver(self, tmp_path):
        """A session stepped by hand, snapshotting through an AsyncSaver
        after a NaN recovery, equals ``serve``; a serve restored from its
        mid-run snapshot finishes with the same streams and outcomes."""
        arch = ARCHS[2]
        reqs = _requests(_setup(arch)[1].vocab_size)
        eng = _engine(arch)
        base = eng.serve(reqs, slots=3, recoverable=True)
        sess = ServeSession(eng, reqs, slots=3, snapshot_every=3,
                            snapshot_dir=str(tmp_path), saver=AsyncSaver(),
                            chaos=ChaosInjector(seed=1, nan_at=(1,)))
        steps = 0
        while sess.busy:
            sess.step()
            steps += 1
            assert sess.queue_depth() == len(sess.pending) + len(sess.recover_q) + int(
                sess.active_np.sum())
        sess.close()
        outs = sess.results()
        assert steps == sess.stats["decode_dispatches"] >= 3
        assert sorted(sess.drain_done()) == list(range(len(reqs))) and not sess.drain_done()
        _assert_streams_equal(base, outs)
        restored = eng.serve(reqs, slots=3, restore_from=str(tmp_path))
        assert [r.outcome for r in restored] == [r.outcome for r in outs]
        _assert_streams_equal(base, restored)


class TestRequestLifecycle:
    """Typed outcomes for the exits that are not faults: deadline kills,
    queue shedding, chaos request drops, none disturbing a neighbour."""

    def test_deadline_kills_only_the_expired_request(self):
        reqs = _requests(_setup(ARCHS[0])[1].vocab_size)
        reqs[0] = Request(tokens=reqs[0].tokens, max_new_tokens=reqs[0].max_new_tokens,
                          deadline_ms=0.0)
        eng = _engine(ARCHS[0])
        outs = eng.serve(reqs, slots=3, seed=0)
        assert outs[0].outcome == "deadline"
        assert eng.last_serve_stats["deadline_hits"] == 1
        assert all(r.outcome in ("ok", "eos") for r in outs[1:])

    def test_serve_wide_deadline_in_flight_on_a_fake_clock(self):
        """A serve-wide deadline, read on the session's clock: a request
        admitted before it passes is killed in flight, its neighbours'
        finished streams untouched; the queue's expire unadmitted."""
        reqs = _requests(_setup(ARCHS[0])[1].vocab_size)
        eng = _engine(ARCHS[0])
        base = eng.serve(reqs, slots=3)
        now = [0.0]
        sess = ServeSession(eng, reqs, slots=3, deadline_ms=1000.0, clock=lambda: now[0])
        sess.step()
        sess.step()
        now[0] = 2.0
        while sess.busy:
            sess.step()
        sess.close()
        outs = sess.results()
        killed = [i for i, r in enumerate(outs) if r.outcome == "deadline"]
        assert killed and sess.stats["deadline_hits"] == len(killed)
        for i, (b, o) in enumerate(zip(base, outs)):
            if i in killed:
                assert np.array_equal(np.asarray(o), np.asarray(b)[: o.size])
            else:
                assert np.array_equal(np.asarray(o), np.asarray(b))

    def test_bounded_queue_sheds_latest_arrivals(self):
        reqs = _requests(_setup(ARCHS[0])[1].vocab_size)
        eng = _engine(ARCHS[0])
        base = eng.serve(reqs[:3], slots=2, seed=0)
        outs = eng.serve(reqs, slots=2, seed=0, max_queue=1)
        # Capacity = 2 slots + 1 queued: requests 3 and 4 are shed.
        assert [r.outcome for r in outs[3:]] == ["shed", "shed"]
        assert all(len(r) == 0 for r in outs[3:])
        assert eng.last_serve_stats["shed"] == 2
        _assert_streams_equal(base, outs[:3])

    def test_chaos_request_drop_frees_slot(self):
        reqs = _requests(_setup(ARCHS[0])[1].vocab_size)
        eng = _engine(ARCHS[0])
        base = eng.serve(reqs, slots=2, seed=0)
        chaos = ChaosInjector(seed=2, req_drop_at=(2,))
        outs = eng.serve(reqs, slots=2, seed=0, chaos=chaos)
        dropped = [i for i, r in enumerate(outs) if r.outcome == "dropped"]
        assert len(dropped) == 1
        assert eng.last_serve_stats["req_drops"] == 1
        for i, (b, o) in enumerate(zip(base, outs)):
            if i not in dropped:
                np.testing.assert_array_equal(np.asarray(b), np.asarray(o))

    def test_corrupted_slot_requeues_then_ends_corrupt(self):
        """``_corrupted`` (the checksum chain's quarantine): rolls back the
        unverified tokens and requeues the request, until corruption
        recurs past MAX_CORRUPTION_RECOVERIES."""
        reqs = _requests(_setup(ARCHS[0])[1].vocab_size)
        sess = ServeSession(_engine(ARCHS[0]), reqs, slots=3)
        sess.step()
        ri = sess.slot_req[0]
        n = len(sess.outputs[ri])
        sess._corrupted(0, rollback=2)
        assert len(sess.outputs[ri]) == n - 2 and sess.slot_req[0] == -1
        assert list(sess.recover_q) == [ri] and sess.recoveries[ri] == 1
        assert sess.recovery_debt_steps() == reqs[ri].tokens.size + n - 2
        for _ in range(E.MAX_CORRUPTION_RECOVERIES):
            sess.slot_req[0] = ri
            sess._corrupted(0, rollback=0)
        assert sess.outcomes[ri] == "corrupt"
        assert sess.stats["corruptions"] == E.MAX_CORRUPTION_RECOVERIES + 1
        with pytest.raises(ValueError, match="already terminal"):
            sess.enqueue(ri)


class TestWatchdogFence:
    """A hung step's stale thread must not race the restart."""

    def test_stale_result_discarded(self):
        wd = StepWatchdog(timeout_s=0.05)
        release = threading.Event()

        def slow():
            release.wait(2.0)
            return "stale"

        with pytest.raises(StepTimeout):
            wd.run(slow)
        assert wd.timeouts == 1
        # The retried step wins; the abandoned thread's result is fenced.
        assert wd.run(lambda: "fresh") == "fresh"
        release.set()
        deadline = time.monotonic() + 2.0
        while wd.stale_discarded == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert wd.stale_discarded == 1

    def test_cancelled_flips_for_abandoned_step(self):
        wd = StepWatchdog(timeout_s=0.05)
        seen = {}

        def slow():
            fence = wd.cancelled
            deadline = time.monotonic() + 2.0
            while not fence() and time.monotonic() < deadline:
                time.sleep(0.005)
            seen["cancelled"] = fence()

        with pytest.raises(StepTimeout):
            wd.run(slow)
        deadline = time.monotonic() + 2.0
        while "cancelled" not in seen and time.monotonic() < deadline:
            time.sleep(0.01)
        assert seen.get("cancelled") is True

    def test_stale_exception_not_raised_into_restart(self):
        wd = StepWatchdog(timeout_s=0.05)

        def slow_then_boom():
            time.sleep(0.2)
            raise RuntimeError("stale boom")

        with pytest.raises(StepTimeout):
            wd.run(slow_then_boom)
        # A fresh run must not see the abandoned step's exception.
        assert wd.run(lambda: 42) == 42


class TestStragglerWarmup:
    """The first (warm-up) observation must not seed the EWMA baseline."""

    def test_compile_step_skipped(self):
        det = StragglerDetector(threshold=2.0, warmup=1)
        assert det.observe(100.0) is False       # warm-up: discarded
        assert det.observe(1.0) is False         # seeds the baseline
        assert det.baseline_s == 1.0
        assert det.observe(1.1) is False
        assert det.observe(5.0) is True          # real straggler
        assert det.flagged == 1

    def test_reset_reenters_warmup(self):
        det = StragglerDetector(threshold=2.0, warmup=1)
        det.observe(100.0)
        det.observe(1.0)
        det.reset()
        assert det.baseline_s is None
        assert det.observe(50.0) is False
        assert det.observe(1.0) is False
        assert det.baseline_s == 1.0


class TestChaosInjector:
    def test_pinned_faults_fire_exactly_once(self):
        chaos = ChaosInjector(seed=0, drop_at=(5,))
        # A retried dispatch keeps its index: the pin must not re-fire.
        assert chaos._hit("drop", 5, 0.0) is True
        assert chaos._hit("drop", 5, 0.0) is False
        assert chaos._hit("drop", 6, 0.0) is False

    def test_fixed_seed_replays_schedule(self):
        a = ChaosInjector(seed=9, drop_rate=0.3)
        b = ChaosInjector(seed=9, drop_rate=0.3)
        draws_a = [a._hit("drop", i, a.drop_rate) for i in range(32)]
        draws_b = [b._hit("drop", i, b.drop_rate) for i in range(32)]
        assert draws_a == draws_b and any(draws_a)

    def test_schedule_equals_reference(self):
        """Every injection site against the reference's injector, same seed
        and same calls: identical events, counters and chosen slots."""
        kw = dict(seed=4, nan_rate=0.4, bitflip_rate=0.2, req_drop_rate=0.3,
                  drop_at=(3,), preempt_after=30)
        ours, ref = ChaosInjector(**kw), JCH.ChaosInjector(**kw)
        active = np.array([True, False, True, True])
        slot_req = [7, -1, 8, 9]
        for i in range(24):
            got = [inj.maybe_drop_request(active, i, slot_req) for inj in (ours, ref)]
            assert got[0] == got[1]
            for inj in (ours, ref):
                try:
                    inj.before_dispatch("window", i)
                except (CH.DispatchDropped, JCH.DispatchDropped):
                    pass
        assert ours.events == ref.events and ours.counters == ref.counters
        assert ours.counters["drop"] == 1 and ours.counters["req_drop"] > 0

    @pytest.mark.parametrize("arch", ARCHS)
    @pytest.mark.parametrize("fault", ["poison", "bitflip"])
    def test_state_faults_equal_reference(self, arch, fault):
        """The poison (an ``h`` row, or for Gemma3 a K row at position 0)
        and the bit flip hit the elements the reference's do, in slot 1
        only."""
        cfg_j, cfg, _, _ = _setup(arch)
        rng = np.random.default_rng(0)
        st = M.init_decode_state(cfg, 3, 96, device="cpu")
        for node in M.state_nodes(st):
            for leaf in node:
                if leaf.dtype.is_floating_point:
                    leaf.copy_(torch.from_numpy(rng.standard_normal(tuple(leaf.shape))))
        leaves = [np.asarray(a) for a in jax.tree.leaves(convert.state_to_jax_numpy(st))]
        treedef = jax.tree.structure(JM.init_decode_state(cfg_j, 3, 96))
        st_j = jax.tree.unflatten(treedef, [jax.numpy.asarray(a) for a in leaves])
        want = getattr(JCH, f"{fault}_slot_state")(st_j, 1)
        assert getattr(CH, f"{fault}_slot_state")(st, 1) is st        # in place
        got = [np.asarray(a) for a in jax.tree.leaves(convert.state_to_jax_numpy(st))]
        changed = 0
        for g, w, before in zip(got, jax.tree.leaves(want), leaves):
            np.testing.assert_array_equal(g.view(np.uint8), np.asarray(w).view(np.uint8))
            diff = g.view(np.uint8) != before.view(np.uint8)
            if diff.any():
                changed += 1
                b_ax = 1                     # stacked (L, B, ...) leaves
                assert diff.any(axis=tuple(a for a in range(diff.ndim) if a != b_ax)
                                ).tolist() == [False, True, False]
        assert changed >= 1
        assert M.decode_state_finite(st).tolist() == (
            [True, True, True] if fault == "bitflip" or arch == "gemma3-1b"
            else [True, False, True])


class TestLauncher:
    def test_lane3c_chaos_drill_on_cpu_exits_zero(self, capsys):
        """Tier-1 lane 3c's flags through the port's launcher: a pinned NaN
        and a pinned drop, every fault recovered and every stream equal to
        the fault-free run, or the launcher exits nonzero."""
        launcher.main(["--arch", "rwkv6-1.6b", "--smoke", "--continuous", "--device", "cpu",
                       "--requests", "6", "--slots", "2", "--prompt-len", "8",
                       "--new-tokens", "6", "--max-len", "64", "--decode-window", "2",
                       "--chaos-seed", "7", "--chaos-nan-at", "2", "--chaos-drop-at", "4",
                       "--watchdog-timeout", "30"])
        out = capsys.readouterr().out
        assert "chaos drill: all faults recovered" in out

    def test_snapshot_and_restore_flags(self, tmp_path, capsys):
        args = ["--arch", "gemma3-1b", "--smoke", "--continuous", "--device", "cpu",
                "--requests", "4", "--slots", "2", "--prompt-len", "8", "--new-tokens", "6",
                "--max-len", "64", "--decode-window", "2", "--snapshot-every", "1",
                "--snapshot-dir", str(tmp_path)]
        launcher.main(args)
        first = capsys.readouterr().out
        launcher.main(args[:-4] + ["--restore-from", str(tmp_path)])
        again = capsys.readouterr().out
        pick = [ln for ln in first.splitlines() if ln.startswith("first request tokens")]
        assert pick and pick == [ln for ln in again.splitlines()
                                 if ln.startswith("first request tokens")]

    def test_unrecovered_drill_exits_nonzero(self):
        with pytest.raises(SystemExit, match="injected no faults"):
            launcher.main(["--arch", "rwkv6-1.6b", "--smoke", "--continuous", "--device",
                           "cpu", "--requests", "2", "--slots", "2", "--prompt-len", "4",
                           "--new-tokens", "2", "--max-len", "32", "--chaos-seed", "1"])
