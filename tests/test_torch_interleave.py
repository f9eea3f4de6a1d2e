"""The forced-interleaving drill in the port (``repro_torch.serve.interleave``),
on the CPU: a counterpart of every test of tests/test_interleave.py.
Schedule decisions are a pure function of (seed, tag, index), the
reference's decisions exactly; the instrumented lock behaves as a lock while
forcing preemption windows; ``installed()`` swaps the port's lock factory
and dispatch hook and restores them on every exit path, and every lock of
the watchdog, saver, dispatch gate and replica monitor goes through it; a
two-replica chaos drill on the reduced rwkv6 stays bit-identical under
forced schedules (the 8-schedule version is the port's lane 3f)."""

import threading

import numpy as np
import pytest
import torch

from repro.serve import interleave as JI
from repro_torch.checkpoint.checkpoint import AsyncSaver
from repro_torch.ft import watchdog as W
from repro_torch.serve import engine as E
from repro_torch.serve import health as H
from repro_torch.serve import interleave as I

# Tiny tensors: one intra-op thread, so parallel test workers do not
# oversubscribe the cores.
torch.set_num_threads(1)


class TestForcedSchedule:
    def test_decisions_are_seed_deterministic(self):
        a = I.ForcedSchedule(3).decisions("lock.acquire", 64)
        b = I.ForcedSchedule(3).decisions("lock.acquire", 64)
        assert a == b
        assert True in a and False in a

    def test_different_seeds_and_tags_differ(self):
        base = I.ForcedSchedule(3).decisions("lock.acquire", 64)
        assert I.ForcedSchedule(4).decisions("lock.acquire", 64) != base
        assert I.ForcedSchedule(3).decisions("lock.release", 64) != base

    @pytest.mark.parametrize("seed", [0, 3, 11])
    def test_decisions_equal_reference(self, seed):
        for tag in ("lock.acquire", "dispatch.pre.window"):
            assert (I.ForcedSchedule(seed, p_preempt=0.3).decisions(tag, 64)
                    == JI.ForcedSchedule(seed, p_preempt=0.3).decisions(tag, 64))

    def test_point_counts_and_preempts(self):
        sched = I.ForcedSchedule(0, p_preempt=1.0, max_sleep_s=0.0)
        for _ in range(5):
            sched.point("t")
        assert sched.counts["t"] == 5
        assert sched.preemptions == 5

    def test_inactive_schedule_is_free(self):
        sched = I.ForcedSchedule(0, p_preempt=1.0)
        sched.active = False
        sched.point("t")
        assert sched.counts["t"] == 0
        assert sched.preemptions == 0

    def test_decision_sequence_matches_point_behavior(self):
        """point() consumes exactly the decision stream decisions()
        predicts, the property the bit-identity drill leans on."""
        sched = I.ForcedSchedule(7, max_sleep_s=0.0)
        want = sched.decisions("x", 32)
        before = 0
        got = []
        for _ in range(32):
            sched.point("x")
            got.append(sched.preemptions > before)
            before = sched.preemptions
        assert got == want


class TestInstrumentedLock:
    def test_is_a_lock(self):
        sched = I.ForcedSchedule(0, max_sleep_s=0.0)
        lock = I.InstrumentedLock(sched)
        assert not lock.locked()
        with lock:
            assert lock.locked()
        assert not lock.locked()
        assert sched.counts["lock.acquire"] == 1
        assert sched.counts["lock.release"] == 1

    def test_mutual_exclusion_under_forcing(self):
        """A hammered counter stays exact: the wrapper forces windows around
        the critical section, never inside its atomicity."""
        sched = I.ForcedSchedule(1, p_preempt=0.3, max_sleep_s=1e-4)
        lock = I.InstrumentedLock(sched)
        state = {"n": 0}

        def work():
            for _ in range(50):
                with lock:
                    n = state["n"]
                    state["n"] = n + 1

        threads = [threading.Thread(target=work) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert state["n"] == 200
        assert sched.preemptions > 0


class TestInstalled:
    def test_hooks_swapped_and_restored(self):
        sched = I.ForcedSchedule(0, max_sleep_s=0.0)
        prev_hook = E.dispatch_hook
        with I.installed(sched):
            assert isinstance(W.make_lock(), I.InstrumentedLock)
            E.dispatch_hook("pre", "decode")
            # Every host-tier lock of the serving stack comes from the factory.
            for lock in (H.ReplicaMonitor()._lock, AsyncSaver()._lock,
                         W.StepWatchdog(1.0)._lock):
                assert isinstance(lock, I.InstrumentedLock)
        assert sched.counts["dispatch.pre.decode"] == 1
        assert type(W.make_lock()) is type(threading.Lock())
        assert E.dispatch_hook is prev_hook
        assert sched.active is False

    def test_restored_on_exception(self):
        sched = I.ForcedSchedule(0, max_sleep_s=0.0)
        with pytest.raises(RuntimeError):
            with I.installed(sched):
                raise RuntimeError("boom")
        assert type(W.make_lock()) is type(threading.Lock())
        assert E.dispatch_hook is None


class TestDrill:
    def test_two_schedule_chaos_drill_bit_identical(self):
        stats = I.run_drill("rwkv6-1.6b", seeds=range(2), device="cpu")
        assert stats["schedules"] == 2
        assert stats["preemptions"] > 0
        assert stats["points"] > stats["preemptions"]

    def test_divergence_raises(self, monkeypatch):
        """A drill that cannot fail witnesses nothing: poison the comparison
        and require the drill to notice."""
        monkeypatch.setattr(np, "array_equal", lambda a, b: False)
        with pytest.raises(RuntimeError, match="diverged"):
            I.run_drill("rwkv6-1.6b", seeds=range(1), device="cpu")

    def test_cli_on_the_cpu_exits_zero(self, capsys):
        assert I.main(["--arch", "rwkv6-1.6b", "--seeds", "1", "--device", "cpu"]) == 0
        assert "[interleave] OK: 1 schedules bit-identical" in capsys.readouterr().out


if __name__ == "__main__":
    raise SystemExit(pytest.main([__file__, "-v"]))
