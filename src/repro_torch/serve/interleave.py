"""Deterministic forced-preemption drill: the runtime witness for the
host-tier static audit (counterpart of ``repro.serve.interleave``).

The reference's ``analysis.hostsafety`` *claims*, statically, that the serving
stack's cross-thread state is safe: every shared write holds its lock,
abandoned watchdog/saver threads are fenced off by generations, loop
guards sample consistent epochs.  This module is the dynamic complement:
a seeded scheduler that forces an OS-level preemption window at exactly
the boundaries the audit reasons about — lock acquire/release and
dispatch pre/post — while a replica fleet serves a chaos workload
(pinned NaN + dispatch drop, watchdogged, snapshotting every window).
If any interleaving the static passes missed can corrupt a stream, a
forced schedule is how it shows up; the drill asserts every request's
tokens stay **bit-identical to a fault-free single-engine run** across
every schedule.

Determinism: each preemption decision is keyed by ``(seed, tag,
per-tag-index)``, not by global arrival order — so the decision sequence
at each boundary class is reproducible per seed even though threads
reach the boundaries in racy order.

Instrumentation hooks (both production no-ops):

* :func:`repro_torch.ft.watchdog.set_lock_factory` — every lock in the
  watchdog / checkpoint-saver / health-monitor / dispatch-gate stack
  comes from ``make_lock()``; the drill swaps in :class:`InstrumentedLock`.
* ``repro_torch.serve.engine.dispatch_hook`` — called around every
  fault-plumbed dispatch, inside the watchdog worker thread.

CLI (the port's lane 3f; ``--device cpu`` runs it on the CPU, the
default is the card)::

    python -m repro_torch.serve.interleave --arch rwkv6-1.6b --seeds 8
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import random
import shutil
import sys
import tempfile
import threading
import time

from repro_torch.ft import watchdog as W


class ForcedSchedule:
    """Seeded preemption forcing at instrumented boundaries.

    :meth:`point` is called at every boundary with a tag; the decision
    (preempt or not, and for how long) is a pure function of
    ``(seed, tag, index-of-this-tag)``.  A "preemption" is a short
    ``time.sleep`` — it releases the GIL, so any thread waiting at a
    racy boundary actually gets scheduled into the window.
    """

    def __init__(self, seed: int, p_preempt: float = 0.5,
                 max_sleep_s: float = 0.002):
        self.seed = int(seed)
        self.p_preempt = float(p_preempt)
        self.max_sleep_s = float(max_sleep_s)
        self.active = True
        self._state_lock = threading.Lock()   # raw: guards counters only
        self.counts: collections.Counter = collections.Counter()
        self.preemptions = 0

    def point(self, tag: str):
        """One boundary crossing; deterministically maybe-preempt."""
        if not self.active:
            return
        with self._state_lock:
            idx = self.counts[tag]
            self.counts[tag] += 1
        rng = random.Random(f"{self.seed}:{tag}:{idx}")
        if rng.random() < self.p_preempt:
            with self._state_lock:
                self.preemptions += 1
            time.sleep(rng.random() * self.max_sleep_s)
        else:
            time.sleep(0)   # still a switch point, just a zero-width one

    def decisions(self, tag: str, n: int) -> list[bool]:
        """The first ``n`` preempt/no-preempt decisions for ``tag`` —
        pure, for determinism tests; does not advance counters."""
        return [random.Random(f"{self.seed}:{tag}:{i}").random()
                < self.p_preempt for i in range(n)]


class InstrumentedLock:
    """A ``threading.Lock`` that routes acquire/release through a
    :class:`ForcedSchedule` — forcing contention windows right before a
    lock is taken, while it is held, and right before it is dropped."""

    def __init__(self, sched: ForcedSchedule):
        self._sched = sched
        # hostsafety: ok(lock wrapper internals; discipline is checked at
        # the call sites that use this object *as* the lock)
        self._real = threading.Lock()

    def acquire(self, *args, **kwargs):
        self._sched.point("lock.acquire")
        # hostsafety: ok(lock wrapper: this IS the with-block plumbing)
        got = self._real.acquire(*args, **kwargs)
        if got:
            self._sched.point("lock.held")
        return got

    def release(self):
        self._sched.point("lock.release")
        # hostsafety: ok(lock wrapper: this IS the with-block plumbing)
        self._real.release()

    def locked(self) -> bool:
        return self._real.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False


@contextlib.contextmanager
def installed(sched: ForcedSchedule):
    """Install ``sched`` at every instrumented boundary; restore the
    production hooks (and deactivate the schedule) on exit."""
    from repro_torch.serve import engine as E

    prev_factory = W.set_lock_factory(lambda: InstrumentedLock(sched))
    prev_hook = E.dispatch_hook
    E.dispatch_hook = lambda phase, kind: sched.point(
        f"dispatch.{phase}.{kind}")
    try:
        yield sched
    finally:
        W.set_lock_factory(prev_factory)
        E.dispatch_hook = prev_hook
        # Locks created under the drill outlive it; mute them so late
        # teardown (saver drains, session close) runs at full speed.
        sched.active = False


# -- the drill -------------------------------------------------------------

#: (prompt_len, max_new_tokens) per request — ragged on purpose, so slot
#: recycling and admission interleave with decode under forced schedules.
REQUEST_SPEC = ((5, 7), (11, 5), (7, 9), (3, 6), (9, 8))


def _build(arch: str, replicas: int, device=None):
    """``replicas`` engines of the reduced ``arch`` sharing one params tree
    (random weights from seed 0) on ``device`` (``None``: the card), and
    :data:`REQUEST_SPEC`'s requests."""
    import numpy as np

    from repro_torch.configs.registry import get_config
    from repro_torch.model import model as M
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = get_config(arch).reduced()
    params = M.init_params(cfg, seed=0, device=device)
    rng = np.random.default_rng(0)
    reqs = [Request(tokens=rng.integers(0, cfg.vocab_size, (pl,))
                    .astype(np.int32), max_new_tokens=nn)
            for pl, nn in REQUEST_SPEC]
    engines = [ServeEngine(cfg, params, max_len=96, decode_window=4,
                           device=device)
               for _ in range(replicas)]
    return engines, reqs


def run_drill(arch: str = "rwkv6-1.6b", *, seeds=range(8),
              replicas: int = 2, p_preempt: float = 0.5,
              max_sleep_ms: float = 2.0, device=None,
              log=lambda msg: None) -> dict:
    """Serve the chaos workload under every forced schedule; assert
    stream bit-identity against the fault-free single-engine baseline.

    Raises ``RuntimeError`` on any divergence (or on a schedule that
    never actually preempted — a drill that forces nothing witnesses
    nothing).  Returns summary stats.
    """
    import numpy as np

    from repro_torch.serve.chaos import ChaosInjector
    from repro_torch.serve.fleet import FleetRouter

    engines, reqs = _build(arch, replicas, device)
    # recoverable=True: the fleet sessions size their rings for recovery,
    # and bit-identity only holds against a baseline sized the same way.
    base = engines[0].serve(reqs, slots=2, seed=0, recoverable=True)
    base_tokens = [np.asarray(r.tokens) for r in base]
    log(f"baseline: {sum(t.size for t in base_tokens)} tokens over "
        f"{len(reqs)} requests")

    stats = {"schedules": 0, "preemptions": 0, "points": 0}
    for seed in seeds:
        sched = ForcedSchedule(seed, p_preempt=p_preempt,
                               max_sleep_s=max_sleep_ms / 1e3)
        root = tempfile.mkdtemp(prefix=f"interleave_s{seed}_")
        try:
            with installed(sched):
                chaos = [ChaosInjector(seed=7, nan_at=(1,), drop_at=(3,)),
                         None][:replicas]
                fl = FleetRouter(
                    engines, reqs, slots=2, seed=0,
                    watchdog_timeout_s=30.0, snapshot_every=1,
                    snapshot_root=root, checksum_every=2, chaos=chaos)
                outs = fl.run()
        finally:
            shutil.rmtree(root, ignore_errors=True)
        bad = [o.outcome for o in outs
               if o.outcome not in ("ok", "eos", "recovered")]
        if bad:
            raise RuntimeError(
                f"schedule {seed}: unexpected outcomes {bad}")
        for ri, (b, o) in enumerate(zip(base_tokens, outs)):
            got = np.asarray(o.tokens)
            if not np.array_equal(b, got):
                raise RuntimeError(
                    f"schedule {seed}: request {ri} diverged from the "
                    f"fault-free baseline under forced preemption "
                    f"(want {b.tolist()}, got {got.tolist()})")
        n_pts = sum(sched.counts.values())
        if sched.preemptions == 0 or sched.counts["lock.acquire"] == 0:
            raise RuntimeError(
                f"schedule {seed} forced no preemptions "
                f"({dict(sched.counts)}) — the drill witnessed nothing")
        stats["schedules"] += 1
        stats["preemptions"] += sched.preemptions
        stats["points"] += n_pts
        log(f"schedule {seed}: bit-identical "
            f"({sched.preemptions}/{n_pts} boundaries preempted, "
            f"faults quarantined: "
            f"{sum(1 for o in outs if o.outcome == 'recovered')} "
            f"recovered)")
    return stats


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.serve.interleave")
    ap.add_argument("--arch", default="rwkv6-1.6b")
    ap.add_argument("--seeds", type=int, default=8,
                    help="number of forced schedules (seeds 0..N-1)")
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--p-preempt", type=float, default=0.5)
    ap.add_argument("--max-sleep-ms", type=float, default=2.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    try:
        stats = run_drill(
            args.arch, seeds=range(args.seeds), replicas=args.replicas,
            p_preempt=args.p_preempt, max_sleep_ms=args.max_sleep_ms,
            device=args.device, log=lambda msg: print(f"[interleave] {msg}"))
    except RuntimeError as e:
        print(f"[interleave] FAIL: {e}", file=sys.stderr)
        return 1
    print(f"[interleave] OK: {stats['schedules']} schedules bit-identical "
          f"({stats['preemptions']} forced preemptions over "
          f"{stats['points']} boundaries)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
