"""Fault tolerance: step watchdog, restart loop, straggler detection
(the port's own copy of ``repro.ft.watchdog``, which is pure Python; the
port imports nothing of the reference package).

At thousand-node scale the failure model is: (a) hard node loss — the job
must restart from the last checkpoint on a (possibly smaller) mesh;
(b) hangs — a collective never completes because one participant stalled;
(c) stragglers — a slow node stretches every synchronous step.

This module implements the *host-side* machinery, which is identical at
container scale and cluster scale:

  * :class:`StepWatchdog` — wall-clock deadline per step; a stuck step
    raises :class:`StepTimeout` in the training loop, which triggers
    restart-from-checkpoint (the standard TPU preemption pattern).
  * :func:`run_with_restarts` — the outer resilience loop: run -> on
    failure restore latest checkpoint -> resume at the checkpointed step
    (the stateless data pipeline re-keys itself by step, so no data is
    skipped or repeated).
  * :class:`StragglerDetector` — EWMA of step times; flags steps slower
    than ``threshold×`` the moving median so the scheduler can evict/
    replace the slow host.  Mitigation at the collective level comes from
    gradient compression (fewer bytes on the slow link) and the point-to-
    point elevator collectives (a straggler delays only its neighbors'
    edges, not a global barrier — the paper's barrier-free argument at
    cluster scale).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable


_lock_factory: Callable[[], Any] = threading.Lock


def make_lock():
    """Construct a mutex for host-tier shared state.

    Every lock in the ft/checkpoint/serve stack comes from here so the
    deterministic interleaving drill (:mod:`repro_torch.serve.interleave`)
    can swap in instrumented locks that force a preemption window at every
    acquire/release.
    """
    return _lock_factory()


def set_lock_factory(factory: Callable[[], Any] | None):
    """Install (or, with ``None``, reset) the lock constructor used by
    :func:`make_lock`.  Returns the previous factory so callers can
    restore it."""
    global _lock_factory
    prev = _lock_factory
    _lock_factory = threading.Lock if factory is None else factory
    return prev


class StepTimeout(RuntimeError):
    pass


class NodeFailure(RuntimeError):
    """Raised by failure-injection hooks in tests / chaos drills."""


class StepWatchdog:
    """Deadline enforcement for (potentially hanging) steps.

    A Python thread cannot be killed, so a timed-out step's worker keeps
    running after :class:`StepTimeout` is raised — and with donated device
    buffers in flight, an abandoned step that later completes would race
    the restarted one.  Every ``run`` therefore opens a new *generation*:
    on timeout the generation is fenced off, the stale thread's eventual
    result or exception is discarded (``stale_discarded`` counts them),
    and the stale thread can notice it was abandoned via
    :attr:`cancelled` — a callable the watched ``fn`` may poll at safe
    points (e.g. *before* consuming donated buffers) to bail out
    cooperatively instead of mutating state the restarted step now owns.
    """

    def __init__(self, timeout_s: float):
        self.timeout_s = timeout_s
        self._gen = 0
        self._lock = make_lock()
        self.stale_discarded = 0
        self.timeouts = 0
        # Heartbeat: every completed run() bumps ``beats`` and stamps
        # ``last_beat`` — the liveness signal a replica health monitor
        # reads (a replica whose watchdog stops beating while its queue
        # is non-empty is wedged, not idle).
        self.beats = 0
        self.last_beat: float | None = None
        # Re-bound at each run(); True once that run has been abandoned.
        self.cancelled: Callable[[], bool] = lambda: False

    def run(self, fn: Callable[[], Any]) -> Any:
        with self._lock:
            self._gen += 1
            gen = self._gen
            # Published under the lock: a previous generation's worker
            # polling the *old* closure still compares against the bumped
            # ``_gen``, and sees the rebind or the bump, never neither.
            self.cancelled = lambda: gen != self._gen
        outcome: list[tuple[bool, Any]] = []

        def target():
            try:
                value = fn()
                ok = True
            except BaseException as e:  # noqa: BLE001 — propagated below
                value, ok = e, False
            with self._lock:
                if gen != self._gen:        # fenced: step was abandoned
                    self.stale_discarded += 1
                    return
                outcome.append((ok, value))

        t = threading.Thread(target=target, daemon=True)
        t.start()
        t.join(self.timeout_s)
        with self._lock:
            if not outcome:
                # Hung: advance the generation *under the lock*, so a
                # worker racing to finish right now either already
                # appended (seen below) or sees the fence and discards.
                self._gen += 1
                self.timeouts += 1
                hung = True
            else:
                hung = False
        if hung:
            raise StepTimeout(
                f"step exceeded {self.timeout_s}s (hung collective?)"
            )
        ok, value = outcome[0]
        if not ok:
            raise value
        self.beats += 1
        self.last_beat = time.monotonic()
        return value


@dataclasses.dataclass
class StragglerDetector:
    """EWMA straggler flagging.

    ``warmup`` observations are discarded before the baseline seeds: the
    first step of any jitted loop includes compile time, and folding it
    into the EWMA poisons the baseline (a 100× compile step makes every
    real step look fast forever — or, after a restart re-traces, makes
    the first real step look like a straggler).  :meth:`reset` drops the
    baseline so a restarted run re-warms instead of comparing against a
    dead configuration's step times.
    """

    threshold: float = 2.0
    alpha: float = 0.1
    warmup: int = 1
    _ewma: float | None = None
    _seen: int = 0
    flagged: int = 0

    def observe(self, step_time_s: float) -> bool:
        """Returns True if this step is a straggler."""
        self._seen += 1
        if self._seen <= self.warmup:
            return False
        if self._ewma is None:
            self._ewma = step_time_s
            return False
        is_straggler = step_time_s > self.threshold * self._ewma
        # Slow samples update the EWMA less (don't let stragglers poison it).
        a = self.alpha * (0.25 if is_straggler else 1.0)
        self._ewma = (1 - a) * self._ewma + a * step_time_s
        if is_straggler:
            self.flagged += 1
        return is_straggler

    def reset(self):
        """Drop the baseline (and re-enter warmup): call after a restart,
        where the first step re-pays jit compile time."""
        self._ewma = None
        self._seen = 0

    @property
    def baseline_s(self) -> float | None:
        return self._ewma


def run_with_restarts(
    *,
    make_state: Callable[[], Any],
    step_fn: Callable[[Any, int], Any],
    save_fn: Callable[[Any, int], None],
    restore_fn: Callable[[], tuple[Any, int] | None],
    num_steps: int,
    checkpoint_every: int = 50,
    max_restarts: int = 3,
    watchdog_timeout_s: float = 3600.0,
    on_event: Callable[[str], None] | None = None,
) -> tuple[Any, dict]:
    """The resilience loop: survive StepTimeout / NodeFailure via restore.

    Returns (final_state, stats).  ``step_fn(state, step) -> state``.
    """
    log = on_event or (lambda msg: None)
    watchdog = StepWatchdog(watchdog_timeout_s)
    straggler = StragglerDetector()
    restarts = 0
    stats = {"restarts": 0, "stragglers": 0, "steps_run": 0}

    restored = restore_fn()
    if restored is not None:
        state, start = restored
        log(f"restored checkpoint at step {start}")
    else:
        state, start = make_state(), 0

    step = start
    while step < num_steps:
        try:
            t0 = time.monotonic()
            state = watchdog.run(lambda: step_fn(state, step))
            dt = time.monotonic() - t0
            stats["steps_run"] += 1
            if straggler.observe(dt):
                stats["stragglers"] += 1
                log(f"straggler at step {step}: {dt:.3f}s vs ~{straggler.baseline_s:.3f}s")
            step += 1
            if step % checkpoint_every == 0 or step == num_steps:
                save_fn(state, step)
        except (StepTimeout, NodeFailure) as e:
            restarts += 1
            stats["restarts"] = restarts
            log(f"failure at step {step}: {e}; restart {restarts}/{max_restarts}")
            if restarts > max_restarts:
                raise
            restored = restore_fn()
            if restored is None:
                state, step = make_state(), 0
            else:
                state, step = restored
            # The restarted run re-traces: its first step pays compile
            # time again, and the old baseline belongs to a dead process
            # configuration — re-warm instead of flagging it.
            straggler.reset()
    return state, stats
