"""Replica health: escalate per-dispatch fault signals into a fleet
verdict (the port's copy of ``repro.serve.health``, which is pure Python).

The serve engine already *measures* everything a fleet needs — the
:class:`~repro_torch.ft.watchdog.StepWatchdog` heartbeats around every
dispatch, the :class:`~repro_torch.ft.watchdog.StragglerDetector` EWMA-flags
slow windows, and ``last_serve_stats`` counts quarantines, corruptions
and retries per replica.  What is missing is the *policy*: when do those
per-dispatch signals mean "stop routing new work here" (``degraded``)
and when do they mean "this replica is gone, hand its work off"
(``dead``)?

:class:`ReplicaMonitor` is that policy, deliberately boring and
deterministic (every transition is unit-testable without a clock):

* ``healthy``  — route freely.
* ``degraded`` — no **new** admissions; in-flight work may finish.
    Entered when the recent-window quarantine+corruption rate crosses
    ``quarantine_rate_limit``, when ``straggler_limit`` consecutive
    dispatches are EWMA-flagged stragglers, or when the watchdog has
    timed out at least once.  A clean observation window heals back to
    ``healthy`` — degradation is a brown-out, not a verdict.
* ``dead``     — terminal.  Entered when the engine raises a
    non-recoverable fault (:class:`~repro_torch.serve.chaos.ReplicaKilled`,
    a dispatch-retry exhaustion, a device error), or when degradation
    persists for ``dead_after_degraded`` consecutive observations.
    A dead replica's state is *discarded*; the router recovers its
    requests from the replica's last atomic snapshot.

States only ever move ``healthy <-> degraded -> dead``; ``dead`` never
heals (a process that lost its device state cannot un-lose it — the
snapshot handoff is the recovery path, not resurrection).
"""

from __future__ import annotations

import dataclasses

from repro_torch.ft.watchdog import make_lock

HEALTHY = "healthy"
DEGRADED = "degraded"
DEAD = "dead"


@dataclasses.dataclass
class ReplicaMonitor:
    """Sliding-window escalation of one replica's fault signals.

    Call :meth:`observe` once per scheduler iteration with that
    iteration's *deltas* (faults since the previous observation) and
    flags; read :attr:`state`.  ``window`` is the number of recent
    observations the fault rate is computed over.
    """

    window: int = 20
    #: (quarantines + corruptions) / observations over the recent window
    #: at/above which the replica browns out.
    quarantine_rate_limit: float = 0.5
    #: Consecutive straggler-flagged dispatches that brown out.
    straggler_limit: int = 3
    #: Consecutive degraded observations after which the replica is
    #: declared dead (wedged, not merely slow).
    dead_after_degraded: int = 10

    def __post_init__(self):
        if self.window < 1:
            raise ValueError("window must be >= 1")
        # Observations may come from a health-probe thread while the
        # router loop reads the verdict: every mutation happens under
        # this lock, and :meth:`status` reads (state, reason) under it —
        # a reader never sees a new state with a stale reason (or a
        # ``dead`` that heals).
        self._lock = make_lock()
        self.state = HEALTHY
        self.reason = ""
        self._faults: list[int] = []     # recent per-observation fault counts
        self._timeouts: list[bool] = []  # recent watchdog-timeout flags
        self._straggler_run = 0
        self._degraded_run = 0
        #: (state, reason) history of every transition, oldest first.
        self.transitions: list[tuple[str, str]] = []

    def _goto(self, state: str, reason: str):
        if state != self.state:
            self.state = state
            self.reason = reason
            self.transitions.append((state, reason))

    def observe(self, *, faults: int = 0, straggler: bool = False,
                watchdog_timeout: bool = False) -> str:
        """Fold one scheduler iteration's signals in; returns the state.

        ``faults`` is the iteration's quarantine + corruption delta —
        both are one-slot blast-radius events individually, but a
        replica producing them at a sustained rate has a sick device,
        and routing fresh requests onto it just grows the handoff.
        """
        with self._lock:
            return self._observe_locked(
                faults=faults, straggler=straggler,
                watchdog_timeout=watchdog_timeout)

    def _observe_locked(self, *, faults: int, straggler: bool,
                        watchdog_timeout: bool) -> str:
        if self.state == DEAD:
            return self.state
        self._faults.append(int(faults))
        if len(self._faults) > self.window:
            self._faults.pop(0)
        self._timeouts.append(bool(watchdog_timeout))
        if len(self._timeouts) > self.window:
            self._timeouts.pop(0)
        self._straggler_run = self._straggler_run + 1 if straggler else 0

        rate = sum(1 for f in self._faults if f) / len(self._faults)
        # A watchdog timeout degrades until a full clean window has
        # passed since — it ages out of the sliding window the same way
        # the fault rate does, so one timeout is a brown-out, not a
        # death sentence.
        sick = (rate >= self.quarantine_rate_limit
                or self._straggler_run >= self.straggler_limit
                or any(self._timeouts))
        if sick:
            if self.state == HEALTHY:
                why = (f"fault rate {rate:.2f}" if rate
                       >= self.quarantine_rate_limit
                       else f"{self._straggler_run} consecutive stragglers"
                       if self._straggler_run >= self.straggler_limit
                       else "watchdog timeout")
                self._goto(DEGRADED, why)
            self._degraded_run += 1
            if self._degraded_run >= self.dead_after_degraded:
                self._goto(DEAD, f"degraded for {self._degraded_run} "
                                 "consecutive observations")
        else:
            self._degraded_run = 0
            if self.state == DEGRADED:
                self._goto(HEALTHY, "clean observation window")
        return self.state

    def mark_dead(self, reason: str):
        """Terminal, externally observed death (ReplicaKilled, dispatch
        retries exhausted, device error).  Idempotent."""
        with self._lock:
            self._goto(DEAD, reason)

    def status(self) -> tuple[str, str]:
        """Atomic (state, reason) pair — the torn-read-free way for a
        router loop to report a verdict an observer thread may be
        changing concurrently."""
        with self._lock:
            return self.state, self.reason

    @property
    def routable(self) -> bool:
        """True iff the router may place NEW requests here."""
        with self._lock:
            return self.state == HEALTHY
