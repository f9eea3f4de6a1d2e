"""Replica fleet: a health-checked pool of serve engines with snapshot
handoff (counterpart of ``repro.serve.fleet``).

One process, N :class:`~repro_torch.serve.engine.ServeEngine` replicas — same
config and (shared) params, *distinct* device-state trees — fed from one
shared FIFO/deadline queue.  The fleet is the cluster-scale rendering of
the paper's point-to-point argument that the single engine already makes
per slot: a fault's blast radius is one replica's hand-off, never a
fleet-global barrier.

* **Routing** is recovery-aware least-loaded: a request goes to the
  healthy replica with the smallest modeled backlog, where backlog
  counts queued + in-flight work *plus* the
  :func:`~repro_torch.core.cost_model.serve_recovery_steps` cost of the
  re-prefills sitting in the replica's recovery queue (a replica
  digesting handoffs is behind even when its queue looks short —
  :func:`~repro_torch.core.cost_model.serve_fleet_drain` models the win).
* **Health** escalates the engine's own per-dispatch signals — watchdog
  heartbeats, straggler EWMA flags, quarantine and corruption counts —
  through a per-replica :class:`~repro_torch.serve.health.ReplicaMonitor`:
  ``healthy -> degraded`` (no new admissions, in-flight work finishes)
  ``-> dead`` (state discarded).
* **Snapshot handoff**: replicas checkpoint atomically every
  ``snapshot_every`` dispatches through a background
  :class:`~repro_torch.checkpoint.checkpoint.AsyncSaver`.  When a replica
  dies (:class:`~repro_torch.serve.chaos.ReplicaKilled`, dispatch-retry
  exhaustion, a watchdog timeout after a dispatch began updating the
  state in place, or monitor escalation), its live memory is *discarded* —
  exactly what a real process loss means — and its undelivered requests
  resume on survivors from the accepted prefix recorded in its last
  on-disk snapshot.  The per-(request, token-index) sampling keys make
  every resumed stream bit-identical to the one the dead replica was
  producing, so a client cannot tell a handoff happened except by
  latency.

Requests whose snapshot shows no accepted token (never admitted on the
victim) re-enter the shared queue as fresh work — no recovery is
charged, and their outcome stays ``ok``/``eos``.
"""

from __future__ import annotations

import collections
import time
from pathlib import Path
from typing import Any

import numpy as np

from repro_torch.checkpoint import checkpoint as C
from repro_torch.ft.watchdog import StepTimeout
from repro_torch.serve import health as H
from repro_torch.serve.chaos import EnginePreempted, ReplicaKilled
from repro_torch.serve.engine import OUTCOMES, RequestResult, ServeSession

#: Snapshot ``meta`` vector length (see ``ServeEngine._serve_meta``) —
#: a handoff validates shape and ranges before trusting the payload.
META_LEN = 9

#: Fleet-level counters (per-replica serve stats stay on each engine's
#: ``last_serve_stats``).
FLEET_STAT_KEYS = (
    "rounds", "assignments", "handoffs", "replica_deaths",
    "handoff_requeued_fresh", "shared_deadline_hits", "shared_shed",
)


def read_snapshot_host(snapshot_dir, n: int):
    """Read the host half of a replica's latest serve snapshot and
    validate it as a handoff source.

    Returns ``None`` when no snapshot landed (the victim dies before its
    first ``snapshot_every`` boundary — survivors then re-run its
    requests from scratch).  Otherwise returns
    ``{"outputs": list[list[int]], "outcomes": list[str|None], "meta"}``.

    A corrupt or mismatched snapshot raises: handing off from a snapshot
    whose meta says a different request count / geometry would silently
    resume the wrong streams, which is worse than failing loudly.  The
    keys are the ``arrays.npz`` names :func:`repro_torch.tree.tree_paths`
    gives the snapshot tree of ``ServeEngine._snapshot_serve``: ``meta``
    and ``host/...``.
    """
    step = C.latest_step(snapshot_dir)
    if step is None:
        return None
    with np.load(Path(snapshot_dir) / f"step_{step}" / "arrays.npz") as data:
        if "meta" not in data.files:
            raise ValueError(f"snapshot {snapshot_dir} has no meta vector")
        meta = data["meta"]
        host = {k.split("/", 1)[1]: data[k] for k in data.files
                if k.startswith("host/")}
    if meta.shape != (META_LEN,):
        raise ValueError(
            f"snapshot meta has shape {meta.shape}, want ({META_LEN},) — "
            "not a serve snapshot this fleet can hand off from")
    if int(meta[3]) != n:
        raise ValueError(
            f"snapshot meta says {int(meta[3])} requests, fleet has {n} — "
            "refusing to hand off from a different serve")
    if min(int(meta[0]), int(meta[1]), int(meta[2])) < 1:
        raise ValueError(
            f"snapshot meta geometry {meta.tolist()} is malformed")
    off = host["out_off"]
    flat = host["out_flat"]
    if off.shape != (n + 1,) or int(off[-1]) != flat.size:
        raise ValueError("snapshot output offsets are inconsistent")
    outputs = [[int(t) for t in flat[off[i]: off[i + 1]]] for i in range(n)]
    outcomes = [None if c < 0 else OUTCOMES[int(c)]
                for c in host["outcome_codes"]]
    return {"outputs": outputs, "outcomes": outcomes, "meta": meta}


class FleetRouter:
    """Drive ``requests`` to completion across a pool of engine replicas.

    ``engines`` must be configured identically (same cfg, max_len,
    decode_window, paging) — the sessions they host derive identical jit
    shapes and snapshot meta from the shared request list, which is what
    makes a request's stream independent of which replica runs it.
    ``chaos`` is an optional per-replica list of
    :class:`~repro_torch.serve.chaos.ChaosInjector` (``None`` entries = no
    chaos on that replica).
    """

    def __init__(self, engines, requests, *, slots: int = 4,
                 temperature: float = 0.0, top_k: int = 0,
                 eos_id: int | None = None, seed: int = 0,
                 deadline_ms: float | None = None,
                 max_queue: int | None = None,
                 watchdog_timeout_s: float | None = None,
                 max_dispatch_retries: int = 3,
                 retry_backoff_s: float = 0.02,
                 snapshot_every: int = 0,
                 snapshot_root: str | None = None,
                 checksum_every: int = 0,
                 chaos: list | None = None,
                 monitor_kw: dict | None = None,
                 clock=time.monotonic):
        if not engines:
            raise ValueError("need at least one engine replica")
        if snapshot_every > 0 and snapshot_root is None:
            raise ValueError("snapshot_every > 0 needs snapshot_root")
        if chaos is not None and len(chaos) != len(engines):
            raise ValueError("chaos must have one entry per engine")

        self.engines = list(engines)
        self.reqs = list(requests)
        self.n = len(self.reqs)
        self.k_w = max(1, int(self.engines[0].decode_window))
        self.deadline_ms = deadline_ms
        self._clock = clock
        self.t_origin = clock()
        self.stats = {k: 0 for k in FLEET_STAT_KEYS}
        self.record: list[RequestResult | None] = [None] * self.n
        #: request -> replica currently responsible (-1 = shared queue).
        self.assigned = [-1] * self.n
        self.sessions: list[ServeSession] = []
        self.savers: list[Any] = []
        self.snapshot_dirs: list[str | None] = []
        for i, eng in enumerate(self.engines):
            sdir = (str(Path(snapshot_root) / f"replica{i}")
                    if snapshot_root is not None else None)
            saver = C.AsyncSaver() if snapshot_every > 0 else None
            self.sessions.append(ServeSession(
                eng, self.reqs, slots=slots, temperature=temperature,
                top_k=top_k, eos_id=eos_id, seed=seed,
                deadline_ms=deadline_ms,
                watchdog_timeout_s=watchdog_timeout_s,
                max_dispatch_retries=max_dispatch_retries,
                retry_backoff_s=retry_backoff_s,
                snapshot_every=snapshot_every, snapshot_dir=sdir,
                chaos=None if chaos is None else chaos[i],
                recoverable=True, checksum_every=checksum_every,
                clock=clock, clock_origin=self.t_origin, external=True,
                saver=saver))
            self.savers.append(saver)
            self.snapshot_dirs.append(sdir)
        self.monitors = [H.ReplicaMonitor(**(monitor_kw or {}))
                         for _ in self.engines]
        self.death_reasons: list[str | None] = [None] * len(self.engines)
        # Validation/capacity sheds happen identically in every session
        # (same engines, same request list): the first drain records them.
        for i in range(len(self.sessions)):
            self._drain(i)
        self.shared: collections.deque[int] = collections.deque(
            ri for ri in range(self.n) if self.record[ri] is None)
        #: handoff accepted-prefix staging: request -> tokens to resume
        #: from when it is next assigned.
        self._handoff_prefix: dict[int, list[int]] = {}
        if max_queue is not None:
            # Fleet-wide admission bound: every live replica's slots
            # admit immediately; at most max_queue requests may wait in
            # the shared queue beyond that.
            cap = slots * len(self.engines) + max(0, int(max_queue))
            while len(self.shared) > cap:
                ri = self.shared.pop()
                self.record[ri] = RequestResult(
                    tokens=np.zeros(0, np.int32), outcome="shed")
                self.stats["shared_shed"] += 1
        # Per-replica signal baselines for monitor deltas.
        self._sig = [dict(faults=0, stragglers=0, timeouts=0)
                     for _ in self.engines]

    # -- routing ---------------------------------------------------------

    def _live(self):
        return [i for i in range(len(self.sessions))
                if self.monitors[i].state != H.DEAD]

    def _routable(self):
        """Replicas new work may be placed on: healthy ones — or, when
        the whole fleet is browned out, the degraded survivors (serving
        slowly beats deadlocking the queue)."""
        ok = [i for i in self._live() if self.monitors[i].routable]
        return ok or self._live()

    def _load(self, i: int) -> int:
        """Modeled backlog in slot-steps: queued + in-flight dispatch
        work plus the recovery debt of pending handoff re-prefills."""
        s = self.sessions[i]
        return (s.queue_depth() * self.k_w
                + s.recovery_debt_steps(window=self.k_w))

    def _assign(self):
        cand = self._routable()
        if not cand:
            return
        while self.shared:
            # Least-loaded among routable replicas, bounded local queue:
            # a replica holds at most 2x its slot count so late-healing
            # replicas still find work in the shared queue.
            tgt = min(cand, key=self._load)
            sess = self.sessions[tgt]
            if sess.queue_depth() >= 2 * sess.b:
                break
            ri = self.shared.popleft()
            if self.record[ri] is not None:
                continue
            acc = self._handoff_prefix.pop(ri, None)
            if acc:
                sess.enqueue_handoff(ri, acc)
            else:
                sess.enqueue(ri)
            self.assigned[ri] = tgt
            self.stats["assignments"] += 1

    def _sweep_shared_deadlines(self):
        if self.deadline_ms is None and not any(
                getattr(r, "deadline_ms", None) is not None
                for r in self.reqs):
            return
        now_ms = (self._clock() - self.t_origin) * 1e3
        for _ in range(len(self.shared)):
            ri = self.shared.popleft()
            d = getattr(self.reqs[ri], "deadline_ms", None)
            dl = self.deadline_ms if d is None else d
            if dl is not None and now_ms > dl:
                # Shared-queue wait counts against the deadline: the
                # request dies here with whatever handoff prefix it had.
                acc = self._handoff_prefix.pop(ri, [])
                self.record[ri] = RequestResult(
                    tokens=np.asarray(acc, np.int32), outcome="deadline")
                self.stats["shared_deadline_hits"] += 1
            else:
                self.shared.append(ri)

    # -- results + health plumbing --------------------------------------

    def _drain(self, i: int):
        sess = self.sessions[i]
        for ri in sess.drain_done():
            if self.record[ri] is None:
                self.record[ri] = RequestResult(
                    tokens=np.asarray(sess.outputs[ri], np.int32),
                    outcome=sess.outcomes[ri],
                    recoveries=sess.recoveries[ri])

    def _observe(self, i: int):
        sess, sig = self.sessions[i], self._sig[i]
        faults = sess.stats["quarantines"]
        stragglers = sess.stats["stragglers"]
        timeouts = sess.stats["watchdog_timeouts"]
        state = self.monitors[i].observe(
            faults=faults - sig["faults"],
            straggler=stragglers > sig["stragglers"],
            watchdog_timeout=timeouts > sig["timeouts"])
        sig.update(faults=faults, stragglers=stragglers, timeouts=timeouts)
        return state

    def _handoff(self, victim: int, reason: str):
        """Discard a dead replica's live memory; resume its undelivered
        requests on survivors from its last atomic snapshot."""
        self.monitors[victim].mark_dead(reason)
        self.death_reasons[victim] = reason
        self.stats["replica_deaths"] += 1
        sess = self.sessions[victim]
        # Results already completed host-side were delivered to clients
        # before the failure — keep them.
        self._drain(victim)
        # The dead process's memory is gone; never run its close-time
        # device audit, and drop its device state (below) as a lost
        # process would lose it.  Its saver may still be mid-write: join
        # it so the snapshot we read is the newest one that LANDED (a
        # failed write surfaces as AsyncSaverError and falls back to the
        # prior LATEST, which is still atomic).
        sess.closed = True
        sess.eng.last_serve_stats = sess.stats
        if self.savers[victim] is not None:
            try:
                self.savers[victim].wait()
            except Exception:  # noqa: BLE001 — victim is dead either way
                pass
        snap = None
        if self.snapshot_dirs[victim] is not None:
            snap = read_snapshot_host(self.snapshot_dirs[victim], self.n)
        orphans = [ri for ri in range(self.n)
                   if self.assigned[ri] == victim
                   and self.record[ri] is None]
        for ri in orphans:
            acc = snap["outputs"][ri] if snap is not None else []
            self.assigned[ri] = -1
            if acc:
                self._handoff_prefix[ri] = acc
                self.stats["handoffs"] += 1
            else:
                # Never admitted on the victim (or no snapshot landed):
                # plain re-run, no recovery charged.
                self.stats["handoff_requeued_fresh"] += 1
            self.shared.append(ri)
        sess.state = None
        if not self._live() and (self.shared or self._handoff_prefix):
            outstanding = sum(1 for r in self.record if r is None)
            raise RuntimeError(
                f"all {len(self.sessions)} replicas dead with "
                f"{outstanding} requests outstanding (last death: {reason})")

    # -- the drive loop --------------------------------------------------

    @property
    def done(self) -> bool:
        return all(r is not None for r in self.record)

    def step_round(self):
        """One fleet scheduler round: shared-queue deadline sweep,
        recovery-aware assignment, then one session step per live busy
        replica (with health observation and death handling)."""
        self.stats["rounds"] += 1
        self._sweep_shared_deadlines()
        self._assign()
        for i in self._live():
            sess = self.sessions[i]
            if not sess.busy:
                continue
            try:
                sess.step()
                self._drain(i)
                if self._observe(i) == H.DEAD:
                    self._handoff(i, self.monitors[i].reason)
            except (ReplicaKilled, EnginePreempted, StepTimeout,
                    RuntimeError) as e:
                # A StepTimeout here came after the dispatch began updating
                # the state in place (one before it started was retried):
                # the replica is lost, its snapshot is the way back.
                self._handoff(i, repr(e))

    def run(self) -> list[RequestResult]:
        try:
            while not self.done:
                before = sum(1 for r in self.record if r is not None)
                self.step_round()
                after = sum(1 for r in self.record if r is not None)
                # Post-round state: a round that completed nothing is
                # still progress if work remains in flight (busy
                # session) or schedulable (shared queue) — only the
                # all-idle, all-drained case is a wedge.
                busy = any(self.sessions[i].busy for i in self._live())
                if after == before and not busy and not self.shared:
                    raise RuntimeError(
                        "fleet made no progress with requests outstanding")
        finally:
            self.close()
        return self.results()

    def close(self):
        for i in self._live():
            self.sessions[i].close()

    def results(self) -> list[RequestResult]:
        missing = [ri for ri, r in enumerate(self.record) if r is None]
        if missing:
            raise RuntimeError(f"requests {missing} never completed")
        return list(self.record)

    def stats_by_replica(self) -> list[dict]:
        """Per-replica serve stats (engine ``last_serve_stats`` after the
        session closed — for a dead replica, its stats at death)."""
        return [dict(s.stats) for s in self.sessions]
