"""Chaos injection for the serve engine: seed-deterministic fault drills
(the port's own copy of ``repro.serve.chaos``, with the same seeded
schedule).

The injector drives the four failure modes the engine's recovery paths
handle, all from one seeded RNG, so a drill replays bit for bit:

  * **NaN-in-state**: poison one active slot's decode state between
    decode windows (a ``RecState`` ``h`` row, or a KV row at position 0
    for attention-only archs).  Exercises in-window quarantine and the
    host's re-prefill recovery.
  * **dispatch exception**: raise :class:`DispatchDropped` *before* the
    dispatched function starts updating the decode state in place.
    Exercises retry with backoff; starting nothing is what makes the
    retry safe.
  * **hang**: spin inside the dispatch until the engine's
    :class:`~repro_torch.ft.watchdog.StepWatchdog` fences the step off
    (``cancelled()`` flips), then abort without calling the function.
    Exercises watchdog timeout and retry.
  * **request drop**: an in-flight request vanishes (client gone).
    Exercises slot freeing with a typed ``dropped`` outcome.

``preempt_after`` kills the whole serve loop (:class:`EnginePreempted`)
after N decode dispatches, the drill for snapshot and restore.

Injection sites take the decode-dispatch index, so a drill can pin a
fault to an exact point (``nan_at=(2,)``); rates drive the smoke lanes.
Every injection is appended to :attr:`ChaosInjector.events` as
``(kind, dispatch_index, detail)`` and tallied in ``counters``.

The state faults write into the state in place (the port's decode state
is updated in place, where the reference donates it) and return it.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.model.attention import KVCache, PagedKVCache
from repro_torch.model.model import state_nodes
from repro_torch.model.recurrent import RecState

_SAME_SIZE_INT = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


class DispatchDropped(RuntimeError):
    """Injected dispatch failure, raised before the dispatch touched the
    decode state."""


class EnginePreempted(RuntimeError):
    """Injected host preemption: the serve loop dies mid-run."""


class ReplicaKilled(RuntimeError):
    """Injected replica death: unlike :class:`EnginePreempted`, the replica
    never comes back; a fleet hands its requests to survivors from its last
    snapshot."""


def _has_rec(state) -> bool:
    return any(isinstance(n, RecState) for n in state_nodes(state))


def _last_written(node: PagedKVCache, slot: int):
    """(flat pool row, mapped) of ``slot``'s most recently written
    position, as 0-d tensors on the node's device: a page the slot owns
    (shared prefix pages lie below its start length).  An unmapped
    position's row is the null page's, and the caller writes nothing
    there."""
    stacked = node.page_table.ndim - 2
    tbl = node.page_table[(0,) * stacked + (slot,)].long()
    ln = node.length[(0,) * stacked + (slot,)].long()
    pos = (ln - 1).clamp_min(0) % node.s_view
    page = tbl[pos // node.page_size]
    off = pos % node.page_size
    return page.clamp_min(0) * node.page_size + off, page >= 0


def poison_slot_state(state, slot: int):
    """Make ``slot``'s row of ``state`` non-finite, in place; returns
    ``state``.

    Recurrent leaves are preferred (every ``RecState``'s ``h`` row).  An
    attention-only state gets a NaN K row at position 0 of every dense KV
    node instead (a global layer attends to it at every later step, so the
    slot's logits go NaN through the masked softmax), and a paged node a
    NaN K row at the slot's most recently written position, on a page the
    slot owns.  Neighbours' rows are untouched.  The paged site is read on
    the device: no host copy."""
    has_rec = _has_rec(state)
    for node in state_nodes(state):
        if isinstance(node, RecState):
            stacked = node.conv.ndim - 3
            node.h[(slice(None),) * stacked + (slot,)] = float("nan")
        elif isinstance(node, KVCache) and not has_rec:
            stacked = node.k.ndim - 4
            node.k[(slice(None),) * stacked + (slot, slice(None), 0)] = float("nan")
        elif isinstance(node, PagedKVCache) and not has_rec:
            row, mapped = _last_written(node, slot)
            flat = node.k.view(node.k.shape[:-4] + (-1,) + node.k.shape[-2:])
            cur = flat[..., row, :, 0]
            flat[..., row, :, 0] = torch.where(mapped, torch.full_like(cur, float("nan")), cur)
    return state


def bitflip_slot_state(state, slot: int):
    """Flip the lowest bit of one element of ``slot``'s row, in place;
    returns ``state``.  The value stays finite but wrong, so only the state
    checksum (:func:`repro_torch.model.model.decode_state_checksum`) can
    see it.  The site is the first ``RecState``'s ``h`` when the arch has
    one, else the first KV node's K: a dense node's element at position 0,
    a paged node's at the slot's most recently written position (always
    mapped for an active slot; an unmapped one is left as it is).
    Neighbours are untouched."""
    has_rec = _has_rec(state)
    for node in state_nodes(state):
        if isinstance(node, PagedKVCache) and not has_rec:
            row, mapped = _last_written(node, slot)
            words = node.k.view(_SAME_SIZE_INT[node.k.element_size()])
            flat = words.view(words.shape[:-4] + (-1,) + words.shape[-2:])
            idx = (0,) * (node.k.ndim - 4)
            flat[idx + (row, 0, 0)] ^= mapped.to(flat.dtype)
            return state
        if isinstance(node, RecState):
            stacked = node.conv.ndim - 3
            leaf = node.h
        elif isinstance(node, KVCache) and not has_rec:
            stacked = node.k.ndim - 4
            leaf = node.k
        else:
            continue
        idx = (0,) * stacked + (slot,) + (0,) * (leaf.ndim - stacked - 1)
        leaf.view(_SAME_SIZE_INT[leaf.element_size()])[idx] ^= 1
        return state
    return state


@dataclasses.dataclass
class ChaosInjector:
    """Pluggable fault source for :meth:`ServeEngine.serve`.

    Rates are per-opportunity probabilities (one draw per decode window
    for ``nan_rate``, ``bitflip_rate`` and ``req_drop_rate``, one per
    dispatch attempt for ``drop_rate`` and ``hang_rate``); ``*_at`` pin
    injections to exact decode-dispatch indices.  All draws come from one
    numpy RNG seeded with ``seed``: a fixed seed replays the identical
    fault schedule, the reference's for the same calls.
    """

    seed: int = 0
    nan_rate: float = 0.0
    drop_rate: float = 0.0
    hang_rate: float = 0.0
    req_drop_rate: float = 0.0
    bitflip_rate: float = 0.0
    nan_at: tuple = ()
    drop_at: tuple = ()
    hang_at: tuple = ()
    req_drop_at: tuple = ()
    bitflip_at: tuple = ()
    #: Replica death at a pinned decode-dispatch count (fleet drills).
    replica_kill_at: tuple = ()
    preempt_after: int | None = None
    hang_poll_s: float = 0.005
    # An unwatched hang (no watchdog) ends here as a retried
    # DispatchDropped instead of wedging the host loop.
    max_hang_s: float = 2.0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        self.events: list[tuple[str, int, Any]] = []
        self.counters = {
            "nan": 0, "drop": 0, "hang": 0, "req_drop": 0, "preempt": 0,
            "bitflip": 0, "replica_kill": 0,
        }
        self._fired: set[tuple[str, int]] = set()

    def _hit(self, name: str, index: int, rate: float) -> bool:
        """One draw per opportunity; a pinned index fires exactly once (a
        retried dispatch keeps its index, so a pinned hang must not fire
        again on the retry)."""
        pinned = getattr(self, name + "_at")
        if index in pinned and (name, index) not in self._fired:
            self._fired.add((name, index))
            return True
        return self._rng.random() < rate

    # -- dispatch-path faults (run inside the watchdog thread) ----------

    def before_dispatch(self, kind: str, index: int,
                        cancelled: Callable[[], bool] | None = None):
        """Called inside the dispatch wrapper before the dispatched
        function.  May raise :class:`DispatchDropped` (drop), or hang until
        the watchdog's ``cancelled`` fence flips (hang); either way the
        function, and with it the decode state, is never touched."""
        if kind != "window":
            return
        if self._hit("drop", index, self.drop_rate):
            self.counters["drop"] += 1
            self.events.append(("drop", index, None))
            raise DispatchDropped(f"injected dispatch drop at {index}")
        if self._hit("hang", index, self.hang_rate):
            self.counters["hang"] += 1
            self.events.append(("hang", index, None))
            t0 = time.monotonic()
            while time.monotonic() - t0 < self.max_hang_s:
                if cancelled is not None and cancelled():
                    # Fenced off by the watchdog: abort without touching
                    # the state; the fence discards this raise.
                    raise DispatchDropped(
                        f"injected hang at {index} (watchdog cancelled)")
                time.sleep(self.hang_poll_s)
            raise DispatchDropped(f"injected hang at {index} (unwatched)")

    # -- state / request faults (host side, between windows) ------------

    def _pick(self, name: str, index: int, rate: float, active: np.ndarray,
              slot_req: list[int]) -> int | None:
        if not active.any() or not self._hit(name, index, rate):
            return None
        slot = int(self._rng.choice(np.nonzero(active)[0]))
        self.counters[name] += 1
        self.events.append((name, index, slot_req[slot]))
        return slot

    def maybe_poison(self, state, active: np.ndarray, index: int,
                     slot_req: list[int]):
        """Possibly NaN-poison one active slot.  Returns (state, slot|None)."""
        slot = self._pick("nan", index, self.nan_rate, active, slot_req)
        return (state if slot is None else poison_slot_state(state, slot)), slot

    def maybe_bitflip(self, state, active: np.ndarray, index: int,
                      slot_req: list[int]):
        """Possibly flip one state bit of an active slot (silent
        corruption).  Returns (state, slot|None)."""
        slot = self._pick("bitflip", index, self.bitflip_rate, active, slot_req)
        return (state if slot is None else bitflip_slot_state(state, slot)), slot

    def maybe_drop_request(self, active: np.ndarray, index: int,
                           slot_req: list[int]):
        """Possibly drop one in-flight request.  Returns slot|None."""
        return self._pick("req_drop", index, self.req_drop_rate, active, slot_req)

    def check_preempt(self, decode_dispatches: int):
        if (self.preempt_after is not None
                and decode_dispatches >= self.preempt_after):
            self.counters["preempt"] += 1
            self.events.append(("preempt", decode_dispatches, None))
            raise EnginePreempted(
                f"injected preemption after {decode_dispatches} dispatches")

    def check_replica_kill(self, decode_dispatches: int):
        """Raise :class:`ReplicaKilled` once at each pinned
        ``replica_kill_at`` count."""
        if (decode_dispatches in self.replica_kill_at
                and ("replica_kill", decode_dispatches) not in self._fired):
            self._fired.add(("replica_kill", decode_dispatches))
            self.counters["replica_kill"] += 1
            self.events.append(("replica_kill", decode_dispatches, None))
            raise ReplicaKilled(
                f"injected replica kill at dispatch {decode_dispatches}")
