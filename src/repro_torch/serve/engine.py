"""Serving: prompt scoring (``make_prefill_step``), cache prefill, a
lockstep greedy ``generate`` and a continuous-batching ``serve``
(counterpart of ``repro.serve.engine``).

The reference jits each step and donates the decode state so XLA updates
it in place; here the state tensors are preallocated once per call and
:func:`repro_torch.model.model.decode_step` writes every layer's new state
into them in place.  Everything runs under ``torch.inference_mode()``.

``serve`` is the continuous-batching scheduler of the reference, with its
fault isolation: a FIFO slot pool, ragged prompts admitted by one masked
prefill each round, per-slot progress, EOS and budget detected inside each
K-token window; a slot whose state or logits go non-finite is quarantined
inside the window and re-admitted from its accepted prefix; request
deadlines, a bounded queue, a dispatch watchdog with retries, and atomic
snapshots that a later call resumes from.  :class:`ServeSession` is one
such serve, stepped by the caller; ``serve`` drives it to completion.
Chaos injection (:mod:`repro_torch.serve.chaos`) drills all of it.  The
checksum chain, paging and the fleet are not ported yet.

Long prompts: with a ``mesh`` (:mod:`repro_torch.launch.mesh`), a prompt
of at least :data:`SEQ_PREFILL_MIN_T` tokens is prefilled under the
``prefill_seq`` sharding rules, so every RWKV layer's WKV runs
sequence-parallel over the mesh (:mod:`repro_torch.kernels.wkv.seqpar`):
:func:`make_seq_prefill_step` for prompt scoring,
:func:`make_cache_prefill_step` for the cache fill of ``generate``, and
the admission of ``serve``.  Shorter prompts run under the plain
``prefill`` rules, which shard nothing.

Sampling: ``temperature <= 0`` is greedy argmax, the mode that matches the
reference token for token.  Above 0 the reference keys JAX's threefry on
(request, token index), which torch cannot reproduce; the port draws
Gumbel-max noise from an integer hash of (seed, request id, token index,
vocab index) instead (:func:`_sample_tokens`), so a request's stream is a
function of the request alone, the same for any decode window or slot
count.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
import types
from pathlib import Path
from typing import Any

import numpy as np
import torch

from repro_torch.checkpoint import checkpoint as C
from repro_torch.core import cost_model
from repro_torch.ft.watchdog import StepTimeout, StepWatchdog, StragglerDetector, make_lock
from repro_torch.kernels.common import resolve_device
from repro_torch.model import model as M
from repro_torch.model.attention import KVCache
from repro_torch.model.sharding import make_rules, sharding_context
from repro_torch.serve.chaos import DispatchDropped

#: Prompts at/above this length take the sequence-parallel rules when a
#: mesh is given; below it, the summary hops cost more than the per-shard
#: work saves.
SEQ_PREFILL_MIN_T = 1024


def _prefill_rules(mesh, p: int, min_len: int = SEQ_PREFILL_MIN_T):
    """The sharding context of a ``p``-token prefill: ``prefill_seq`` rules
    at/above ``min_len`` tokens, plain ``prefill`` rules below, nothing
    without a mesh."""
    if mesh is None:
        return contextlib.nullcontext()
    return sharding_context(mesh, make_rules(
        mesh, "prefill_seq" if p >= min_len else "prefill"))


def make_prefill_step(cfg):
    """``(params, tokens (B, S)) -> logits (B, S, V)``: prompt scoring
    through the cache-free :func:`~repro_torch.model.model.forward`.
    The reference's ``cfg.prefill_chunks > 1`` (the batch scored in
    sequential chunks) is not ported: no ported configuration sets it."""
    if cfg.prefill_chunks > 1:
        raise NotImplementedError(
            f"make_prefill_step: prefill_chunks={cfg.prefill_chunks} is not "
            "ported; only 1 (the whole batch in one forward) is")

    def prefill_step(params, tokens):
        return M.forward(params, cfg, tokens)

    return prefill_step


def make_seq_prefill_step(cfg, mesh, *, min_len: int = SEQ_PREFILL_MIN_T):
    """Long-context prompt scoring: :func:`make_prefill_step` under the
    ``prefill_seq`` rules of ``mesh`` for prompts of at least ``min_len``
    tokens, so each RWKV layer sweeps every sequence shard with the summary
    kernel and only the O(Dh²) (decay, state) summaries cross the ``seq``
    axis.  Shorter prompts run under the plain ``prefill`` rules."""
    base = make_prefill_step(cfg)

    def prefill_step(params, tokens):
        with _prefill_rules(mesh, tokens.shape[1], min_len):
            return base(params, tokens)

    return prefill_step


def make_cache_prefill_step(cfg, mesh=None, *, min_len: int = SEQ_PREFILL_MIN_T,
                            last_only: bool = False, max_len: int | None = None):
    """``(params, state, tokens (B, P)[, prompt_lengths (B,)]) ->
    (logits, state)``: the whole prompt goes through one ``decode_step``
    window from position 0, so the WKV part takes the decode-window kernel
    (P <= 64) or the chunked kernel, not P single steps.  ``state`` is
    updated in place.  ``prompt_lengths`` masks ragged prompts: padding
    enters no state, and with ``last_only`` the logits are taken at each
    row's last valid token.  With ``mesh``, prompts of at least
    ``min_len`` tokens run under the ``prefill_seq`` rules (the routing of
    :func:`make_seq_prefill_step`), shorter ones under plain ``prefill``
    rules."""

    def cache_prefill(params, state, tokens, prompt_lengths=None):
        mask = None
        if prompt_lengths is not None:
            p = tokens.shape[1]
            plen = torch.as_tensor(prompt_lengths, device=tokens.device)
            mask = torch.arange(p, device=tokens.device)[None, :] < plen[:, None]
        with _prefill_rules(mesh, tokens.shape[1], min_len):
            return M.decode_step(params, cfg, state, tokens, 0,
                                 last_only=last_only, token_mask=mask,
                                 max_len=max_len)

    return cache_prefill


@dataclasses.dataclass
class Request:
    """One serve request: a prompt, a generation budget and an optional
    wall-clock deadline (milliseconds from the start of the serve; ``None``
    takes the serve-wide default, which may itself be ``None``)."""

    tokens: Any                    # (P,) int prompt token ids
    max_new_tokens: int = 16
    deadline_ms: float | None = None


#: Terminal per-request outcomes (see :class:`RequestResult`):
#:   ok        completed by spending its token budget
#:   eos       completed by sampling ``eos_id``
#:   deadline  killed at its wall-clock deadline (tokens are partial)
#:   shed      refused: the bounded queue was full, or prompt plus budget
#:             exceed ``max_len``
#:   dropped   chaos or client drop mid-flight (tokens are partial)
#:   recovered completed (budget or EOS) after at least one quarantine and
#:             re-prefill
#:   corrupt   checksum-detected corruption recurred past the recovery cap
OUTCOMES = ("ok", "eos", "deadline", "shed", "dropped", "recovered",
            "corrupt")

#: ``last_serve_stats`` keys, in the order a snapshot packs them: append
#: only, never reorder.
SERVE_STAT_KEYS = (
    "decode_dispatches", "admissions", "slot_steps", "quarantines",
    "recoveries", "dispatch_retries", "dispatch_drops",
    "watchdog_timeouts", "stragglers", "deadline_hits", "shed",
    "req_drops", "snapshots", "page_waits", "prefix_admissions",
    "corruptions", "checksum_spot_checks",
)

#: A request whose detected corruption recurs past this many recoveries
#: ends ``corrupt`` instead of cycling forever.
MAX_CORRUPTION_RECOVERIES = 3

#: Optional hook ``hook(phase, kind)``, phase ``"pre"``/``"post"``, around
#: every dispatch of a serve, inside the watchdog's worker thread when one
#: is active.  ``None`` in service; a drill installs a preemption point.
dispatch_hook = None


@dataclasses.dataclass
class RequestResult:
    """One served request's tokens (prompt excluded), its outcome (one of
    :data:`OUTCOMES`) and how many quarantine re-prefills it survived.
    Array-like, so results drop into code written for bare token
    arrays."""

    tokens: np.ndarray
    outcome: str = "ok"
    recoveries: int = 0

    def __array__(self, dtype=None, copy=None):
        a = self.tokens if dtype is None else self.tokens.astype(dtype)
        return a.copy() if copy else a

    def __len__(self):
        return int(self.tokens.size)

    def __iter__(self):
        return iter(self.tokens)

    def __getitem__(self, i):
        return self.tokens[i]

    @property
    def size(self) -> int:
        return int(self.tokens.size)

    def tolist(self):
        return self.tokens.tolist()


def _bucket32(length: int) -> int:
    """Prompt-length bucket (next multiple of 32), as the reference pads
    admission windows."""
    return -(-max(int(length), 1) // 32) * 32


def _reset_slot_rows(state, rows: torch.Tensor):
    """Reset the decode state of the slots marked in ``rows`` (B,) bool, in
    place; every other slot is untouched.  Recurrent states go to zero; a
    KV cache's length goes to 0 and its non-finite entries in those rows
    are scrubbed to 0 (finite stale entries stay: with length 0 the
    positional masks never reach them, but a masked NaN would still poison
    the weighted sum)."""
    for node in M.state_nodes(state):
        if isinstance(node, KVCache):
            stacked = node.k.ndim - 4
            node.length.masked_fill_(rows.reshape((1,) * stacked + (-1,)), 0)
            mk = rows.reshape((1,) * stacked + (-1, 1, 1, 1))
            for leaf in (node.k, node.v):
                leaf.masked_fill_(mk & ~torch.isfinite(leaf), 0)
            continue
        stacked = node.conv.ndim - 3
        for leaf in (node.h, node.conv):
            shape = [1] * leaf.ndim
            shape[stacked] = -1
            leaf.masked_fill_(rows.reshape(shape), 0)


_MASK32 = 0xFFFFFFFF


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash (xorshift-multiply rounds) on int64 tensors
    holding values below 2**32.  The multipliers stay below 2**31, so no
    product overflows int64: CPU and GPU give the same bits."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _MASK32
    x = x ^ (x >> 15)
    x = (x * 0x2C1B3C6D) & _MASK32
    return x ^ (x >> 16)


def _gumbel(seed: int, req_ids, tok_idx, vocab: int) -> torch.Tensor:
    """(B, V) f32 Gumbel noise, a pure function of (seed, request id,
    token index, vocab index)."""
    dev = req_ids.device
    key = _mix32(torch.full_like(req_ids, seed & _MASK32, dtype=torch.int64))
    key = _mix32(key ^ req_ids.long())
    key = _mix32(key ^ tok_idx.long())
    vid = torch.arange(vocab, device=dev, dtype=torch.int64)
    bits = _mix32(_mix32(key[:, None] ^ vid[None, :]) + 0x9E3779B9)
    uniform = ((bits >> 8).float() + 0.5) / float(1 << 24)     # in (0, 1)
    return -torch.log(-torch.log(uniform))


def _sample_tokens(logits, seed: int, req_ids, tok_idx, temperature: float,
                   top_k: int) -> torch.Tensor:
    """One token per slot from ``logits`` (B, V): greedy at
    ``temperature <= 0``, else temperature / top-k Gumbel-max with noise
    keyed on (seed, request id, token index)."""
    if temperature <= 0.0:
        return logits.argmax(dim=-1)
    lg = logits.float() / float(temperature)
    if top_k and top_k < lg.shape[-1]:
        kth = torch.topk(lg, int(top_k), dim=-1).values[..., -1:]
        lg = lg.masked_fill(lg < kth, float("-inf"))
    return (lg + _gumbel(seed, req_ids, tok_idx, lg.shape[-1])).argmax(dim=-1)


@dataclasses.dataclass
class ServeEngine:
    """Batched server: one prefill into the decode state, then K-token
    decode windows.  ``device=None`` means the card; ``params`` must already
    live on that device (see :func:`repro_torch.model.model.init_params`).

    ``generate`` is the lockstep loop (``ceil(n / K)`` windows); ``serve``
    is the continuous-batching scheduler.  After each call ``last_state``
    holds the final decode state and ``last_decode_dispatches`` /
    ``last_serve_stats`` count the work done.

    ``mesh`` routes prefills of at least :data:`SEQ_PREFILL_MIN_T` tokens
    (the ``generate`` prompt, a ``serve`` admission bucket) through the
    sequence-parallel rules; its shards must lie on devices of the
    engine's type.
    """

    cfg: Any
    params: Any
    max_len: int = 256
    decode_window: int = 8
    device: Any = None
    mesh: Any = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        emb = self.params["tok"]["embedding"]
        if emb.device.type != self.device.type:
            raise ValueError(
                f"params live on {emb.device}, engine device is {self.device}")
        if self.mesh is not None and any(
                d.type != self.device.type for d in self.mesh.devices.flat):
            raise ValueError(
                f"mesh devices {sorted({str(d) for d in self.mesh.devices.flat})} "
                f"are not of the engine's device type {self.device.type}")
        self._prefill = make_cache_prefill_step(
            self.cfg, self.mesh, last_only=True, max_len=self.max_len)
        self.last_state = None
        self.last_decode_dispatches = 0
        self.last_serve_stats: dict[str, int] = {}

    def _new_state(self, batch: int, insert_window: int):
        return M.init_decode_state(self.cfg, batch, self.max_len, insert_window,
                                   device=self.device)

    # ------------------------------------------------------------------
    # Lockstep generation
    # ------------------------------------------------------------------

    def _window(self, state, cur, pos, k: int, last: bool):
        """K greedy decode steps; emits the K tokens fed in.  The final
        window of a run stops one step short: its last token needs no
        successor."""
        toks = []
        for _ in range(k - 1 if last else k):
            logits, state = M.decode_step(self.params, self.cfg, state, cur,
                                          pos, max_len=self.max_len)
            toks.append(cur)
            cur = logits[:, -1].argmax(dim=-1)[:, None]
            pos = pos + 1
        if last:
            toks.append(cur)
        return torch.cat(toks, dim=1), cur, pos

    @torch.inference_mode()
    def generate(self, prompts, num_new_tokens: int, prompt_lengths=None):
        """prompts: (B, P) int -> (B, P + num_new_tokens) int64 on the
        engine's device.  ``prompt_lengths`` (B,) marks ragged prompts:
        padding enters no state and each row continues from its own last
        prompt token (generated tokens still start at column P)."""
        prompts = torch.as_tensor(prompts, device=self.device).long()
        b, p_len = prompts.shape
        k_w = max(1, int(self.decode_window))
        # The widest window any call inserts (the whole prompt at prefill)
        # sizes the local-attention ring slack, bucketed as the reference does.
        state = self._new_state(b, max(k_w, _bucket32(p_len)))
        logits, state = self._prefill(self.params, state, prompts,
                                      prompt_lengths)
        self.last_state = state
        self.last_decode_dispatches = 0
        if num_new_tokens <= 0:
            return prompts
        out = [prompts]
        cur = logits[:, -1].argmax(dim=-1)[:, None]
        pos = (
            torch.tensor(p_len, device=self.device) if prompt_lengths is None
            else torch.as_tensor(prompt_lengths, device=self.device).long()
        )
        left = num_new_tokens
        while left > 0:
            k = min(k_w, left)
            toks, cur, pos = self._window(state, cur, pos, k, last=(k == left))
            self.last_decode_dispatches += 1
            out.append(toks)
            left -= k
        return torch.cat(out, dim=1)

    # ------------------------------------------------------------------
    # Continuous batching
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def serve(self, requests, *, slots: int = 4, temperature: float = 0.0,
              top_k: int = 0, eos_id: int | None = None, seed: int = 0,
              deadline_ms: float | None = None,
              max_queue: int | None = None,
              watchdog_timeout_s: float | None = None,
              max_dispatch_retries: int = 3,
              retry_backoff_s: float = 0.02,
              snapshot_every: int = 0,
              snapshot_dir: str | None = None,
              restore_from: str | None = None,
              chaos: Any = None,
              recoverable: bool | None = None):
        """Decode ``requests`` (:class:`Request`, or bare prompt arrays)
        through a pool of ``slots`` batch slots, first come first served:
        a :class:`ServeSession` stepped until it has no work left.

        Each round admits queued requests into free slots with one masked
        prefill (other slots' states stay bit-identical), then runs one
        K-token window in which every live slot decodes at its own position
        and stops at ``eos_id`` or its own budget.  The blast radius of a
        fault is one slot:

        * a slot whose state or logits go non-finite is quarantined inside
          the window (its bad token is never emitted) and re-admitted with
          its prompt plus the accepted tokens, sampling on at the same
          token index, so its stream is the one the fault interrupted and
          every other slot is bit-identical to a fault-free run;
        * ``deadline_ms`` (``Request.deadline_ms`` overrides it) ends a
          request past its wall-clock budget (``deadline``);
          ``max_queue`` lets at most that many requests wait beyond the
          slots, later arrivals are ``shed``; a request whose prompt plus
          budget exceed ``max_len`` is shed too;
        * a dispatch that fails before it starts (a chaos drop, a hang the
          watchdog of ``watchdog_timeout_s`` fences off) is retried up to
          ``max_dispatch_retries`` times, backing off exponentially from
          ``retry_backoff_s``;
        * ``snapshot_every`` > 0 saves the whole serve to ``snapshot_dir``
          every N decode windows; ``restore_from`` resumes it (same
          requests, slots, window and seed) bit-identically.

        ``chaos`` takes a :class:`repro_torch.serve.chaos.ChaosInjector`.
        ``recoverable`` sizes the local-attention rings for a worst-case
        recovery re-prefill (prompt plus whole budget); it defaults on with
        chaos, snapshots or a restore and off otherwise, where ring sizes,
        and so fault-free streams, stay those of a plain serve.

        Returns one :class:`RequestResult` per request, in order; the
        counters land in ``last_serve_stats`` and the final state in
        ``last_state``."""
        session = ServeSession(
            self, requests, slots=slots, temperature=temperature,
            top_k=top_k, eos_id=eos_id, seed=seed, deadline_ms=deadline_ms,
            max_queue=max_queue, watchdog_timeout_s=watchdog_timeout_s,
            max_dispatch_retries=max_dispatch_retries,
            retry_backoff_s=retry_backoff_s, snapshot_every=snapshot_every,
            snapshot_dir=snapshot_dir, restore_from=restore_from,
            chaos=chaos, recoverable=recoverable)
        try:
            while session.busy:
                session.step()
        finally:
            session.close()
        return session.results()

    def _dispatch(self, kind, fn, *, chaos, watchdog, straggler, stats,
                  max_retries, backoff_s, index):
        """``fn()`` through the fault plumbing, with retries.

        Chaos runs first, inside the watchdog's worker thread when there is
        one, before ``fn``.  ``fn`` updates the decode state in place (the
        reference's donation), so only a failure raised before ``fn``
        starts is retried: a chaos drop, or a hang fenced off by the
        watchdog.  A timeout after ``fn`` has started raises
        :class:`StepTimeout` at once: re-running ``fn`` on a half-updated
        state would corrupt it, so that case resumes from a snapshot.  A
        small gate makes "started" and "abandoned" exclusive, so a worker
        the watchdog gave up on never starts ``fn`` late.

        ``fn`` must end in its host copy (the synchronisation point), so
        the watchdog and the straggler detector time the device work and
        not just its enqueue.  The worker thread enters the caller's
        device, stream and inference mode, which are per thread."""
        dev = self.device
        stream = torch.cuda.current_stream(dev) if dev.type == "cuda" else None

        def call(gate):
            with contextlib.ExitStack() as ctx:
                ctx.enter_context(torch.inference_mode())
                if stream is not None:
                    ctx.enter_context(torch.cuda.device(dev))
                    ctx.enter_context(torch.cuda.stream(stream))
                hook = dispatch_hook
                if hook is not None:
                    hook("pre", kind)
                if chaos is not None:
                    chaos.before_dispatch(
                        kind, index,
                        cancelled=watchdog.cancelled if watchdog is not None else None)
                with gate.lock:
                    if gate.abandoned:
                        raise DispatchDropped(f"{kind} dispatch abandoned before it started")
                    gate.started = True
                out = fn()
                if hook is not None:
                    hook("post", kind)
                return out

        attempt = 0
        while True:
            gate = types.SimpleNamespace(lock=make_lock(), started=False, abandoned=False)
            try:
                t0 = time.monotonic()
                out = (watchdog.run(lambda: call(gate)) if watchdog is not None
                       else call(gate))
                if straggler is not None and kind == "window":
                    if straggler.observe(time.monotonic() - t0):
                        stats["stragglers"] += 1
                return out
            except StepTimeout:
                stats["watchdog_timeouts"] += 1
                with gate.lock:
                    gate.abandoned = True
                    started = gate.started
                if started:
                    raise StepTimeout(
                        f"{kind} dispatch timed out after it began updating the "
                        "decode state in place; resume from a snapshot") from None
            except DispatchDropped:
                stats["dispatch_drops"] += 1
            attempt += 1
            stats["dispatch_retries"] += 1
            if attempt > max_retries:
                raise RuntimeError(f"{kind} dispatch failed after {max_retries} retries")
            time.sleep(backoff_s * (2 ** (attempt - 1)))

    # -- snapshot / restore ----------------------------------------------

    @staticmethod
    def _serve_meta(b, k_w, insert_window, n, seed):
        """A snapshot's compatibility vector: a restore must re-run the same
        serve, so everything that shapes its state and streams is pinned."""
        return np.asarray([b, k_w, insert_window, n, seed], np.int64)

    def _snapshot_serve(self, sess: "ServeSession"):
        """Save ``sess`` as ONE atomic tree: device state, slot table,
        queues, per-request progress and stats, through
        :func:`repro_torch.checkpoint.checkpoint.save` (or the session's
        :class:`~repro_torch.checkpoint.checkpoint.AsyncSaver`, which takes
        the host copy at once and writes in the background).  The ragged
        outputs go flat (``out_flat`` and ``out_off`` offsets).  No RNG
        state is saved: the sampling noise is a function of (seed, request,
        token index), which the restore re-derives."""
        out_off = np.zeros(sess.n + 1, np.int64)
        for i, o in enumerate(sess.outputs):
            out_off[i + 1] = out_off[i] + len(o)
        tree = {
            "device": {
                "state": sess.state, "cur": sess.cur, "lengths": sess.lengths,
                "counts": sess.counts, "budgets": sess.budgets,
                "req_ids": sess.req_ids, "active": sess.active,
            },
            "host": {
                "slot_req": np.asarray(sess.slot_req, np.int32),
                "pending": np.asarray(list(sess.pending), np.int32),
                "recover_q": np.asarray(list(sess.recover_q), np.int32),
                "out_flat": np.asarray([t for o in sess.outputs for t in o], np.int32),
                "out_off": out_off,
                "outcome_codes": np.asarray(
                    [-1 if oc is None else OUTCOMES.index(oc) for oc in sess.outcomes],
                    np.int32),
                "recoveries": np.asarray(sess.recoveries, np.int64),
                "corruptions": np.asarray(sess.corruptions, np.int64),
                "stats": np.asarray([sess.stats[k] for k in SERVE_STAT_KEYS], np.int64),
            },
            "meta": self._serve_meta(sess.b, sess.k_w, sess.insert_window, sess.n,
                                     sess.seed),
        }
        step = sess.stats["decode_dispatches"]
        if sess.saver is not None:
            sess.saver.save_async(sess.snapshot_dir, step, tree)
        else:
            C.save(sess.snapshot_dir, step, tree)

    def _restore_serve(self, sess: "ServeSession", restore_from):
        """Load the latest snapshot under ``restore_from`` into ``sess``,
        after checking that it was taken by the same serve (meta).  Device
        tensors come back through :func:`checkpoint.restore` against the
        session's fresh ones as the template; the host arrays are read from
        the snapshot's ``arrays.npz``."""
        step = C.latest_step(restore_from)
        if step is None:
            raise FileNotFoundError(f"no serve snapshot under {restore_from}")
        with np.load(Path(restore_from) / f"step_{step}" / "arrays.npz") as data:
            meta = data["meta"]
            host = {k.split("/", 1)[1]: data[k] for k in data.files
                    if k.startswith("host/")}
        want = self._serve_meta(sess.b, sess.k_w, sess.insert_window, sess.n, sess.seed)
        if not np.array_equal(meta, want):
            raise ValueError(
                f"snapshot meta {meta.tolist()} does not match this serve call "
                f"{want.tolist()}: a restore needs the same requests, slots, "
                "decode_window and seed")
        template = {"device": {
            "state": sess.state, "cur": sess.cur, "lengths": sess.lengths,
            "counts": sess.counts, "budgets": sess.budgets,
            "req_ids": sess.req_ids, "active": sess.active}}
        d = C.restore(restore_from, template, step=step)[0]["device"]
        (sess.state, sess.cur, sess.lengths, sess.counts, sess.budgets,
         sess.req_ids, sess.active) = (d[k] for k in (
             "state", "cur", "lengths", "counts", "budgets", "req_ids", "active"))
        off = host["out_off"]
        sess.outputs = [[int(t) for t in host["out_flat"][off[i]:off[i + 1]]]
                        for i in range(sess.n)]
        sess.outcomes = [None if c < 0 else OUTCOMES[c] for c in host["outcome_codes"]]
        sess.stats = {k: int(v) for k, v in zip(SERVE_STAT_KEYS, host["stats"])}
        sess.slot_req = [int(s) for s in host["slot_req"]]
        sess.pending = collections.deque(int(i) for i in host["pending"])
        sess.recover_q = collections.deque(int(i) for i in host["recover_q"])
        sess.recoveries = [int(r) for r in host["recoveries"]]
        sess.corruptions = [int(c) for c in host["corruptions"]]


class ServeSession:
    """One resumable continuous-batching serve (counterpart of the
    reference's ``ServeSession``): :meth:`ServeEngine.serve` is this object
    stepped to completion.  Each :meth:`step` is one scheduler iteration
    (deadline sweep, admission, one decode window), so a caller may
    interleave several sessions.

    Device tensors hold the slot pool (state, current token, lengths,
    counts, budgets, request ids, active bits); the host holds the queues,
    the per-request outputs and outcomes, and numpy mirrors of the slot
    table that it alone writes.  Deadlines count on ``clock`` from the
    session's creation; ``saver`` (an
    :class:`~repro_torch.checkpoint.checkpoint.AsyncSaver`) moves snapshot
    writes off the dispatch path.  The reference's ``external`` mode,
    shared clock origin, ``enqueue_handoff`` and checksum chain belong to
    the fleet, which is not ported yet.
    """

    @torch.inference_mode()
    def __init__(self, engine, requests, *, slots: int = 4,
                 temperature: float = 0.0, top_k: int = 0,
                 eos_id: int | None = None, seed: int = 0,
                 deadline_ms: float | None = None,
                 max_queue: int | None = None,
                 watchdog_timeout_s: float | None = None,
                 max_dispatch_retries: int = 3,
                 retry_backoff_s: float = 0.02,
                 snapshot_every: int = 0,
                 snapshot_dir: str | None = None,
                 restore_from: str | None = None,
                 chaos: Any = None,
                 recoverable: bool | None = None,
                 clock=time.monotonic,
                 saver: Any = None):
        eng = self.eng = engine
        self.temperature, self.top_k = float(temperature), int(top_k)
        self.eos_id, self.seed = eos_id, int(seed)
        self.deadline_ms = deadline_ms
        self.max_retries, self.backoff_s = max_dispatch_retries, retry_backoff_s
        self.snapshot_every, self.snapshot_dir = snapshot_every, snapshot_dir
        self.chaos, self.saver = chaos, saver
        self._clock = clock
        self.closed = False

        self.reqs = [r if hasattr(r, "tokens") else Request(tokens=r) for r in requests]
        n = self.n = len(self.reqs)
        b = self.b = max(1, min(int(slots), n)) if n else 1
        self.k_w = max(1, int(eng.decode_window))
        self.prompts = [np.asarray(r.tokens, np.int64).reshape(-1) for r in self.reqs]
        self.outputs: list[list[int]] = [[] for _ in range(n)]
        self.outcomes: list[str | None] = [None] * n
        self.recoveries = [0] * n
        self.corruptions = [0] * n
        self.stats = dict.fromkeys(SERVE_STAT_KEYS, 0)
        #: Requests that reached a terminal outcome, in completion order.
        self.newly_done: collections.deque[int] = collections.deque()
        for i, (r, p) in enumerate(zip(self.reqs, self.prompts)):
            if p.size < 1:
                raise ValueError("request prompt must be non-empty")
            if int(r.max_new_tokens) < 1:
                raise ValueError("max_new_tokens must be >= 1")
            if p.size + int(r.max_new_tokens) > eng.max_len:
                self._end(i, "shed", "shed")
        live = [i for i in range(n) if self.outcomes[i] is None]
        if recoverable is None:
            recoverable = (chaos is not None or restore_from is not None
                           or snapshot_every > 0)
        # A recovery re-prefills prompt plus accepted tokens in one window:
        # with recovery in play, the rings take the worst case (a request
        # quarantined on its last token).  Off it, the plain sizing, so
        # fault-free streams stay those of a plain serve.
        worst = max((self.prompts[i].size + (int(self.reqs[i].max_new_tokens)
                                              if recoverable else 0) for i in live),
                    default=1)
        self.insert_window = max(self.k_w, _bucket32(worst))
        self.state = eng._new_state(b, self.insert_window)
        dev = eng.device
        zeros = lambda dt: torch.zeros(b, dtype=dt, device=dev)  # noqa: E731
        self.lengths = zeros(torch.int64)
        self.counts = zeros(torch.int64)
        self.budgets = zeros(torch.int64)
        self.req_ids = zeros(torch.int64)
        self.active = zeros(torch.bool)
        self.cur = torch.zeros((b, 1), dtype=torch.int64, device=dev)
        self.pending = collections.deque(live)
        self.recover_q: collections.deque[int] = collections.deque()
        self.slot_req = [-1] * b
        self.active_np = np.zeros(b, bool)

        self.watchdog = (StepWatchdog(watchdog_timeout_s)
                         if watchdog_timeout_s is not None else None)
        self.straggler = StragglerDetector(warmup=1)
        self.t_origin = clock()
        self.any_deadline = deadline_ms is not None or any(
            getattr(r, "deadline_ms", None) is not None for r in self.reqs)

        if restore_from is not None:
            eng._restore_serve(self, restore_from)
            self.active_np = self.active.cpu().numpy().copy()
        elif max_queue is not None:
            # b requests admit at once, at most max_queue wait; the later
            # arrivals are shed, never queued without bound.
            cap = b + max(0, int(max_queue))
            while len(self.pending) > cap:
                self._end(self.pending.pop(), "shed", "shed")
        # Host mirrors (copies: on the CPU ``.numpy()`` would alias the tensors).
        self._budgets_np = self.budgets.cpu().numpy().copy()
        self._req_ids_np = self.req_ids.cpu().numpy().copy()

    # -- queue interface ---------------------------------------------------

    @property
    def busy(self) -> bool:
        """True while this session has queued or in-flight work."""
        return bool(self.pending or self.recover_q or self.active_np.any())

    def enqueue(self, ri: int):
        """Queue request ``ri`` (an index into the request list) again."""
        if self.outcomes[ri] is not None:
            raise ValueError(f"request {ri} already terminal ({self.outcomes[ri]})")
        self.pending.append(ri)

    def queue_depth(self) -> int:
        """Queued plus in-flight requests (a router's load signal)."""
        return len(self.pending) + len(self.recover_q) + int(self.active_np.sum())

    def recovery_debt_steps(self, window: int = 1) -> int:
        """Modeled steps the queued recoveries' re-prefills cost
        (:func:`repro_torch.core.cost_model.serve_recovery_steps`)."""
        return sum(cost_model.serve_recovery_steps(
            [self.prompts[ri].size], [len(self.outputs[ri])], 0, window=window)[0]
            for ri in self.recover_q)

    def drain_done(self) -> list[int]:
        """Pop the requests that ended since the last drain."""
        out = list(self.newly_done)
        self.newly_done.clear()
        return out

    # -- outcome helpers ---------------------------------------------------

    def _end(self, ri: int, outcome: str, stat: str | None = None):
        self.outcomes[ri] = outcome
        if stat is not None:
            self.stats[stat] += 1
        self.newly_done.append(ri)

    def _req_deadline(self, ri):
        d = getattr(self.reqs[ri], "deadline_ms", None)
        return self.deadline_ms if d is None else d

    def _resolve(self, ri):
        out = self.outputs[ri]
        if self.recoveries[ri] > 0:
            self._end(ri, "recovered")
        elif self.eos_id is not None and out and out[-1] == self.eos_id:
            self._end(ri, "eos")
        else:
            self._end(ri, "ok")

    def _free_slot(self, slot):
        self.slot_req[slot] = -1

    def _set_active(self):
        self.active = torch.from_numpy(self.active_np.copy()).to(self.eng.device)

    # -- the scheduler iteration -------------------------------------------

    @torch.inference_mode()
    def step(self):
        """One scheduler iteration: deadline sweep, admission (recoveries
        first), one decode window with its quarantine and chaos
        bookkeeping."""
        self._sweep_deadlines()
        self._admit()
        self._decode_window()

    def _sweep_deadlines(self):
        if not self.any_deadline:
            return
        now_ms = (self._clock() - self.t_origin) * 1e3
        killed = False
        for slot in np.nonzero(self.active_np)[0]:
            ri = self.slot_req[slot]
            dl = self._req_deadline(ri)
            if dl is not None and now_ms > dl:
                self._end(ri, "deadline", "deadline_hits")
                self.active_np[slot] = False
                self._free_slot(slot)
                killed = True
        if killed:
            self._set_active()
        for q in (self.recover_q, self.pending):
            for _ in range(len(q)):
                ri = q.popleft()
                dl = self._req_deadline(ri)
                if dl is not None and now_ms > dl:
                    self._end(ri, "deadline", "deadline_hits")
                else:
                    q.append(ri)

    def _dispatch(self, kind, fn):
        return self.eng._dispatch(
            kind, fn, chaos=self.chaos, watchdog=self.watchdog,
            straggler=self.straggler, stats=self.stats,
            max_retries=self.max_retries, backoff_s=self.backoff_s,
            index=self.stats["decode_dispatches"])

    def _admit(self):
        """Prefill the head of the queues (recoveries first) into the free
        slots with one masked window.  A recovery's prompt is its original
        prompt plus its accepted tokens, and it samples on at token index
        n, the number accepted."""
        eng, b, dev = self.eng, self.b, self.eng.device
        free = [i for i in range(b) if not self.active_np[i]]
        take = []
        while len(take) < len(free) and (self.recover_q or self.pending):
            take.append((self.recover_q or self.pending).popleft())
        if not take:
            return
        used = free[: len(take)]
        full = {ri: np.concatenate([self.prompts[ri], np.asarray(self.outputs[ri], np.int64)])
                for ri in take}
        p_b = _bucket32(max(full[ri].size for ri in take))
        tok_np = np.zeros((b, p_b), np.int64)
        admit_np = np.zeros(b, bool)
        plen_np = np.zeros(b, np.int64)
        tokidx_np = np.zeros(b, np.int64)
        for slot, ri in zip(used, take):
            tok_np[slot, : full[ri].size] = full[ri]
            admit_np[slot] = True
            plen_np[slot] = full[ri].size
            tokidx_np[slot] = len(self.outputs[ri])
            self._budgets_np[slot] = int(self.reqs[ri].max_new_tokens)
            self._req_ids_np[slot] = ri
            self.slot_req[slot] = ri
        up = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        self.budgets, self.req_ids = up(self._budgets_np.copy()), up(self._req_ids_np.copy())
        tokens, admit_row, plen, tok_idx = up(tok_np), up(admit_np), up(plen_np), up(tokidx_np)

        def admit():
            _reset_slot_rows(self.state, admit_row)
            mask = admit_row[:, None] & (torch.arange(p_b, device=dev)[None, :] < plen[:, None])
            with _prefill_rules(eng.mesh, p_b):
                logits, _ = M.decode_step(eng.params, eng.cfg, self.state, tokens, 0,
                                          token_mask=mask, last_only=True,
                                          max_len=eng.max_len)
            tok0 = _sample_tokens(logits[:, -1], self.seed, self.req_ids, tok_idx,
                                  self.temperature, self.top_k)
            lengths = torch.where(admit_row, plen, self.lengths)
            counts = torch.where(admit_row, tok_idx + 1, self.counts)
            done = counts >= self.budgets
            if self.eos_id is not None:
                done |= tok0 == self.eos_id
            active = torch.where(admit_row, ~done, self.active)
            cur = torch.where(admit_row[:, None], tok0[:, None], self.cur)
            host = torch.stack([tok0, active.long()]).cpu().numpy()
            return lengths, counts, active, cur, host

        self.lengths, self.counts, self.active, self.cur, host = self._dispatch("admit", admit)
        tok0_np, self.active_np = host[0], host[1].astype(bool)
        for slot, ri in zip(used, take):
            self.outputs[ri].append(int(tok0_np[slot]))
            if not self.active_np[slot]:          # done at admission
                self._resolve(ri)
                self._free_slot(slot)
        self.stats["admissions"] += 1

    def _window(self):
        """The K steps of one decode window over every slot.  Masked slots'
        states stay bit-identical.  A live slot whose state or logits go
        non-finite is quarantined at that step: it turns inactive before
        its token is emitted.  The flags stay on the card; the window's
        tokens, emit mask, quarantine mask and active bits come back in
        one host copy, the window's one synchronisation.  Returns the new
        (cur, lengths, counts, active) and that (2K + 2, B) array."""
        eng = self.eng
        cur, lengths, counts, active = self.cur, self.lengths, self.counts, self.active
        quar = torch.zeros_like(active)
        toks, emits = [], []
        for _ in range(self.k_w):
            logits, _ = M.decode_step(eng.params, eng.cfg, self.state, cur, lengths,
                                      token_mask=active[:, None], last_only=True,
                                      max_len=eng.max_len)
            lg = logits[:, -1]
            bad = active & ~(M.decode_state_finite(self.state)
                             & torch.isfinite(lg).all(dim=-1))
            quar |= bad
            active = active & ~bad
            nxt = _sample_tokens(lg, self.seed, self.req_ids, counts,
                                 self.temperature, self.top_k)
            emit = active
            lengths = lengths + emit.long()
            counts = counts + emit.long()
            done = counts >= self.budgets
            if self.eos_id is not None:
                done |= nxt == self.eos_id
            active = active & ~done
            cur = torch.where(emit[:, None], nxt[:, None], cur)
            toks.append(nxt)
            emits.append(emit.long())
        host = torch.cat([torch.stack(toks), torch.stack(emits),
                          quar.long()[None], active.long()[None]]).cpu().numpy()
        return cur, lengths, counts, active, host

    def _decode_window(self):
        if not self.active_np.any():
            return
        k, idx = self.k_w, self.stats["decode_dispatches"]
        if self.chaos is not None:
            self.state, _ = self.chaos.maybe_poison(self.state, self.active_np, idx,
                                                    self.slot_req)
            self.state, _ = self.chaos.maybe_bitflip(self.state, self.active_np, idx,
                                                     self.slot_req)
        self.cur, self.lengths, self.counts, self.active, host = self._dispatch(
            "window", self._window)
        toks_np, emits_np = host[:k], host[k:2 * k].astype(bool)
        quar_np = host[2 * k].astype(bool)
        for step in range(k):
            for slot in np.nonzero(emits_np[step])[0]:
                self.outputs[self.slot_req[slot]].append(int(toks_np[step, slot]))
        prev_active, self.active_np = self.active_np, host[2 * k + 1].astype(bool)
        self.stats["decode_dispatches"] += 1
        self.stats["slot_steps"] += k * self.b
        # Quarantined slots: the victim re-prefills from its accepted prefix.
        for slot in np.nonzero(quar_np)[0]:
            ri = self.slot_req[slot]
            self.stats["quarantines"] += 1
            self.stats["recoveries"] += 1
            self.recoveries[ri] += 1
            self.recover_q.append(ri)
            self._free_slot(slot)
        for slot in np.nonzero(prev_active & ~self.active_np & ~quar_np)[0]:
            self._resolve(self.slot_req[slot])
            self._free_slot(slot)
        if self.chaos is not None:
            slot = self.chaos.maybe_drop_request(
                self.active_np, self.stats["decode_dispatches"], self.slot_req)
            if slot is not None:
                self._end(self.slot_req[slot], "dropped", "req_drops")
                self.active_np[slot] = False
                self._free_slot(slot)
                self._set_active()
        if (self.snapshot_every > 0 and self.snapshot_dir is not None
                and self.stats["decode_dispatches"] % self.snapshot_every == 0):
            self.snapshot_now()
        if self.chaos is not None:
            self.chaos.check_preempt(self.stats["decode_dispatches"])
            self.chaos.check_replica_kill(self.stats["decode_dispatches"])

    def _corrupted(self, slot: int, rollback: int):
        """Quarantine ``slot`` for corruption a checksum found: drop the
        ``rollback`` tokens computed from bad bits, free the slot, and
        requeue the request for recovery, or end it ``corrupt`` past
        :data:`MAX_CORRUPTION_RECOVERIES`.  The caller refreshes the
        device's active bits.  (The checksum chain that calls this in the
        reference comes with the fleet.)"""
        ri = self.slot_req[slot]
        self.stats["corruptions"] += 1
        self.stats["quarantines"] += 1
        self.corruptions[ri] += 1
        if rollback:
            del self.outputs[ri][len(self.outputs[ri]) - rollback:]
        self.active_np[slot] = False
        self._free_slot(slot)
        if self.corruptions[ri] > MAX_CORRUPTION_RECOVERIES:
            self._end(ri, "corrupt")
        else:
            self.stats["recoveries"] += 1
            self.recoveries[ri] += 1
            self.recover_q.append(ri)

    # -- snapshot / teardown -----------------------------------------------

    def snapshot_now(self):
        self.eng._snapshot_serve(self)
        self.stats["snapshots"] += 1

    def close(self):
        """Finish: wait for a background snapshot and publish the stats and
        the final state on the engine.  Idempotent; ``serve`` calls it in
        ``finally`` position, so a preempted serve still leaves its stats."""
        if self.closed:
            return
        self.closed = True
        if self.saver is not None:
            self.saver.wait()
        self.eng.last_serve_stats = self.stats
        self.eng.last_state = self.state

    def results(self) -> list[RequestResult]:
        for i in range(self.n):
            if self.outcomes[i] is None:
                self._resolve(i)
        return [RequestResult(tokens=np.asarray(o, np.int32), outcome=oc, recoveries=r)
                for o, oc, r in zip(self.outputs, self.outcomes, self.recoveries)]
