"""Serving: prompt scoring (``make_prefill_step``), cache prefill, one
decode window (``make_decode_step``), a lockstep greedy ``generate`` and a
continuous-batching ``serve`` (counterpart of ``repro.serve.engine``).
The encoder-decoder arch scores through ``make_prefill_step`` with its
frames and decodes through ``make_decode_step`` with the encoder's
output; ``ServeEngine`` refuses it.

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
Chaos injection (:mod:`repro_torch.serve.chaos`) drills all of it.  A
``paged`` engine stores the KV caches in page pools behind per-slot page
tables (:mod:`repro_torch.serve.paging`), and admits a request that
extends a registered prefix (:meth:`ServeEngine.register_prefix`) by
sharing or copying the prefix's state instead of prefilling it again.
``checksum_every`` arms the silent-corruption checksum chain, and
:class:`ServeSession` is the engine-side half of a fleet replica
(:mod:`repro_torch.serve.fleet`).

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
from repro_torch.model.attention import KVCache, PagedKVCache
from repro_torch.model.sharding import is_sharded, make_rules, sharding_context, smap
from repro_torch.serve import paging
from repro_torch.serve.chaos import DispatchDropped
from repro_torch.tree import tree_leaves

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
    """``(params, tokens (B, S), **extras) -> logits (B, S, V)``: prompt
    scoring through the cache-free :func:`~repro_torch.model.model.forward`
    (``extras``: its ``positions``, ``frontend_embeds`` and, for the
    encoder-decoder arch, ``enc_tokens_embeds``, the frames).

    ``cfg.prefill_chunks = n > 1`` scores the batch in n sequential chunks
    of B / n sequences, as the reference's ``lax.scan`` does, bounding the
    live activations and the MoE dispatch; with ``n <= 1`` or B not a
    multiple of n the batch goes through one forward.  Sequences are
    independent, but an MoE layer's capacity counts the tokens of its call,
    so for the MoE archs the chunked logits are the reference's chunked
    ones, not the one-forward ones.

    With sharded parameters (under a prefill sharding context) each chunk
    runs the sharded forward and the logits come back as one
    :class:`~repro_torch.model.sharding.Sharded` tensor (n, B / n, S, V),
    chunk by chunk as the reference's scan stacks them, every chunk split
    over the data axis and the vocabulary over the model axis."""

    def chunks(params, tokens, kw, n):
        """Each of the ``n`` chunks' logits, in order."""
        c = tokens.shape[0] // n

        def part(key, v, i):
            if key == "positions" and v.ndim == 3 and v.shape[0] == 3:
                return v[:, i * c:(i + 1) * c]
            return v[i * c:(i + 1) * c]

        for i in range(n):
            yield M.forward(params, cfg, tokens[i * c:(i + 1) * c],
                            **{key: part(key, v, i) for key, v in kw.items()})

    def prefill_step(params, tokens, **kw):
        n, b = cfg.prefill_chunks, tokens.shape[0]
        if is_sharded(tree_leaves(params)[0]):
            outs = list(chunks(params, tokens, kw, n if n > 1 and b % n == 0 else 1))
            return smap(lambda *ls: torch.stack(ls), *outs, dims=((),) + outs[0].dims)
        if n <= 1 or b % n:
            return M.forward(params, cfg, tokens, **kw)
        c = b // n
        out = None
        for i, logits in enumerate(chunks(params, tokens, kw, n)):
            if out is None:
                out = logits.new_empty((b,) + logits.shape[1:])
            out[i * c:(i + 1) * c] = logits
            del logits
        return out

    return prefill_step


def make_seq_prefill_step(cfg, mesh, *, min_len: int = SEQ_PREFILL_MIN_T):
    """Long-context prompt scoring: :func:`make_prefill_step` under the
    ``prefill_seq`` rules of ``mesh`` for prompts of at least ``min_len``
    tokens, so each RWKV layer sweeps every sequence shard with the summary
    kernel and only the O(Dh²) (decay, state) summaries cross the ``seq``
    axis.  Shorter prompts run under the plain ``prefill`` rules."""
    base = make_prefill_step(cfg)

    def prefill_step(params, tokens, **kw):
        with _prefill_rules(mesh, tokens.shape[1], min_len):
            return base(params, tokens, **kw)

    return prefill_step


def make_decode_step(cfg):
    """``(params, state, tokens (B, K), length, enc_out=None) -> (logits,
    state)``: one :func:`~repro_torch.model.model.decode_step` window, K >= 1
    (K == 1 is classic per-token decode).  ``enc_out`` (B, S, D) from
    :func:`~repro_torch.model.model.encode` is what an encoder-decoder
    arch's decoder cross-attends to; this is the engine's one entry that
    decodes such an arch."""

    def decode_step(params, state, tokens, length, enc_out=None):
        return M.decode_step(params, cfg, state, tokens, length, enc_out=enc_out)

    return decode_step


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
    #: Paged engines only: an id from :meth:`ServeEngine.register_prefix`.
    #: The prompt must extend that prefix; its page-aligned head is
    #: admitted by sharing or copying the prefix's state, not prefilled.
    prefix_id: int | None = None


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
    the weighted sum).  A paged node's rows are unmapped and their lengths
    zeroed; the pool keeps its contents (pages are shared storage, and a
    page is scrubbed when it is next mapped)."""
    for node in M.state_nodes(state):
        if isinstance(node, PagedKVCache):
            stacked = node.page_table.ndim - 2
            m = rows.reshape((1,) * stacked + (-1,))
            node.page_table.masked_fill_(m[..., None], -1)
            node.length.masked_fill_(m, 0)
            continue
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

    ``paged`` makes ``serve`` keep its KV caches in page pools with
    per-slot page tables (:mod:`repro_torch.serve.paging`): ``page_size``
    tokens a page (a multiple of the 32-token admission bucket),
    ``pool_pages`` allocatable private pages per pool (``None``: the
    dense-equivalent count, which never starves).  After a paged serve
    ``last_paged_stats`` holds its byte accounting and audit result.
    """

    cfg: Any
    params: Any
    max_len: int = 256
    decode_window: int = 8
    device: Any = None
    mesh: Any = None
    paged: bool = False
    page_size: int = 32
    pool_pages: int | None = None

    def __post_init__(self):
        if self.paged:
            if self.page_size < 32 or self.page_size % 32:
                raise ValueError(
                    f"page_size must be a positive multiple of the 32-token "
                    f"admit bucket, got {self.page_size}")
            if self.mesh is not None:
                raise NotImplementedError("paged serving does not compose with a mesh yet")
        if self.cfg.is_enc_dec:
            raise ValueError(
                f"{self.cfg.name} is an encoder-decoder arch: ServeEngine has no "
                "encoder-decoder path (its windows would run the decoder without "
                "the encoder's frames); decode with make_decode_step(cfg) and "
                "model.encode's enc_out")
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
        self.last_paged_stats: dict[str, int] = {}
        # Prefix registry: id -> tokens; entries cache the one batch-1
        # prefill of a prefix's page-aligned head per insert window.
        self._prefixes: dict[int, np.ndarray] = {}
        self._prefix_entries: dict = {}
        self._null_entries: dict = {}
        self._next_prefix_id = 0

    def _new_state(self, batch: int, insert_window: int, paged=None):
        return M.init_decode_state(self.cfg, batch, self.max_len, insert_window, paged,
                                   device=self.device)

    # ------------------------------------------------------------------
    # Prefix sharing (paged engines)
    # ------------------------------------------------------------------

    def register_prefix(self, tokens) -> int:
        """Register a shared prompt prefix; returns an id for
        :attr:`Request.prefix_id`.  Its page-aligned head
        (``floor(len / page_size) * page_size`` tokens) is prefilled once
        per serve, and every request carrying the id is admitted by
        sharing its KV pages (nodes that never wrap) or copying its ring
        content and recurrent states (wrapping local rings, WKV S, RG-LRU
        h) instead of prefilling those tokens.  Prompts must extend it."""
        if not self.paged:
            raise ValueError("prefix sharing requires a paged engine")
        toks = np.asarray(tokens, np.int64).reshape(-1)
        if toks.size < self.page_size:
            raise ValueError(f"prefix of {toks.size} tokens is shorter than one "
                             f"{self.page_size}-token page: nothing to share")
        if toks.size >= self.max_len:
            raise ValueError(f"prefix of {toks.size} tokens leaves no room to decode "
                             f"within max_len={self.max_len}")
        pid = self._next_prefix_id
        self._next_prefix_id += 1
        self._prefixes[pid] = toks
        return pid

    def _prefix_entry(self, pid: int, insert_window: int):
        """(start_len, recurrent nodes, per-KV-node dense (k, v) views) of
        a registered prefix: one batch-1 dense prefill of its page-aligned
        head, cached per (prefix, insert window), which every admission of
        the prefix copies from."""
        key = (pid, insert_window)
        ent = self._prefix_entries.get(key)
        if ent is None:
            toks = self._prefixes[pid]
            start = (toks.size // self.page_size) * self.page_size
            st = self._new_state(1, insert_window)
            head = torch.from_numpy(toks[:start]).to(self.device)[None]
            self._prefill(self.params, st, head)
            rec, kv = paging.split_entry(st)
            ent = self._prefix_entries[key] = (start, rec, kv)
        return ent

    def _null_entry(self, insert_window: int):
        """Zero prefix-entry operands for an admission that carries no
        prefix (every use is gated on its prefix rows)."""
        ent = self._null_entries.get(insert_window)
        if ent is None:
            ent = self._null_entries[insert_window] = paging.split_entry(
                self._new_state(1, insert_window))
        return ent

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
              recoverable: bool | None = None,
              checksum_every: int = 0):
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
          requests, slots, window and seed) bit-identically;
        * ``checksum_every`` > 0 arms silent-corruption detection: every
          dispatch checksums each slot's state on entry and on exit
          (:func:`repro_torch.model.model.decode_state_checksum`), the host
          chains exit(n) == entry(n + 1), so a finite but wrong bit flip
          breaks the chain at the next window, and a shadow recompute
          checks the state every N windows; a mismatched slot is
          quarantined, its unverified window tokens are rolled back and it
          re-admits from its last verified prefix (``recovered``, or
          ``corrupt`` past :data:`MAX_CORRUPTION_RECOVERIES`).  At 0 no
          checksum is computed: a window issues the ops it issues without
          the chain.

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
            chaos=chaos, recoverable=recoverable, checksum_every=checksum_every)
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

    def _serve_meta(self, b, k_w, insert_window, n, seed, ctl):
        """A snapshot's compatibility vector: a restore must re-run the same
        serve, so everything that shapes its state and streams is pinned,
        paging included."""
        return np.asarray(
            [b, k_w, insert_window, n, seed, int(ctl is not None), self.page_size,
             -1 if self.pool_pages is None else int(self.pool_pages),
             0 if ctl is None else ctl.shared_total], np.int64)

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
        # The controller's owner arrays and high-water mark ride the same
        # atomic tree; the device page tables are in ``state``.
        pg = {} if sess.ctl is None else {
            "pg_" + k: v for k, v in sess.ctl.snapshot_tree().items()}
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
                **pg,
            },
            "meta": self._serve_meta(sess.b, sess.k_w, sess.insert_window, sess.n,
                                     sess.seed, sess.ctl),
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
        want = self._serve_meta(sess.b, sess.k_w, sess.insert_window, sess.n, sess.seed,
                                sess.ctl)
        if not np.array_equal(meta, want):
            raise ValueError(
                f"snapshot meta {meta.tolist()} does not match this serve call "
                f"{want.tolist()}: a restore needs the same requests, slots, "
                "decode_window, seed and paging config")
        if sess.ctl is not None:
            sess.ctl.restore({k[3:]: v for k, v in host.items() if k.startswith("pg_")})
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
    writes off the dispatch path.  On a paged engine the session owns a
    :class:`~repro_torch.serve.paging.PagedController`: an admission waits
    at the head of the queue while the pool is short of pages
    (``page_waits``), a request no empty pool could hold is shed, and
    :meth:`close` audits the page tables into the engine's
    ``last_paged_stats``.

    A :class:`~repro_torch.serve.fleet.FleetRouter` builds one session per
    replica engine and interleaves their steps.  ``external=True`` starts
    the local queue empty: the session still sees the whole request list
    (slot shapes, request ids, the insert window and the snapshot meta are
    then the same on every replica, which is what makes a stream
    independent of its replica and a snapshot a handoff source), but a
    request enters only through :meth:`enqueue` (the router's assignment)
    or :meth:`enqueue_handoff` (a resume from a dead replica's snapshot),
    and the requests shed at creation are still reported through
    ``newly_done``.  ``clock_origin`` anchors the deadlines: a router
    passes one origin to every session, so a deadline counts the time a
    request waited in the shared queue.  ``checksum_every`` > 0 arms the
    checksum chain (see :meth:`ServeEngine.serve`): the entry and exit
    checksums ride the dispatch's one host copy as two more rows, and the
    shadow recompute every ``checksum_every`` windows runs outside any
    dispatch (``checksum_spot_checks``).
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
                 checksum_every: int = 0,
                 clock=time.monotonic,
                 clock_origin: float | None = None,
                 external: bool = False,
                 saver: Any = None):
        eng = self.eng = engine
        self.temperature, self.top_k = float(temperature), int(top_k)
        self.eos_id, self.seed = eos_id, int(seed)
        self.deadline_ms = deadline_ms
        self.max_retries, self.backoff_s = max_dispatch_retries, retry_backoff_s
        self.snapshot_every, self.snapshot_dir = snapshot_every, snapshot_dir
        self.chaos, self.saver = chaos, saver
        self.checksum_every = int(checksum_every)
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
        ps = int(eng.page_size)
        #: Per request: its prefix id and the start length its admission
        #: prefills from (None and 0 without a prefix).
        self.pid_of: list[int | None] = [None] * n
        self.start_of = [0] * n
        for i, (r, p) in enumerate(zip(self.reqs, self.prompts)):
            if p.size < 1:
                raise ValueError("request prompt must be non-empty")
            if int(r.max_new_tokens) < 1:
                raise ValueError("max_new_tokens must be >= 1")
            pid = getattr(r, "prefix_id", None)
            if pid is not None:
                if not eng.paged:
                    raise ValueError("Request.prefix_id requires a paged engine")
                pre = eng._prefixes.get(pid)
                if pre is None:
                    raise ValueError(f"unknown prefix id {pid}")
                if p.size < pre.size or not np.array_equal(p[:pre.size], pre):
                    raise ValueError(f"request {i}: prompt does not extend registered "
                                     f"prefix {pid}")
                start = (pre.size // ps) * ps
                if p.size > start:
                    self.pid_of[i], self.start_of[i] = pid, start
                # Else the prompt is the page-aligned prefix itself, with no
                # suffix token to prefill from: it is admitted cold.
            if p.size + int(r.max_new_tokens) > eng.max_len:
                self._end(i, "shed", "shed")
        live = [i for i in range(n) if self.outcomes[i] is None]
        if recoverable is None:
            recoverable = (chaos is not None or restore_from is not None
                           or snapshot_every > 0 or external)
        # A recovery re-prefills prompt plus accepted tokens in one window:
        # with recovery in play, the rings take the worst case (a request
        # quarantined on its last token).  Off it, the plain sizing, so
        # fault-free streams stay those of a plain serve.
        worst = max((self.prompts[i].size + (int(self.reqs[i].max_new_tokens)
                                              if recoverable else 0) for i in live),
                    default=1)
        self.insert_window = max(self.k_w, _bucket32(worst))
        self.ctl = None
        if eng.paged:
            self._paged_setup(live)
        else:
            self.state = eng._new_state(b, self.insert_window)
        dev = eng.device
        zeros = lambda dt: torch.zeros(b, dtype=dt, device=dev)  # noqa: E731
        self.lengths = zeros(torch.int64)
        self.counts = zeros(torch.int64)
        self.budgets = zeros(torch.int64)
        self.req_ids = zeros(torch.int64)
        self.active = zeros(torch.bool)
        self.cur = torch.zeros((b, 1), dtype=torch.int64, device=dev)
        self.pending = collections.deque(
            () if external else (i for i in live if self.outcomes[i] is None))
        self.recover_q: collections.deque[int] = collections.deque()
        self.slot_req = [-1] * b
        self.active_np = np.zeros(b, bool)

        self.watchdog = (StepWatchdog(watchdog_timeout_s)
                         if watchdog_timeout_s is not None else None)
        self.straggler = StragglerDetector(warmup=1)
        self.t_origin = clock_origin if clock_origin is not None else clock()
        self.any_deadline = deadline_ms is not None or any(
            getattr(r, "deadline_ms", None) is not None for r in self.reqs)
        # The checksum chain: after a dispatch, each slot's exit checksum,
        # which the next dispatch's entry checksum must equal.
        self._csum_base = np.zeros(b, np.int64)
        self._csum_have = False
        self._since_spot = 0

        if restore_from is not None:
            eng._restore_serve(self, restore_from)
            self.active_np = self.active.cpu().numpy().copy()
        elif max_queue is not None and not external:
            # b requests admit at once, at most max_queue wait; the later
            # arrivals are shed, never queued without bound.
            cap = b + max(0, int(max_queue))
            while len(self.pending) > cap:
                self._end(self.pending.pop(), "shed", "shed")
        # Host mirrors (copies: on the CPU ``.numpy()`` would alias the tensors).
        self._budgets_np = self.budgets.cpu().numpy().copy()
        self._req_ids_np = self.req_ids.cpu().numpy().copy()

    def _paged_setup(self, live):
        """The paged state and its controller: one shared-page region per
        registered prefix in use (each prefix's aligned head prefilled once,
        cached on the engine, and written into every "share" pool before
        any admission); a request no empty pool could hold is shed."""
        eng, ps = self.eng, int(self.eng.page_size)
        shared_map, entries, nxt = {}, {}, 1
        for pid in sorted({self.pid_of[i] for i in live if self.pid_of[i] is not None}):
            start, rec, kv = eng._prefix_entry(pid, self.insert_window)
            shared_map[pid] = (nxt, start // ps)
            nxt += start // ps
            entries[pid] = (rec, kv)
        spec = M.PageSpec(page_size=ps, private_pages=eng.pool_pages, shared_pages=nxt - 1)
        self.state = eng._new_state(self.b, self.insert_window, spec)
        self.ctl = paging.PagedController(eng.cfg, self.state, batch=self.b,
                                          max_len=eng.max_len, shared_map=shared_map)
        if entries:
            paging.upload_shared(self.state, self.ctl, entries)
        for i in live:
            if not self.ctl.fits_capacity(
                    self.prompts[i].size + int(self.reqs[i].max_new_tokens), self.start_of[i]):
                # More private pages than the pool ever has: waiting cannot
                # help, so shed it rather than deadlock.
                self._end(i, "shed", "shed")

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

    def enqueue_handoff(self, ri: int, accepted):
        """Resume request ``ri`` from another replica's snapshot: seed its
        output with the ``accepted`` tokens and queue it for recovery (a
        re-prefill of prompt plus accepted tokens).  The sampling noise is
        keyed on (request, token index), so the continuation is the stream
        the dead replica was producing."""
        self.outputs[ri] = [int(t) for t in accepted]
        self.outcomes[ri] = None
        self.recoveries[ri] += 1
        self.stats["recoveries"] += 1
        self.recover_q.append(ri)

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
        if self.ctl is not None:
            self.ctl.free_slot(slot)

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

    def _take(self, free):
        """Pop the requests to admit into ``free`` slots, head of the
        queues first (recoveries before new requests).  On a paged engine
        each reserves its pages first: the head waits while the pool is
        short (``page_waits``; it is never skipped), and one admission
        carries at most one prefix.  Returns (requests, their table and
        scrub rows by slot, the admission's prefix id or None)."""
        ctl = self.ctl
        take: list[int] = []
        alloc: dict[int, tuple] = {}
        group_pid = None
        while len(take) < len(free) and (self.recover_q or self.pending):
            q = self.recover_q if self.recover_q else self.pending
            ri = q[0]
            if ctl is not None:
                pid = self.pid_of[ri]
                if pid is not None:
                    if group_pid is None:
                        group_pid = pid
                    elif pid != group_pid:
                        break                     # a second prefix waits a round
                got = ctl.try_admit(free[len(take)],
                                    self.prompts[ri].size + int(self.reqs[ri].max_new_tokens),
                                    pid, self.start_of[ri])
                if got is None:
                    self.stats["page_waits"] += 1
                    break
                alloc[free[len(take)]] = got
            q.popleft()
            take.append(ri)
        return take, alloc, group_pid

    def _paging_operands(self, used, alloc, group_pid, start_np):
        """The paged admission's device operands.  Every node's table and
        scrub rows, the start lengths and the prefix rows go to the device
        in one copy; the prefix entry (or the zero entry) is already
        there."""
        ctl, b = self.ctl, self.b
        blocks = [start_np.astype(np.int32), (start_np > 0).astype(np.int32)]
        for i, g in enumerate(ctl.geoms):
            rows = np.full((2, b, g.nl), -1, np.int32)
            for slot in used:
                rows[0, slot], rows[1, slot] = alloc[slot][0][i], alloc[slot][1][i]
            blocks.append(rows.reshape(-1))
        packed = torch.from_numpy(np.concatenate(blocks)).to(self.eng.device)
        start, prefix_rows = packed[:b], packed[b:2 * b].bool()
        tables, scrubs, off = [], [], 2 * b
        for g in ctl.geoms:
            n = b * g.nl
            tables.append(packed[off:off + n].view(b, g.nl))
            scrubs.append(packed[off + n:off + 2 * n].view(b, g.nl))
            off += 2 * n
        if group_pid is not None:
            _, rec, kv = self.eng._prefix_entry(group_pid, self.insert_window)
        else:
            rec, kv = self.eng._null_entry(self.insert_window)
        ring = [kv[i] for i, role in enumerate(ctl.roles) if role == "copy"]
        return start, prefix_rows, tables, scrubs, rec, ring

    def _admit(self):
        """Prefill the head of the queues (recoveries first) into the free
        slots with one masked window.  A recovery's prompt is its original
        prompt plus its accepted tokens, and it samples on at token index
        n, the number accepted.  On a paged engine only the suffix past a
        request's prefix start is prefilled, from that start: the prefix
        rides in as shared pages and copied state."""
        eng, b, dev = self.eng, self.b, self.eng.device
        free = [i for i in range(b) if not self.active_np[i]]
        take, alloc, group_pid = self._take(free)
        if not take:
            return
        used = free[: len(take)]
        full = {ri: np.concatenate([self.prompts[ri], np.asarray(self.outputs[ri], np.int64)])
                for ri in take}
        p_b = _bucket32(max(full[ri].size - self.start_of[ri] for ri in take))
        tok_np = np.zeros((b, p_b), np.int64)
        admit_np = np.zeros(b, bool)
        plen_np = np.zeros(b, np.int64)
        tokidx_np = np.zeros(b, np.int64)
        start_np = np.zeros(b, np.int64)
        for slot, ri in zip(used, take):
            sfx = full[ri][self.start_of[ri]:]
            tok_np[slot, : sfx.size] = sfx
            admit_np[slot] = True
            plen_np[slot] = sfx.size
            start_np[slot] = self.start_of[ri]
            tokidx_np[slot] = len(self.outputs[ri])
            self._budgets_np[slot] = int(self.reqs[ri].max_new_tokens)
            self._req_ids_np[slot] = ri
            self.slot_req[slot] = ri
            if self.start_of[ri] > 0:
                self.stats["prefix_admissions"] += 1
        up = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        self.budgets, self.req_ids = up(self._budgets_np.copy()), up(self._req_ids_np.copy())
        tokens, admit_row, plen, tok_idx = up(tok_np), up(admit_np), up(plen_np), up(tokidx_np)
        pg = None if self.ctl is None else self._paging_operands(used, alloc, group_pid,
                                                                 start_np)

        chain = self.checksum_every > 0

        def admit():
            if chain:
                # The state as handed to this dispatch, before any write.
                csum_in = M.decode_state_checksum(self.state)
            _reset_slot_rows(self.state, admit_row)
            start = 0
            if pg is not None:
                start, prefix_rows, tables, scrubs, rec, ring = pg
                paging.apply_admission(self.state, self.ctl.roles, admit_row, prefix_rows,
                                       start, tables, scrubs, rec, ring)
            mask = admit_row[:, None] & (torch.arange(p_b, device=dev)[None, :] < plen[:, None])
            with _prefill_rules(eng.mesh, p_b):
                logits, _ = M.decode_step(eng.params, eng.cfg, self.state, tokens, start,
                                          token_mask=mask, last_only=True,
                                          max_len=eng.max_len)
            tok0 = _sample_tokens(logits[:, -1], self.seed, self.req_ids, tok_idx,
                                  self.temperature, self.top_k)
            lengths = torch.where(admit_row, plen + start, self.lengths)
            counts = torch.where(admit_row, tok_idx + 1, self.counts)
            done = counts >= self.budgets
            if self.eos_id is not None:
                done |= tok0 == self.eos_id
            active = torch.where(admit_row, ~done, self.active)
            cur = torch.where(admit_row[:, None], tok0[:, None], self.cur)
            rows = [tok0, active.long()]
            if chain:
                rows += [csum_in, M.decode_state_checksum(self.state)]
            host = torch.stack(rows).cpu().numpy()
            return lengths, counts, active, cur, host

        self.lengths, self.counts, self.active, self.cur, host = self._dispatch("admit", admit)
        tok0_np, self.active_np = host[0], host[1].astype(bool)
        if chain:
            # The rows this admission did not touch kept their state through
            # it: a mismatch means their bits changed between dispatches.
            self._chain_check(host[2], skip=admit_np, emits_np=None)
            self._csum_base = host[3].copy()
            self._csum_have = True
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
        (cur, lengths, counts, active) and that (2K + 2, B) array; with the
        checksum chain on, the entry and exit checksums are two more
        rows."""
        eng = self.eng
        chain = self.checksum_every > 0
        if chain:
            csum_in = M.decode_state_checksum(self.state)
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
        rows = [torch.stack(toks), torch.stack(emits), quar.long()[None], active.long()[None]]
        if chain:
            rows += [csum_in[None], M.decode_state_checksum(self.state)[None]]
        host = torch.cat(rows).cpu().numpy()
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
        corrupt_np = np.zeros(self.b, bool)
        if self.checksum_every > 0:
            # This window's entry must equal the last dispatch's exit; the
            # slots quarantined in the window recover by the NaN path.
            corrupt_np = self._chain_check(host[2 * k + 2], skip=quar_np, emits_np=emits_np)
            self._csum_base = host[2 * k + 3].copy()
            self._csum_have = True
        # Quarantined slots: the victim re-prefills from its accepted prefix.
        for slot in np.nonzero(quar_np)[0]:
            ri = self.slot_req[slot]
            self.stats["quarantines"] += 1
            self.stats["recoveries"] += 1
            self.recoveries[ri] += 1
            self.recover_q.append(ri)
            self._free_slot(slot)
        # Completions: a corrupt slot's completion was computed from bad bits
        # (it requeued instead), and a slot the chain freed holds no request.
        for slot in np.nonzero(prev_active & ~self.active_np & ~quar_np & ~corrupt_np)[0]:
            ri = self.slot_req[slot]
            if ri >= 0:
                self._resolve(ri)
                self._free_slot(slot)
        if self.chaos is not None:
            slot = self.chaos.maybe_drop_request(
                self.active_np, self.stats["decode_dispatches"], self.slot_req)
            if slot is not None:
                self._end(self.slot_req[slot], "dropped", "req_drops")
                self.active_np[slot] = False
                self._free_slot(slot)
                self._set_active()
        if self.checksum_every > 0:
            self._since_spot += 1
            if self._since_spot >= self.checksum_every:
                self._spot_check()
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
        device's active bits."""
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

    def _chain_check(self, entry_np, *, skip, emits_np):
        """Hold a dispatch's entry checksums (B,) to the previous
        dispatch's exit checksums, except in the ``skip`` rows (admitted
        rows, rows quarantined in the window) and free slots.  For a window,
        ``emits_np`` (K, B) rolls back the tokens it emitted from bad bits.
        Returns the (B,) bool mask of corrupt slots."""
        corrupt = np.zeros(self.b, bool)
        if not self._csum_have:
            return corrupt
        for slot in range(self.b):
            if skip[slot] or self.slot_req[slot] < 0 or entry_np[slot] == self._csum_base[slot]:
                continue
            corrupt[slot] = True
            self._corrupted(slot, int(emits_np[:, slot].sum()) if emits_np is not None else 0)
        if corrupt.any():
            self._set_active()
        return corrupt

    def _spot_check(self):
        """Shadow recompute, outside any dispatch: checksum the live state
        again and hold it to the last exit checksums.  The chain sees bits
        flipped between dispatches; this sees a flip after the last exit
        (and an exit checksum that lies)."""
        self._since_spot = 0
        if not self._csum_have:
            return
        self.stats["checksum_spot_checks"] += 1
        shadow = M.decode_state_checksum(self.state).cpu().numpy()
        bad = False
        for slot in range(self.b):
            if self.slot_req[slot] >= 0 and shadow[slot] != self._csum_base[slot]:
                self._corrupted(slot, rollback=0)
                bad = True
        if bad:
            self._set_active()
        self._csum_base = shadow.copy()

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
        if self.ctl is not None:
            self.ctl.audit(self.state, self.active_np, self.slot_req)
            self.eng.last_paged_stats = {
                "page_size": int(self.eng.page_size),
                "shared_pages": self.ctl.shared_total,
                "pool_bytes": self.ctl.pool_bytes(),
                "dense_bytes": self.ctl.dense_bytes(),
                "peak_mapped_bytes": self.ctl.peak_mapped_bytes,
                "page_table_violations": len(self.ctl.violations),
            }

    def results(self) -> list[RequestResult]:
        for i in range(self.n):
            if self.outcomes[i] is None:
                self._resolve(i)
        return [RequestResult(tokens=np.asarray(o, np.int32), outcome=oc, recoveries=r)
                for o, oc, r in zip(self.outputs, self.outcomes, self.recoveries)]


def audit_dispatch_entrypoints(cfg, *, device=None, batch: int = 2, max_len: int = 64,
                               decode_window: int = 4, prompt: int = 5, params=None):
    """Registration hook for :mod:`repro_torch.analysis.donation`: every
    dispatch of the engine that updates a decode state, with a closure
    that builds a tiny engine and state of ``cfg`` on ``device`` (``None``:
    the card; ``params``, or random parameters from seed 0, and ``batch``
    requests of ``prompt`` tokens) and runs the dispatch once.

    Adding a dispatch to the engine means adding it here: the donation
    pass audits exactly this list, and the fleet pass errs on a dispatch
    kind a replica issues that no entry covers.  An encoder-decoder arch
    has none (:class:`ServeEngine` refuses it)."""
    from repro_torch.analysis.donation import DispatchEntry

    if cfg.is_enc_dec:
        return []
    here = "src/repro_torch/serve/engine.py"
    k = max(1, decode_window)
    built: dict = {} if params is None else {"params": params}

    def engine(paged: bool) -> ServeEngine:
        if "params" not in built:
            built["params"] = M.init_params(cfg, 0, device=resolve_device(device))
        if paged not in built:
            built[paged] = ServeEngine(cfg, built["params"], max_len=max_len,
                                       decode_window=decode_window, device=device,
                                       paged=paged)
        return built[paged]

    def session(paged: bool, checksum_every: int = 0, admitted: bool = False):
        rng = np.random.default_rng(0)
        reqs = [Request(tokens=rng.integers(1, cfg.vocab_size, prompt), max_new_tokens=4)
                for _ in range(batch)]
        sess = ServeSession(engine(paged), reqs, slots=batch, checksum_every=checksum_every)
        if admitted:
            with torch.inference_mode():
                sess._admit()
        return sess

    def in_inference(fn):
        def run():
            with torch.inference_mode():
                return fn()
        return run

    def prefill():
        eng = engine(False)
        held = {"state": eng._new_state(batch, max(k, _bucket32(prompt)))}
        gen = torch.Generator().manual_seed(0)
        tokens = torch.randint(1, cfg.vocab_size, (batch, prompt), generator=gen).to(eng.device)

        def run():
            held["state"] = eng._prefill(eng.params, held["state"], tokens,
                                         torch.full((batch,), prompt))[1]
        return in_inference(run), lambda: held["state"]

    def window():
        eng = engine(False)
        state = eng._new_state(batch, max(k, _bucket32(prompt)))
        tokens = torch.ones((batch, prompt), dtype=torch.int64, device=eng.device)
        with torch.inference_mode():
            logits, _ = eng._prefill(eng.params, state, tokens)
        cur = logits[:, -1].argmax(dim=-1)[:, None]
        pos = torch.tensor(prompt, device=eng.device)
        return in_inference(lambda: eng._window(state, cur, pos, k, last=False)), lambda: state

    def dispatch(paged: bool, step: str, checksum_every: int = 0):
        def prepare():
            sess = session(paged, checksum_every, admitted=step != "_admit")
            return in_inference(getattr(sess, step)), lambda: sess.state
        return prepare

    sess_at = f"{here}:ServeSession"
    return [
        DispatchEntry("serve.prefill", prefill, f"{here}:make_cache_prefill_step"),
        DispatchEntry("serve.window", window, f"{here}:ServeEngine._window"),
        DispatchEntry("serve.serve_window", dispatch(False, "_decode_window"),
                      f"{sess_at}._window", kind="window"),
        DispatchEntry("serve.admit", dispatch(False, "_admit"), f"{sess_at}._admit",
                      kind="admit"),
        DispatchEntry("serve.shadow_checksum", dispatch(False, "_spot_check", 1),
                      f"{sess_at}._spot_check", updated=None),
        DispatchEntry("serve.paged_window", dispatch(True, "_decode_window"),
                      f"{sess_at}._window", kind="window", paged=True),
        DispatchEntry("serve.paged_admit", dispatch(True, "_admit"), f"{sess_at}._admit",
                      kind="admit", paged=True),
    ]
