"""Serving: prompt scoring (``make_prefill_step``), cache prefill, a
lockstep greedy ``generate`` and a continuous-batching ``serve``
(counterpart of ``repro.serve.engine``).

The reference jits each step and donates the decode state so XLA updates
it in place; here the state tensors are preallocated once per call and
:func:`repro_torch.model.model.decode_step` writes every layer's new state
into them in place.  Everything runs under ``torch.inference_mode()``.

``serve`` is the fault-free scheduler of the reference: a FIFO slot pool,
ragged prompts admitted by one masked prefill each round, per-slot
progress, and EOS / budget detected inside each K-token window.  Chaos
injection, deadlines, queue bounds, the watchdog, snapshots, checksums,
paging and the fleet are not ported yet.

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
import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.kernels.common import resolve_device
from repro_torch.model import model as M
from repro_torch.model.attention import KVCache


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


def make_cache_prefill_step(cfg, *, last_only: bool = False,
                            max_len: int | None = None):
    """``(params, state, tokens (B, P)[, prompt_lengths (B,)]) ->
    (logits, state)``: the whole prompt goes through one ``decode_step``
    window from position 0, so the WKV part takes the decode-window kernel
    (P <= 64) or the chunked kernel, not P single steps.  ``state`` is
    updated in place.  ``prompt_lengths`` masks ragged prompts: padding
    enters no state, and with ``last_only`` the logits are taken at each
    row's last valid token."""

    def cache_prefill(params, state, tokens, prompt_lengths=None):
        mask = None
        if prompt_lengths is not None:
            p = tokens.shape[1]
            plen = torch.as_tensor(prompt_lengths, device=tokens.device)
            mask = torch.arange(p, device=tokens.device)[None, :] < plen[:, None]
        return M.decode_step(params, cfg, state, tokens, 0,
                             last_only=last_only, token_mask=mask,
                             max_len=max_len)

    return cache_prefill


@dataclasses.dataclass
class Request:
    """One serve request: a prompt and a generation budget."""

    tokens: Any                    # (P,) int prompt token ids
    max_new_tokens: int = 16


@dataclasses.dataclass
class RequestResult:
    """One served request's tokens (prompt excluded) plus its outcome:
    ``ok`` (budget spent), ``eos`` (sampled ``eos_id``) or ``shed`` (prompt
    plus budget exceed ``max_len``).  Array-like, so results drop into code
    written for bare token arrays."""

    tokens: np.ndarray
    outcome: str = "ok"

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
    """

    cfg: Any
    params: Any
    max_len: int = 256
    decode_window: int = 8
    device: Any = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        emb = self.params["tok"]["embedding"]
        if emb.device.type != self.device.type:
            raise ValueError(
                f"params live on {emb.device}, engine device is {self.device}")
        self._prefill = make_cache_prefill_step(
            self.cfg, last_only=True, max_len=self.max_len)
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
              top_k: int = 0, eos_id: int | None = None, seed: int = 0):
        """Decode ``requests`` (:class:`Request`, or bare prompt arrays)
        through a pool of ``slots`` batch slots, first come first served.

        Each round admits queued requests into free slots with one masked
        prefill (other slots' states stay bit-identical), then runs one
        K-token window in which every live slot decodes at its own position
        and stops at ``eos_id`` or its own budget.  A request whose prompt
        plus budget exceeds ``max_len`` is shed.  Returns one
        :class:`RequestResult` per request, in order."""
        sess = _ServeSession(self, requests, slots, temperature, top_k,
                             eos_id, seed)
        while sess.pending or sess.active_np.any():
            sess.admit()
            sess.decode_window()
        self.last_state = sess.state
        self.last_serve_stats = sess.stats
        return sess.results()


class _ServeSession:
    """The state of one :meth:`ServeEngine.serve` call: device tensors of
    the slot pool plus the host's queue and per-request outputs."""

    def __init__(self, eng, requests, slots, temperature, top_k, eos_id, seed):
        self.eng = eng
        self.temperature, self.top_k = float(temperature), int(top_k)
        self.eos_id, self.seed = eos_id, int(seed)
        self.reqs = [r if hasattr(r, "tokens") else Request(tokens=r)
                     for r in requests]
        n = len(self.reqs)
        self.b = b = max(1, min(int(slots), n)) if n else 1
        self.k_w = max(1, int(eng.decode_window))
        self.prompts = [np.asarray(r.tokens, np.int64).reshape(-1)
                        for r in self.reqs]
        self.outputs: list[list[int]] = [[] for _ in range(n)]
        self.outcomes: list[str | None] = [None] * n
        self.stats = {"decode_dispatches": 0, "admissions": 0,
                      "slot_steps": 0, "shed": 0}
        for i, (r, p) in enumerate(zip(self.reqs, self.prompts)):
            if p.size < 1:
                raise ValueError("request prompt must be non-empty")
            if int(r.max_new_tokens) < 1:
                raise ValueError("max_new_tokens must be >= 1")
            if p.size + int(r.max_new_tokens) > eng.max_len:
                self.outcomes[i] = "shed"
                self.stats["shed"] += 1
        dev = eng.device
        live = [len(p) for p, oc in zip(self.prompts, self.outcomes) if oc is None]
        # Ring slack for the widest admission window (the reference's sizing
        # off its recovery paths).
        self.state = eng._new_state(b, max(self.k_w, _bucket32(max(live, default=1))))
        zeros = lambda dt: torch.zeros(b, dtype=dt, device=dev)  # noqa: E731
        self.lengths = zeros(torch.int64)
        self.counts = zeros(torch.int64)
        self.budgets = zeros(torch.int64)
        self.req_ids = zeros(torch.int64)
        self.active = zeros(torch.bool)
        self.cur = torch.zeros((b, 1), dtype=torch.int64, device=dev)
        self.pending = collections.deque(
            i for i in range(n) if self.outcomes[i] is None)
        self.slot_req = [-1] * b
        self.active_np = np.zeros(b, bool)

    def _resolve(self, ri):
        out = self.outputs[ri]
        self.outcomes[ri] = (
            "eos" if self.eos_id is not None and out and out[-1] == self.eos_id
            else "ok")

    def admit(self):
        """Prefill queued requests into the free slots (one masked window)."""
        eng, b, dev = self.eng, self.b, self.eng.device
        free = [i for i in range(b) if not self.active_np[i]]
        take = []
        while len(take) < len(free) and self.pending:
            take.append(self.pending.popleft())
        if not take:
            return
        used = free[: len(take)]
        p_b = _bucket32(max(self.prompts[ri].size for ri in take))
        tok_np = np.zeros((b, p_b), np.int64)
        admit_np = np.zeros(b, bool)
        plen_np = np.zeros(b, np.int64)
        bud_np = self.budgets.cpu().numpy()
        rid_np = self.req_ids.cpu().numpy()
        for slot, ri in zip(used, take):
            p = self.prompts[ri]
            tok_np[slot, : p.size] = p
            admit_np[slot] = True
            plen_np[slot] = p.size
            bud_np[slot] = int(self.reqs[ri].max_new_tokens)
            rid_np[slot] = ri
            self.slot_req[slot] = ri
        self.budgets = torch.from_numpy(bud_np).to(dev)
        self.req_ids = torch.from_numpy(rid_np).to(dev)
        admit_row = torch.from_numpy(admit_np).to(dev)
        plen = torch.from_numpy(plen_np).to(dev)

        _reset_slot_rows(self.state, admit_row)
        mask = admit_row[:, None] & (
            torch.arange(p_b, device=dev)[None, :] < plen[:, None])
        logits, self.state = M.decode_step(
            eng.params, eng.cfg, self.state, torch.from_numpy(tok_np).to(dev),
            0, token_mask=mask, last_only=True, max_len=eng.max_len)
        tok0 = _sample_tokens(logits[:, -1], self.seed, self.req_ids,
                              torch.zeros_like(self.req_ids),
                              self.temperature, self.top_k)
        self.lengths = torch.where(admit_row, plen, self.lengths)
        self.counts = torch.where(admit_row, torch.ones_like(self.counts),
                                  self.counts)
        done = self.counts >= self.budgets
        if self.eos_id is not None:
            done |= tok0 == self.eos_id
        self.active = torch.where(admit_row, ~done, self.active)
        self.cur = torch.where(admit_row[:, None], tok0[:, None], self.cur)

        tok0_np = tok0.cpu().numpy()
        self.active_np = self.active.cpu().numpy()
        for slot, ri in zip(used, take):
            self.outputs[ri].append(int(tok0_np[slot]))
            if not self.active_np[slot]:          # done at admission
                self._resolve(ri)
                self.slot_req[slot] = -1
        self.stats["admissions"] += 1

    def decode_window(self):
        """One K-token window over every slot; finished and empty slots
        are masked out, so their states stay bit-identical."""
        if not self.active_np.any():
            return
        eng = self.eng
        toks, emits = [], []
        for _ in range(self.k_w):
            logits, self.state = M.decode_step(
                eng.params, eng.cfg, self.state, self.cur, self.lengths,
                token_mask=self.active[:, None], last_only=True,
                max_len=eng.max_len)
            nxt = _sample_tokens(logits[:, -1], self.seed, self.req_ids,
                                 self.counts, self.temperature, self.top_k)
            emit = self.active
            self.lengths = self.lengths + emit.long()
            self.counts = self.counts + emit.long()
            done = self.counts >= self.budgets
            if self.eos_id is not None:
                done |= nxt == self.eos_id
            self.active = self.active & ~done
            self.cur = torch.where(emit[:, None], nxt[:, None], self.cur)
            toks.append(nxt)
            emits.append(emit)
        toks_np = torch.stack(toks).cpu().numpy()
        emits_np = torch.stack(emits).cpu().numpy()
        for step in range(self.k_w):
            for slot in np.nonzero(emits_np[step])[0]:
                self.outputs[self.slot_req[slot]].append(int(toks_np[step, slot]))
        prev_active = self.active_np
        self.active_np = self.active.cpu().numpy()
        self.stats["decode_dispatches"] += 1
        self.stats["slot_steps"] += self.k_w * self.b
        for slot in np.nonzero(prev_active & ~self.active_np)[0]:
            self._resolve(self.slot_req[slot])
            self.slot_req[slot] = -1

    def results(self) -> list[RequestResult]:
        return [RequestResult(tokens=np.asarray(o, np.int32), outcome=oc)
                for o, oc in zip(self.outputs, self.outcomes)]
