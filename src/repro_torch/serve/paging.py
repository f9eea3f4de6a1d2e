"""Paged KV storage for the serve engine: page pools, per-slot page tables
and recurrent-state prefix sharing (counterpart of ``repro.serve.paging``).

The dense engine gives every slot a ``max_len`` KV ring per attention
layer, so the slot count, not the tokens in flight, caps concurrency, and
a shared system prompt is prefilled again for every request.  Paging
replaces that static partition with pooled, dynamically mapped storage:

* :class:`PagedController` (host) owns one page pool per KV node (pages of
  ``page_size`` tokens, a multiple of the 32-token admission bucket) and
  hands pages out and takes them back on the admission and recycle path
  of a serve.  A request reserves its whole need (prompt plus budget) at
  admission, so decode windows never touch the allocator.
* :func:`apply_admission` (device) installs the new table rows in place
  right after the slot reset, scrubs freshly mapped private pages of
  non-finite values, and for prefix admissions copies the registered
  prefix's recurrent state (WKV S, RG-LRU h, conv tails) and local-ring
  content into the admitted rows.
* Nodes whose view spans ``max_len`` (global attention, or a local ring
  capped at ``max_len``) never wrap, so the pages below a slot's start
  length are never written: those nodes *share* the prefix's pages
  read-only.  Wrapping rings are written in place, so their prefix content
  is *copied* into the slot's private pages instead.

A freed page stays mapped at most in an inactive slot's table row; every
position it could alias there is rejected by the positional masks, and it
is scrubbed at its next admission before any live query can reach it.

The device side updates the state in place (the reference donates it to
its jit and returns a new one); every write is confined to the admitted
rows, so a neighbouring slot's rows stay bit-identical.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.model.attention import NULL_PAGE, KVCache, PagedKVCache, _null_rows
from repro_torch.model.recurrent import RecState

#: ``owner`` codes below 0 (>= 0 is the owning slot index).
FREE, NULL, SHARED = -1, -2, -3


def flatten_nodes(state) -> list:
    """The state's nodes in the reference's walk order (JAX sorts the
    state dict's keys: the remainder's nodes, then the stacked ones), the
    one order the host controller and the device admission share."""
    return list(state["remainder"]) + list(state["scanned"] or [])


def split_entry(entry_state):
    """Split a batch-1 *dense* decode state (a prefilled prefix) into the
    admission's operands: the recurrent nodes in walk order, and each KV
    node's ``(k, v)`` dense views."""
    nodes = flatten_nodes(entry_state)
    rec = [n for n in nodes if isinstance(n, RecState)]
    kv = [(n.k, n.v) for n in nodes if isinstance(n, KVCache)]
    return rec, kv


# --------------------------------------------------------------------------
# Host side: geometry and allocator
# --------------------------------------------------------------------------


@dataclasses.dataclass
class NodeGeom:
    """Static geometry of one paged KV node."""

    layers: int          # stacked multiplicity (1 = unstacked)
    s_view: int          # dense-equivalent sequence extent
    page_size: int
    nl: int              # logical pages per slot (ceil(s_view / page_size))
    pool_pages: int      # physical pages (null and shared included)
    role: str            # "share" (never wraps) | "copy" (wrapping ring)
    page_bytes: int      # k + v bytes of ONE page across stacked layers


class PagedController:
    """Host-side page bookkeeping for one serve.

    One ``owner`` array per KV node (page -> slot, or FREE / NULL /
    SHARED): the single source of truth the page tables are built from,
    what a snapshot saves, and what :meth:`audit` checks the device tables
    against.  Allocation follows the reference's order exactly: each free
    list is kept sorted high to low and the lowest page is popped first.
    """

    def __init__(self, cfg, state, *, batch: int, max_len: int,
                 shared_map: dict[int, tuple[int, int]] | None = None):
        self.batch = int(batch)
        self.max_len = int(max_len)
        self.kv_index: list[int] = []
        self.geoms: list[NodeGeom] = []
        for i, node in enumerate(flatten_nodes(state)):
            if not isinstance(node, PagedKVCache):
                continue
            layers = int(node.k.shape[0]) if node.k.ndim == 5 else 1
            ps, s = int(node.page_size), int(node.s_view)
            hkv, dh = int(node.k.shape[-2]), int(node.k.shape[-1])
            self.kv_index.append(i)
            self.geoms.append(NodeGeom(
                layers=layers, s_view=s, page_size=ps, nl=-(-s // ps),
                pool_pages=int(node.k.shape[-4]),
                role="share" if s == self.max_len else "copy",
                page_bytes=layers * ps * hkv * dh * node.k.element_size() * 2,
            ))
        #: prefix id -> (first shared page id, page count); the same ids in
        #: every "share" node (their pools reserve the same shared region).
        self.shared_map = dict(shared_map or {})
        self.shared_total = sum(n for _, n in self.shared_map.values())
        self.owners: list[np.ndarray] = []
        self.free: list[list[int]] = []
        for g in self.geoms:
            owner = np.full(g.pool_pages, FREE, np.int32)
            owner[NULL_PAGE] = NULL
            if g.role == "share":
                owner[1:1 + self.shared_total] = SHARED
            self.owners.append(owner)
            self.free.append(sorted(np.nonzero(owner == FREE)[0].tolist(), reverse=True))
        self.peak_mapped_bytes = self.mapped_bytes()
        self.violations: list[str] = []

    # -- byte accounting -------------------------------------------------

    @property
    def roles(self) -> tuple[str, ...]:
        return tuple(g.role for g in self.geoms)

    def pool_bytes(self) -> int:
        """Physically allocated pool bytes (what the paged state holds)."""
        return sum(g.page_bytes * g.pool_pages for g in self.geoms)

    def dense_bytes(self) -> int:
        """What the dense engine allocates for the same geometry: ``slots
        x s_view`` positions per node, in whole pages."""
        return sum(g.page_bytes * self.batch * g.nl for g in self.geoms)

    def mapped_bytes(self) -> int:
        """Bytes of the pages mapped now (tokens in flight plus shared)."""
        total = 0
        for g, owner in zip(self.geoms, self.owners):
            total += g.page_bytes * int(np.sum(owner >= 0))
            if g.role == "share":
                total += g.page_bytes * self.shared_total
        return total

    # -- allocation ------------------------------------------------------

    def pages_needed(self, total_positions: int, start_len: int):
        """Per node (logical pages used, shared pages used, private pages
        to allocate) for a request reaching ``total_positions``."""
        out = []
        for g in self.geoms:
            used = -(-min(int(total_positions), g.s_view) // g.page_size)
            sh = min(start_len // g.page_size, used) if g.role == "share" else 0
            out.append((used, sh, used - sh))
        return out

    def fits_capacity(self, total_positions: int, start_len: int) -> bool:
        """Whether the request could ever be admitted (an empty pool has
        enough private pages): the shed-or-wait decision."""
        return all(
            priv <= len(owner) - 1 - np.sum(owner == SHARED)
            and priv <= np.sum((owner == FREE) | (owner >= 0))
            for (_, _, priv), owner in zip(
                self.pages_needed(total_positions, start_len), self.owners))

    def try_admit(self, slot: int, total_positions: int, prefix_id, start_len: int):
        """Reserve the request's whole page need and build its table rows.
        Returns ``(tables, scrubs)``, per node ``(nl,)`` int32 rows (-1 =
        unmapped; a scrub row leaves the shared pages out), or ``None``
        under pool pressure (the caller retries after a recycle)."""
        need = self.pages_needed(total_positions, start_len)
        grabbed: list[list[int]] = []
        for (_, _, priv), free in zip(need, self.free):
            if priv > len(free):
                for ids, fr in zip(grabbed, self.free):
                    fr.extend(reversed(ids))
                return None
            grabbed.append([free.pop() for _ in range(priv)])
        tables, scrubs = [], []
        for g, owner, (used, sh, _), ids in zip(self.geoms, self.owners, need, grabbed):
            row = np.full(g.nl, -1, np.int32)
            if sh:
                start, _ = self.shared_map[prefix_id]
                row[:sh] = np.arange(start, start + sh, dtype=np.int32)
            row[sh:used] = np.asarray(ids, np.int32)
            owner[ids] = slot
            scrub = row.copy()
            scrub[:sh] = -1
            tables.append(row)
            scrubs.append(scrub)
        self.peak_mapped_bytes = max(self.peak_mapped_bytes, self.mapped_bytes())
        return tables, scrubs

    def free_slot(self, slot: int):
        """Return every page ``slot`` owns to the free lists.  Host
        bookkeeping only: the device row goes stale, which is safe (the
        slot is inactive, and a page is scrubbed when next mapped)."""
        for owner, free in zip(self.owners, self.free):
            mine = np.nonzero(owner == slot)[0]
            owner[mine] = FREE
            free.extend(int(p) for p in mine[::-1])

    # -- audit and snapshot ----------------------------------------------

    def audit(self, state, active: np.ndarray, slot_req) -> list[str]:
        """Page-table well-formedness against the device state: no page
        mapped by two active slots, no freed or null page reachable from an
        active slot's row, and every owned page's owner holding a request.
        Reads each node's table to the host once.  Appends to (and
        returns) ``self.violations``."""
        nodes = flatten_nodes(state)
        msgs = []
        for gi, (ni, owner) in enumerate(zip(self.kv_index, self.owners)):
            tbl = nodes[ni].page_table.cpu().numpy()
            if tbl.ndim == 3:
                tbl = tbl[0]
            seen: dict[int, int] = {}
            for slot in range(self.batch):
                if not active[slot]:
                    continue
                for page in tbl[slot]:
                    page = int(page)
                    if page < 0:
                        continue
                    if page == NULL_PAGE:
                        msgs.append(f"node{gi}: active slot {slot} maps the null page")
                        continue
                    code = int(owner[page])
                    if code == FREE:
                        msgs.append(f"node{gi}: active slot {slot} reaches freed page {page}")
                    elif code >= 0 and code != slot:
                        msgs.append(f"node{gi}: page {page} double-mapped by active "
                                    f"slots {code} and {slot}")
                    if page in seen and seen[page] != slot and code != SHARED:
                        msgs.append(f"node{gi}: page {page} appears in rows "
                                    f"{seen[page]} and {slot}")
                    seen[page] = slot
            for page in np.nonzero(owner >= 0)[0]:
                s = int(owner[page])
                if slot_req[s] < 0 and not active[s]:
                    msgs.append(f"node{gi}: page {int(page)} leaked: owned by slot "
                                f"{s}, which holds no request")
        self.violations.extend(msgs)
        return msgs

    def snapshot_tree(self) -> dict[str, np.ndarray]:
        return {f"owner{i}": o.copy() for i, o in enumerate(self.owners)} | {
            "peak_mapped_bytes": np.int64(self.peak_mapped_bytes)}

    def restore(self, tree: dict[str, np.ndarray]):
        for i in range(len(self.owners)):
            self.owners[i] = np.asarray(tree[f"owner{i}"], np.int32).copy()
            self.free[i] = sorted(np.nonzero(self.owners[i] == FREE)[0].tolist(),
                                  reverse=True)
        self.peak_mapped_bytes = int(tree["peak_mapped_bytes"])


def upload_shared(state, controller: PagedController,
                  entries: dict[int, tuple[list, list]]):
    """Write each registered prefix's K/V into its reserved shared pages of
    every "share" node, in place, once per serve before any admission.
    Those nodes never wrap, so dense view position ``p`` of the prefix
    entry is exactly ring slot ``p``.  Returns ``state``."""
    nodes = flatten_nodes(state)
    for gi, (ni, g) in enumerate(zip(controller.kv_index, controller.geoms)):
        if g.role != "share":
            continue
        node = nodes[ni]
        for pid, (start, nsh) in sorted(controller.shared_map.items()):
            ck, cv = entries[pid][1][gi]
            span = nsh * g.page_size
            for pool, content in ((node.k, ck), (node.v, cv)):
                # content (1, Hkv, S, Dh), or stacked (L, 1, Hkv, S, Dh):
                # the first nsh pages' worth of positions, as pages.
                src = content[..., 0, :, :span, :].transpose(-3, -2)
                src = src.reshape(src.shape[:-3] + (nsh, g.page_size) + src.shape[-2:])
                pool[..., start:start + nsh, :, :, :] = src.to(pool.dtype)
    return state


# --------------------------------------------------------------------------
# Device side: the admission's state surgery, in place
# --------------------------------------------------------------------------


def _admit_kv(node: PagedKVCache, admit_row, copy_rows, start_len, table, scrub, content):
    """One node's admission, every stacked layer at once (the same table in
    each): install the table rows, set prefix rows' lengths to their start
    length, scrub freshly mapped private pages of non-finite values, and
    (copy nodes) write the prefix's ring content into the prefix rows'
    pages.  ``content`` is the entry's ``(k, v)``, (1, Hkv, S, Dh) or
    stacked (L, 1, Hkv, S, Dh)."""
    ps, s = node.page_size, node.s_view
    hkv, dh = node.k.shape[-2], node.k.shape[-1]
    lead = node.k.shape[:-4]
    dev = node.k.device
    zero = torch.zeros((), dtype=node.k.dtype, device=dev)
    new_table = torch.where(admit_row[:, None], table, node.page_table[(0,) * len(lead)])
    node.page_table.copy_(new_table)
    node.length.copy_(torch.where(copy_rows, start_len, node.length))

    st = torch.where(admit_row[:, None], scrub, -1).reshape(-1).long()    # (B * NL,)
    offs = torch.arange(ps, device=dev)
    scrub_rows = _null_rows((st.clamp_min(0)[:, None] * ps + offs).reshape(-1),
                            (st >= 0)[:, None].expand(-1, ps).reshape(-1), ps)
    if content is not None:
        i = torch.arange(s, device=dev)
        cp = new_table[:, i // ps].long()                                  # (B, S)
        ok = copy_rows[:, None] & (cp >= 0)
        ring_rows = _null_rows((cp.clamp_min(0) * ps + i % ps).reshape(-1),
                               ok.reshape(-1), ps)
    for n, pool in enumerate((node.k, node.v)):
        flat = pool.view(lead + (-1, hkv, dh))
        vals = flat[..., scrub_rows, :, :]
        flat[..., scrub_rows, :, :] = torch.where(torch.isfinite(vals), vals, zero)
        if content is not None:
            src = content[n][..., 0, :, :, :].transpose(-3, -2).to(pool.dtype)
            src = src.unsqueeze(-4).expand(lead + (len(copy_rows), s, hkv, dh))
            src = torch.where(ok[:, :, None, None], src, zero)
            flat[..., ring_rows, :, :] = src.reshape(lead + (-1, hkv, dh))


def _copy_rec(node: RecState, entry: RecState, rows: torch.Tensor):
    """Read-side dual of the reset's recurrent zeroing: write the prefix
    entry's batch-1 WKV S / RG-LRU h / conv tails into ``rows`` (B,) bool,
    in place; other rows are untouched."""
    extra = node.conv.ndim - 3
    for leaf, src in ((node.h, entry.h), (node.conv, entry.conv)):
        m = rows.reshape((1,) * extra + (-1,) + (1,) * (leaf.ndim - extra - 1))
        leaf.copy_(torch.where(m, src.to(leaf.dtype), leaf))


def apply_admission(state, roles, admit_row, prefix_rows, start_len, tables, scrubs,
                    rec_entries, ring_contents):
    """The admission's state surgery, in place, right after the slot
    reset.  ``roles`` is the controller's per-KV-node role tuple;
    ``tables`` / ``scrubs`` are per-KV-node ``(B, NL)`` int32 rows (the
    admitted rows' entries used); ``rec_entries`` / ``ring_contents`` are
    the prefix entry's recurrent nodes and copy nodes' ``(k, v)`` views
    (zeros when the admission carries no prefix: ``prefix_rows`` gates
    every use).  Returns ``state``."""
    copy_rows = admit_row & prefix_rows
    kv_i = rec_i = copy_i = 0
    for node in flatten_nodes(state):
        if isinstance(node, PagedKVCache):
            content = None
            if roles[kv_i] == "copy":
                content = ring_contents[copy_i]
                copy_i += 1
            _admit_kv(node, admit_row, copy_rows, start_len, tables[kv_i], scrubs[kv_i],
                      content)
            kv_i += 1
        elif isinstance(node, RecState):
            _copy_rec(node, rec_entries[rec_i], copy_rows)
            rec_i += 1
    return state
