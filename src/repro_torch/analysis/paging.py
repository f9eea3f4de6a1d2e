"""Paged-KV audit: page-table well-formedness and pool byte budgets.

The paged serve engine replaces per-slot dense KV rings with pooled pages
(:mod:`repro_torch.serve.paging`).  Its failure modes are silent: a page
mapped by two live slots corrupts both streams with no error, a freed
page still reachable from an active row resurrects stale (or poisoned)
KV, and a mis-sized pool quietly forfeits the footprint win the pool
exists for.  This pass proves the invariants with host-side controller
bookkeeping and states built on the ``meta`` device (nothing is
allocated); the page tables it audits are CPU tensors, as the audit reads
them to the host:

* **geometry** — every KV node's page table covers exactly its dense-
  equivalent view (``nl == ceil(s_view / page_size)``), pools reserve
  the null page, and prefix *sharing* is only offered on nodes that can
  never wrap (``s_view == max_len``);
* **audit liveness** — the controller's page-table audit actually fires
  on each class of corruption (double-map, freed-page reach, leak),
  probed by injecting each one into a mock table;
* **bytes** — a pool sized to the modeled pages-in-flight high-water
  mark (:func:`repro_torch.core.cost_model.serve_paged_pool`) stays
  strictly below the dense ``slots × max_len`` footprint at full config
  shapes.

A port of the reference's ``repro.analysis.paging``: the same arguments,
workload and checks.
"""

from __future__ import annotations

import numpy as np

from repro_torch.analysis.findings import Finding, error, info

PASS = "paging"
LOCATION = "src/repro_torch/serve/paging.py:PagedController"

#: Reference ragged workload (prompt, budget) for the byte model —
#: spread over the position range the way the serve bench's specs are.
_WORKLOAD = [(48, 80), (200, 56), (24, 16), (96, 160), (130, 24),
             (60, 100), (300, 40), (16, 48)]


def _mock_state(state, controller, tables_by_slot):
    """``state`` with every KV node's page table built on the CPU from the
    controller's admission rows — what the audit walks; the pools stay on
    the ``meta`` device."""
    import torch

    from repro_torch.serve import paging as P

    nodes = P.flatten_nodes(state)
    for gi, ni in enumerate(controller.kv_index):
        tbl = np.full((controller.batch, controller.geoms[gi].nl), -1, np.int32)
        for slot, rows in tables_by_slot.items():
            tbl[slot] = rows[gi]
        nodes[ni] = nodes[ni]._replace(page_table=torch.from_numpy(tbl))
    n_rem = len(state["remainder"])
    return {"remainder": nodes[:n_rem],
            "scanned": nodes[n_rem:] if state["scanned"] is not None else None}


def run(cfg, *, batch: int = 4, max_len: int = 512,
        page_size: int = 32) -> list[Finding]:
    """Audit the paged-KV contracts for ``cfg`` at serving shapes."""
    from repro_torch.core import cost_model as CM
    from repro_torch.model import model as M
    from repro_torch.serve import paging as P

    findings: list[Finding] = []
    spec = M.PageSpec(page_size=page_size, shared_pages=2)
    state = M.init_decode_state(cfg, batch, max_len, insert_window=page_size,
                                paged=spec, device="meta")
    ctl = P.PagedController(cfg, state, batch=batch, max_len=max_len,
                            shared_map={0: (1, 2)})
    if not ctl.geoms:
        return [info(
            PASS, LOCATION,
            f"{cfg.name}: no attention KV state — paging trivially holds",
        )]

    # -- geometry ---------------------------------------------------------
    for gi, g in enumerate(ctl.geoms):
        if g.nl != -(-g.s_view // g.page_size):
            findings.append(error(
                PASS, LOCATION,
                f"{cfg.name}: node{gi} page table has {g.nl} entries for "
                f"a {g.s_view}-position view of {g.page_size}-token pages",
                node=gi))
        if g.page_size % 32:
            findings.append(error(
                PASS, LOCATION,
                f"{cfg.name}: node{gi} page size {g.page_size} is not a "
                f"multiple of the 32-token admit bucket", node=gi))
        share_ok = g.role == ("share" if g.s_view == max_len else "copy")
        if not share_ok:
            findings.append(error(
                PASS, LOCATION,
                f"{cfg.name}: node{gi} (s_view={g.s_view}, "
                f"max_len={max_len}) has role {g.role!r} — prefix pages "
                f"may only be shared on views that can never wrap",
                node=gi))

    # -- controller schedule: admissions, a free, a recycle ---------------
    tables: dict[int, list] = {}
    for slot, total in ((0, 3 * page_size), (1, 2 * page_size)):
        alloc = ctl.try_admit(slot, total, None, 0)
        if alloc is None:
            findings.append(error(
                PASS, LOCATION,
                f"{cfg.name}: dense-equivalent pool refused slot {slot} "
                f"({total} positions) with everything free"))
            return findings
        tables[slot] = alloc[0]
    ctl.free_slot(0)
    del tables[0]
    msgs = ctl.audit(_mock_state(state, ctl, tables),
                     np.asarray([False, True] + [False] * (batch - 2)),
                     [-1, 1] + [-1] * (batch - 2))
    if msgs:
        findings.append(error(
            PASS, LOCATION,
            f"{cfg.name}: clean admit/free schedule flagged: {msgs[0]}",
            violations=len(msgs)))

    # -- audit liveness: each corruption class must be caught -------------
    re_alloc = ctl.try_admit(0, 3 * page_size, None, 0)
    tables[0] = re_alloc[0]
    active = np.asarray([True, True] + [False] * (batch - 2))
    probes = {
        # Slot 1's first page also mapped by slot 0's row -> double-map.
        "double-mapped": {0: [np.concatenate([r[:1], t[1:]])
                              for r, t in zip(tables[1], tables[0])],
                          1: tables[1]},
    }
    for name, tbl in probes.items():
        ctl.violations.clear()
        if not ctl.audit(_mock_state(state, ctl, tbl), active, [0, 1]):
            findings.append(error(
                PASS, LOCATION,
                f"{cfg.name}: audit did not flag a {name} page — the "
                f"check is dead"))
    # Freed-page reach: free slot 0 but leave its row mapped and active.
    ctl.free_slot(0)
    ctl.violations.clear()
    if not any("freed" in m or "leaked" in m for m in ctl.audit(
            _mock_state(state, ctl, tables), active, [0, 1])):
        findings.append(error(
            PASS, LOCATION,
            f"{cfg.name}: audit did not flag an active row reaching a "
            f"freed page — the check is dead"))
    # Leak: owner says a slot holds pages, slot table says no request.
    leak = ctl.try_admit(0, 3 * page_size, None, 0)
    ctl.violations.clear()
    if not any("leaked" in m for m in ctl.audit(
            _mock_state(state, ctl, {0: leak[0], 1: tables[1]}),
            np.asarray([False, True] + [False] * (batch - 2)),
            [-1, 1] + [-1] * (batch - 2))):
        findings.append(error(
            PASS, LOCATION,
            f"{cfg.name}: audit did not flag pages owned by a slot with "
            f"no request — leaked pages are invisible"))
    ctl.free_slot(0)
    ctl.violations.clear()
    # The engine's release discipline feeds this audit: with every
    # free_slot honored, a full admit/free cycle must end page-clean.
    leftover = ctl.audit(
        _mock_state(state, ctl, {1: tables[1]}),
        np.asarray([False, True] + [False] * (batch - 2)),
        [-1, 1] + [-1] * (batch - 2))
    if leftover:
        findings.append(error(
            PASS, LOCATION,
            f"{cfg.name}: pages survived their slot's release: "
            f"{leftover[0]}", violations=len(leftover)))

    # -- bytes: modeled-peak pool strictly below the dense footprint ------
    prompts = [p for p, _ in _WORKLOAD]
    budgets = [t for _, t in _WORKLOAD]
    peak, dense_pages = CM.serve_paged_pool(
        prompts, budgets, slots=batch, page_size=page_size)
    sized = P.PagedController(
        cfg,
        M.init_decode_state(
            cfg, batch, max_len, insert_window=page_size,
            paged=M.PageSpec(page_size=page_size, private_pages=peak), device="meta"),
        batch=batch, max_len=max_len)
    pool_b, dense_b = sized.pool_bytes(), sized.dense_bytes()
    if pool_b >= dense_b:
        findings.append(error(
            PASS, LOCATION,
            f"{cfg.name}: pool sized to the modeled peak "
            f"({peak}/{dense_pages} pages) still needs {pool_b} bytes vs "
            f"{dense_b} dense — the pool never wins at these shapes",
            pool_bytes=pool_b, dense_bytes=dense_b))

    if not findings:
        findings.append(info(
            PASS, LOCATION,
            f"{cfg.name}: page tables well-formed over "
            f"{len(ctl.geoms)} KV nodes, audit fires on double-map / "
            f"freed-reach / leak, and a peak-sized pool "
            f"({peak}/{dense_pages} pages) costs {pool_b} bytes vs "
            f"{dense_b} dense",
            kv_nodes=len(ctl.geoms), peak_pages=peak,
            dense_pages=dense_pages, pool_bytes=pool_b,
            dense_bytes=dense_b))
    return findings
