"""In-place audit: every registered serve and train dispatch must update
its state in place (counterpart of ``repro.analysis.donation``).

The reference donates its decode and train state to its jits and proves,
from the compiled HLO's ``input_output_alias``, that XLA updates it in
place.  The port has no jits: its dispatches write the state tensors they
are handed (``model.decode_step`` into the decode state, AdamW into the
parameters and moments).  A dispatch that rebinds a state leaf instead
(a new tensor where the old one was written) ships silently: the code
still runs, it just pays a full copy of the state per dispatch, and the
next dispatch reads the copy.  This pass runs each *registered* dispatch
once, on a tiny state of the reduced config, and holds every leaf of the
state it names to the tensor object and storage it had before: a rebound
leaf, or one whose storage moved, is an ERROR at the dispatch's location.
A read-only entry (the shadow checksum) must leave every leaf's bits, and
its version counter where the tensor keeps one, as they were.

Entries come from registration hooks next to the dispatches they
describe (:func:`repro_torch.serve.engine.audit_dispatch_entrypoints`,
:func:`repro_torch.train.step.audit_dispatch_entrypoints`), so adding a
dispatch without registering it is a reviewable one-line gap, which the
``fleet`` pass reports for the dispatches a replica issues.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.analysis.findings import Finding, error, info

PASS = "donation"


@dataclasses.dataclass(frozen=True)
class DispatchEntry:
    """One registered state-mutating dispatch.  ``prepare()`` builds its
    tiny state and returns ``(run, state)``: ``run()`` makes the dispatch
    once, ``state()`` returns the tree the contract covers (read before
    and after ``run``)."""

    name: str                 # e.g. "serve.serve_window"
    prepare: Callable[[], tuple[Callable[[], Any], Callable[[], Any]]]
    location: str             # repo-path-like location of the dispatch
    #: What must be updated in place, or ``None`` for a *read-only*
    #: dispatch that must leave the state as it found it (the serve
    #: shadow checksum, which reads live state the session still owns).
    updated: str | None = "decode state"
    #: The :class:`~repro_torch.serve.engine.ServeSession` dispatch kind
    #: this entry covers (``"admit"``, ``"window"``), on a dense or a paged
    #: engine; ``None`` for a dispatch a replica does not issue.
    kind: str | None = None
    paged: bool = False


def _leaves(tree):
    import torch

    from repro_torch.tree import tree_paths

    return [(p, x) for p, x in tree_paths(tree) if isinstance(x, torch.Tensor)]


def _version(x):
    """The tensor's version counter, or ``None`` where it keeps none (an
    inference-mode tensor)."""
    return None if x.is_inference() else x._version


def _bits(x):
    import torch

    return x.detach().reshape(-1).view(torch.uint8).clone()


def check_entry(entry: DispatchEntry) -> list[Finding]:
    """Run ``entry`` once; require every leaf of its state updated in place
    (or, for a read-only entry, left unwritten)."""
    import torch

    try:
        run, state = entry.prepare()
        before = _leaves(state())
        ptrs = [x.data_ptr() for _, x in before]
        versions = [_version(x) for _, x in before]
        bits = [_bits(x) for _, x in before] if entry.updated is None else None
        run()
        after = dict(_leaves(state()))
    except Exception as e:  # noqa: BLE001 — a dispatch that fails IS a finding
        return [error(
            PASS, entry.location,
            f"{entry.name}: failed to run for audit: {e!r}",
        )]
    if entry.updated is None:
        written = [
            p for (p, x), v, b in zip(before, versions, bits)
            if after.get(p) is not x
            or (v is not None and _version(x) != v)
            or not torch.equal(_bits(x), b)
        ]
        if written:
            return [error(
                PASS, entry.location,
                f"{entry.name}: read-only dispatch wrote its state "
                f"({len(written)} leaves, first {written[:3]}) — it would "
                f"change live state the serve loop still owns",
                leaves_written=len(written),
            )]
        return [info(
            PASS, entry.location,
            f"{entry.name}: read-only, {len(before)} state leaves unwritten",
            leaves=len(before),
        )]
    paths = [p for p, _ in before]
    rebound = [p for p, x in before if after.get(p) is not x]
    moved = [p for (p, x), ptr in zip(before, ptrs)
             if after.get(p) is x and x.data_ptr() != ptr]
    extra = sorted(set(after) - set(paths))
    if rebound or moved or extra:
        what = "; ".join(
            f"{label} {len(ps)} (first {ps[:3]})"
            for label, ps in (("rebound", rebound), ("storage moved", moved),
                              ("new", extra)) if ps)
        return [error(
            PASS, entry.location,
            f"{entry.name}: the {entry.updated} is not updated in place — "
            f"{what}: a copy of the state per dispatch",
            leaves_rebound=len(rebound) + len(moved) + len(extra),
        )]
    return [info(
        PASS, entry.location,
        f"{entry.name}: {entry.updated} updated in place ({len(paths)} leaves "
        f"keep their tensors and storage)",
        leaves=len(paths),
    )]


def run(cfg, *, device=None) -> list[Finding]:
    """Audit every registered serve and train dispatch for ``cfg``,
    reduced to its smoke-size family member (the contract does not depend
    on shapes, and the audit executes), on ``device`` (``None``: the
    card)."""
    from repro_torch.analysis.registry import dispatch_entries
    from repro_torch.kernels.common import resolve_device

    findings: list[Finding] = []
    for entry in dispatch_entries(cfg.reduced(), resolve_device(device)):
        findings += check_entry(entry)
    return findings
