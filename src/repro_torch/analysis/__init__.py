"""repro_torch.analysis: audits of the port's contracts — static passes that
launch nothing, then three that run dispatches on a tiny state.

Passes (each ``repro_torch.analysis.<name>.run(cfg) -> list[Finding]``):

* ``hostsafety`` — a torch-free AST audit of the host tier: lock
  discipline across the watchdog, saver and monitor threads, and the two
  hazards of updating state in place (a retry after the dispatched
  function began writing; a background thread handed a tree its caller
  goes on updating) (``TORCH_FREE = True``: runs before anything imports
  torch);
* ``resources`` — every kernel launch's geometry and shared memory, from
  its own planner at the arch's full-width shapes, against the card's
  limits;
* ``ringslack`` — local-attention ring slack for windowed decode;
* ``paging`` — page-table well-formedness, audit liveness and pool bytes;
* ``dtype_flow`` — bf16 in, bf16 out and f32 state on the WKV and
  elevator-scan dispatches, traced on ``meta``: no caller-side upcast
  outside the kernel boundary, the f32 accumulation witnessed;
* ``collectives`` — what crosses the seq axis: the sequence-parallel WKV
  run forward and backward on ``meta`` shards, its hop log held to the
  summary budget, no gather-class hop, reverse hops in the backward, and
  the counted bytes against the cost model;
* ``donation`` — every registered serve and train dispatch run once: its
  state updated in place (every leaf keeps its tensor and storage), the
  shadow checksum read-only;
* ``fleet`` — the handoff contracts: every dispatch kind a replica issues
  registered, the checksum rows of each admission and window, the
  snapshot meta layout;
* ``retrace`` — a ragged serve session and one ``generate``: one shape a
  serve window, one an admission bucket, the planners' caches bounded.

The last three execute on ``device`` (the card unless the caller names
another).

CLI: ``python -m repro_torch.analysis --arch rwkv6-1.6b [--strict]
[--json] [--sms N] [--device cpu]``; ``--passes hostsafety --strict``
imports no torch.

This module imports lazily (no torch at import time) so the host-tier CLI
stays torch-free.
"""

from __future__ import annotations

_LAZY = {
    "Finding": ("repro_torch.analysis.findings", "Finding"),
    "Severity": ("repro_torch.analysis.findings", "Severity"),
    "errors": ("repro_torch.analysis.findings", "errors"),
    "format_table": ("repro_torch.analysis.findings", "format_table"),
    "DEFAULT_ARCHS": ("repro_torch.analysis.registry", "DEFAULT_ARCHS"),
    "PASS_MODULES": ("repro_torch.analysis.registry", "PASS_MODULES"),
    "run_passes": ("repro_torch.analysis.registry", "run_passes"),
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        import importlib

        mod, attr = _LAZY[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(f"module 'repro_torch.analysis' has no attribute {name!r}")
