"""repro_torch.analysis: static audits of the port, run before anything
launches.

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
* ``paging`` — page-table well-formedness, audit liveness and pool bytes.

CLI: ``python -m repro_torch.analysis --arch rwkv6-1.6b [--strict]
[--json] [--sms N]``; ``--passes hostsafety --strict`` imports no torch.

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
