"""Pass registry + registered-dispatch aggregation.

Passes are registered here by name; the dispatches that update state are
*not*: they are declared next to the code they describe
(:func:`repro_torch.serve.engine.audit_dispatch_entrypoints`,
:func:`repro_torch.train.step.audit_dispatch_entrypoints`) and aggregated
by :func:`dispatch_entries`, so adding a dispatch and registering it for
audit is one diff in one file.
"""

from __future__ import annotations

import importlib

from repro_torch.analysis.findings import Finding

#: Arch families the CLI audits by default: one per layer pattern family
#: (pure RWKV, recurrent + local hybrid, local/global attention).
DEFAULT_ARCHS = ("rwkv6-1.6b", "recurrentgemma-2b", "gemma3-1b")

#: pass name -> module (each exposes ``run(cfg) -> list[Finding]`` and a
#: ``PASS`` constant matching its key here), in the reference's order: the
#: torch-free host-tier AST audit first, the launch geometry's integer math
#: next, then the passes that build states and trace programs on the
#: ``meta`` device, then the three that execute dispatches on a device
#: (``device``: the card unless the caller names another) — so a host-code
#: or geometry error surfaces before anything runs.
PASS_MODULES = {
    "hostsafety": "repro_torch.analysis.hostsafety",
    "resources": "repro_torch.analysis.resources",
    "ringslack": "repro_torch.analysis.ringslack",
    "paging": "repro_torch.analysis.paging",
    "dtype_flow": "repro_torch.analysis.dtype_flow",
    "collectives": "repro_torch.analysis.collectives",
    "donation": "repro_torch.analysis.donation",
    "fleet": "repro_torch.analysis.fleet",
    "retrace": "repro_torch.analysis.retrace",
}


def get_pass(name: str):
    if name not in PASS_MODULES:
        raise KeyError(
            f"unknown analysis pass {name!r}; have {sorted(PASS_MODULES)}"
        )
    return importlib.import_module(PASS_MODULES[name])


def dispatch_entries(cfg, device=None):
    """Every registered state-updating dispatch for ``cfg`` (serve +
    train), built on ``device`` when an entry is prepared."""
    from repro_torch.serve import engine
    from repro_torch.train import step

    return list(engine.audit_dispatch_entrypoints(cfg, device=device)) + list(
        step.audit_dispatch_entrypoints(cfg, device=device)
    )


def run_passes(cfg, passes=None, **kw) -> list[Finding]:
    """Run ``passes`` (default: all, in registry order) over ``cfg``.
    Keyword arguments go to every pass that takes them (``sms`` to
    ``resources``, ``device`` to the executing passes)."""
    import inspect

    names = list(PASS_MODULES) if passes is None else list(passes)
    findings: list[Finding] = []
    for name in names:
        run = get_pass(name).run
        params = inspect.signature(run).parameters
        findings += run(cfg, **{k: v for k, v in kw.items() if k in params})
    return findings
