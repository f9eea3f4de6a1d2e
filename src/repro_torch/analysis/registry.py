"""Pass registry: the port's passes by name, in the order they run, and
:func:`run_passes` over a config.

The reference's registry also aggregates its jitted entry points for the
passes that audit jaxprs and HLO; the port has no jits.  Its one such
pass, ``collectives``, runs its entry point (the sequence-parallel WKV)
itself and reads the hop log; the others (``dtype_flow``, ``donation``,
``fleet``, ``retrace``) are not ported (ROADMAP, Queue 1 item 8).
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
#: next, then the passes that build states on the ``meta`` device, then the
#: one that runs a program on ``meta`` shards.
PASS_MODULES = {
    "hostsafety": "repro_torch.analysis.hostsafety",
    "resources": "repro_torch.analysis.resources",
    "ringslack": "repro_torch.analysis.ringslack",
    "paging": "repro_torch.analysis.paging",
    "collectives": "repro_torch.analysis.collectives",
}


def get_pass(name: str):
    if name not in PASS_MODULES:
        raise KeyError(
            f"unknown analysis pass {name!r}; have {sorted(PASS_MODULES)}"
        )
    return importlib.import_module(PASS_MODULES[name])


def run_passes(cfg, passes=None, **kw) -> list[Finding]:
    """Run ``passes`` (default: all, in registry order) over ``cfg``.
    Keyword arguments go to every pass that takes them (``sms`` to
    ``resources``)."""
    import inspect

    names = list(PASS_MODULES) if passes is None else list(passes)
    findings: list[Finding] = []
    for name in names:
        run = get_pass(name).run
        params = inspect.signature(run).parameters
        findings += run(cfg, **{k: v for k, v in kw.items() if k in params})
    return findings
