"""Structured findings: the one result type every analysis pass returns.

A pass reads source, plans and host-side state (it never launches a
kernel) and reports what it proved or failed to prove as a list of
:class:`Finding`s — each with a severity, the pass that produced it, a
repo-path-like location (``src/repro_torch/serve/engine.py:ServeEngine._dispatch``)
so the reader can jump to the contract being checked, a one-line message,
and optional numeric metrics (byte counts, blocks an SM, page counts).

A copy of the reference's ``repro.analysis.findings``: the same types, the
same severity contract and the same table.

Severity contract:

* ``ERROR`` — a static invariant is violated: shipping this would
  regress a guarantee the repo relies on (a retry after an in-place write
  began, a shared-memory blowout, a dead page-table audit).  The CLI
  exits nonzero.
* ``WARN`` — suspicious but not provably wrong (e.g. a chunk request
  the dispatch had to adjust).  ``--strict`` promotes these to the
  exit code.
* ``INFO`` — the positive evidence: what was audited and the numbers
  that came out (counted bytes, blocks an SM), kept in the table so a
  clean run still shows *what* was proven, not just silence.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any


class Severity(enum.IntEnum):
    INFO = 0
    WARN = 1
    ERROR = 2

    def __str__(self) -> str:  # table cells: "error", not "Severity.ERROR"
        return self.name.lower()


@dataclasses.dataclass(frozen=True)
class Finding:
    """One fact a pass established (or failed to establish)."""

    pass_name: str           # e.g. "resources", "hostsafety"
    severity: Severity
    location: str            # repo-path-like: "src/.../engine.py:ServeEngine._dispatch"
    message: str
    metrics: dict[str, Any] = dataclasses.field(default_factory=dict)

    def with_pass(self, pass_name: str) -> "Finding":
        return dataclasses.replace(self, pass_name=pass_name)


def info(pass_name: str, location: str, message: str, **metrics) -> Finding:
    return Finding(pass_name, Severity.INFO, location, message, metrics)


def warn(pass_name: str, location: str, message: str, **metrics) -> Finding:
    return Finding(pass_name, Severity.WARN, location, message, metrics)


def error(pass_name: str, location: str, message: str, **metrics) -> Finding:
    return Finding(pass_name, Severity.ERROR, location, message, metrics)


def errors(findings: list[Finding]) -> list[Finding]:
    return [f for f in findings if f.severity >= Severity.ERROR]


def worst(findings: list[Finding]) -> Severity:
    return max((f.severity for f in findings), default=Severity.INFO)


def format_table(findings: list[Finding], *, title: str | None = None) -> str:
    """Render findings as a fixed-width table, most severe first."""
    lines: list[str] = []
    if title:
        lines.append(title)
    if not findings:
        lines.append("  (no findings)")
        return "\n".join(lines)
    rows = []
    for f in sorted(findings, key=lambda f: (-int(f.severity), f.pass_name)):
        met = " ".join(f"{k}={v}" for k, v in f.metrics.items())
        rows.append((str(f.severity), f.pass_name, f.location,
                     f.message + (f"  [{met}]" if met else "")))
    widths = [max(len(r[i]) for r in rows) for i in range(3)]
    for sev, pas, loc, msg in rows:
        lines.append(
            f"  {sev:<{widths[0]}}  {pas:<{widths[1]}}  {loc:<{widths[2]}}  {msg}"
        )
    return "\n".join(lines)
