"""CLI: run the analysis passes and print a findings table.

  PYTHONPATH=src python -m repro_torch.analysis --strict          # default archs, on the card
  PYTHONPATH=src python -m repro_torch.analysis --strict --device cpu
  PYTHONPATH=src python -m repro_torch.analysis --arch gemma3-1b --strict --device cpu
  PYTHONPATH=src python -m repro_torch.analysis --passes hostsafety --strict
  PYTHONPATH=src python -m repro_torch.analysis --sms 114         # an H100 PCIe
  PYTHONPATH=src python -m repro_torch.analysis --passes collectives --strict

Exit status: nonzero iff any ERROR finding (``--strict``: WARN too).
``--json`` emits the findings as a machine-readable JSON array instead of
tables (same exit-status contract), in the reference's row shape.

``--sms N`` is the SM count the kernels' planners plan for (default 132,
the H100 SXM); ``chip_smoke.py`` passes the card's own.  ``--device`` is
where the executing passes (``donation``, ``fleet``, ``retrace``) run their
dispatches: the card by default, as every entry point of the port, or
``cpu``, where the kernels' plain versions run; ``dtype_flow`` traces on
``meta`` wherever it runs.

When every selected pass declares ``TORCH_FREE = True`` (``hostsafety``),
the CLI imports neither torch nor a config and runs each pass once: an AST
audit of host code does not vary by arch.
"""

from __future__ import annotations

import argparse
import json
import sys


def _emit(findings_by_label, as_json: bool, sms) -> None:
    if as_json:
        rows = [
            {
                "arch": label,
                "pass": f.pass_name,
                "severity": f.severity.name,
                "location": f.location,
                "message": f.message,
                "metrics": dict(f.metrics),
            }
            for label, findings in findings_by_label
            for f in findings
        ]
        json.dump(rows, sys.stdout, indent=2)
        print()
        return
    from repro_torch.analysis.findings import format_table

    for label, findings in findings_by_label:
        plan = "" if sms is None else f" planned for {sms} SMs"
        print(format_table(
            findings, title=f"{label} — {len(findings)} findings{plan}"))
        print()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis")
    ap.add_argument("--arch", action="append", default=None,
                    help="arch family to audit (repeatable; default: the "
                         "registry's DEFAULT_ARCHS)")
    ap.add_argument("--passes", default=None,
                    help="comma-separated subset of passes to run")
    ap.add_argument("--strict", action="store_true",
                    help="treat WARN findings as failures too")
    ap.add_argument("--json", action="store_true",
                    help="emit findings as a JSON array instead of tables")
    ap.add_argument("--sms", type=int, default=None,
                    help="SM count the kernels' planners plan for "
                         "(default 132, the H100 SXM)")
    ap.add_argument("--device", default=None,
                    help="device the executing passes run their dispatches on "
                         "(default: the card; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)

    from repro_torch.analysis.findings import Severity, worst
    from repro_torch.analysis.registry import DEFAULT_ARCHS, get_pass, run_passes

    passes = args.passes.split(",") if args.passes else None

    # Torch-free fast path: an AST audit of host source does not vary by
    # arch and must not pay for a torch import.
    if passes is not None and all(
            getattr(get_pass(p), "TORCH_FREE", False) for p in passes):
        findings = []
        for p in passes:
            findings += get_pass(p).run(None)
        _emit([("host", findings)], args.json, None)
        top = worst(findings)
        bad = top >= Severity.ERROR or (args.strict and top >= Severity.WARN)
        return 1 if bad else 0

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.common import H100_SMS

    archs = args.arch or list(DEFAULT_ARCHS)
    sms = H100_SMS if args.sms is None else args.sms
    failed = False
    results = []
    for arch in archs:
        cfg = get_config(arch)
        findings = run_passes(cfg, passes, sms=sms, device=args.device)
        results.append((arch, findings))
        top = worst(findings)
        if top >= Severity.ERROR or (args.strict and top >= Severity.WARN):
            failed = True
    _emit(results, args.json, sms)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
