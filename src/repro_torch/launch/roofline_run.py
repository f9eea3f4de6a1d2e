"""The full cell's cost for the roofline (counterpart of
``repro.launch.roofline_run``).

The reference extrapolates: XLA's cost analysis visits a ``lax.scan``
body once, so it lowers reduced-depth models fully unrolled at two depths
(and two microbatch counts) and solves ``cost(L, m) = a + b L + c m + d L
m`` for the full cell.  The port needs no extrapolation: a meta trace runs
every period and microbatch as the step calls them, so the full cell is
counted directly, and its one point is the full cell.  The return keys are
the reference's.
"""

from __future__ import annotations

from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import get_config
from repro_torch.launch import roofline as R
from repro_torch.model.transformer import plan_groups

__all__ = ["extrapolated_costs"]


def _costs(counter, hops=()) -> dict:
    ca = R.cost_analysis_dict(counter)
    coll = R.parse_collective_bytes(hops)
    return {
        "flops": ca["flops"],
        "flops_by_class": ca["flops_by_class"],
        "bytes": ca["bytes accessed"],
        "coll": float(coll["total_bytes"]),
        "coll_by_op": {k: v["bytes"] for k, v in coll.items() if isinstance(v, dict)},
    }


def extrapolated_costs(arch: str, shape_name: str, counter, hops=()) -> dict:
    """The cost of the FULL cell, counted directly from its one meta trace
    (``counter``, the :class:`~repro_torch.core.lowering.CostCounter` of
    :func:`repro_torch.launch.dryrun.trace_cell`, and ``hops``, the
    collectives it logged: none without a mesh)."""
    cfg = get_config(arch)
    _, n_periods, _ = plan_groups(cfg)
    total = _costs(counter, hops)
    return {
        "extrapolated": total,
        "n_periods": n_periods,
        "n_micro": cfg.microbatch if SHAPES[shape_name].kind == "train" else 1,
        "points": {"full": total},
    }
