"""Hill-climbing on the production mesh: A/B config variants of three cells
(counterpart of ``repro.launch.hillclimb``).

Each experiment is (cell, variant name, config transform), the
reference's three cells, each with its baseline and the reference's ten
variants in all, with the same transforms.  For
each variant the port traces one card's program of the sharded step on
the H100 production mesh (data=32, model=8), on ``meta``
(:func:`repro_torch.launch.dryrun.production_row`, on the mesh's
representative form), and writes that card's roofline terms, its
collective bytes by op and by mesh axis, and its peak: the state's share
plus the step's live-bytes peak.  The numbers are modeled on the CPU; no
card is touched.

Usage::

  PYTHONPATH=src python -m repro_torch.launch.hillclimb --cell moe   # qwen3-moe train_4k
  PYTHONPATH=src python -m repro_torch.launch.hillclimb --cell vl    # qwen2-vl prefill_32k
  PYTHONPATH=src python -m repro_torch.launch.hillclimb --cell rwkv  # rwkv6 train_4k
  PYTHONPATH=src python -m repro_torch.launch.hillclimb --cell moe --variant a2a

Rows go to ``build/hillclimb/`` (``.gitignore`` lists ``build/``), or
``--out``.  Exit status 1 if any variant failed.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path

from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import get_config
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_mod

__all__ = ["DEFAULT_OUT", "_variants", "run_variant", "main"]

DEFAULT_OUT = Path(__file__).resolve().parents[3] / "build" / "hillclimb"


def _variants():
    """cell key -> (arch, shape, {variant: transform}): the reference's."""
    return {
        "moe": (
            "qwen3-moe-235b-a22b", "train_4k",
            {
                "baseline": lambda c: c,
                # H1: the a2a dispatch in place of the gather MoE (which
                # all-gathers the token activations per layer): a MoE
                # layer's bytes drop from O(tokens*d*tp) to 2*k*cf*tokens*d.
                "a2a": lambda c: dataclasses.replace(c, moe_impl="a2a"),
                # H2: a2a + fewer microbatches: fewer FSDP re-gathers, more
                # activation memory.
                "a2a_mb8": lambda c: dataclasses.replace(c, moe_impl="a2a", microbatch=8),
                # H3: lighter remat: keep the products, recompute the rest.
                "a2a_remat_dots": lambda c: dataclasses.replace(
                    c, moe_impl="a2a", remat="dots"),
                # H4: ZeRO-3 weight gathering in place of moving the
                # activations (activations >> weights at 4k tokens).
                "a2a_wgather": lambda c: dataclasses.replace(
                    c, moe_impl="a2a", fsdp_gather_weights=True),
            },
        ),
        "vl": (
            "qwen2-vl-7b", "prefill_32k",
            {
                "baseline": lambda c: c,
                # H1: 28 heads do not divide the model axis: pad to 32.
                "head_pad32": lambda c: dataclasses.replace(c, head_pad=4),
                # H2: head padding + chunked prefill (4 chunks).
                "head_pad32_chunked": lambda c: dataclasses.replace(
                    c, head_pad=4, prefill_chunks=4),
                # H3: weight gathering on top.
                "head_pad32_wgather": lambda c: dataclasses.replace(
                    c, head_pad=4, fsdp_gather_weights=True),
            },
        ),
        "rwkv": (
            "rwkv6-1.6b", "train_4k",
            {
                "baseline": lambda c: c,
                # H1: microbatch 2 -> 1 halves the per-step re-gathers.
                "mb1": lambda c: dataclasses.replace(c, microbatch=1),
                # H2: lighter remat on top.
                "mb1_remat_dots": lambda c: dataclasses.replace(
                    c, microbatch=1, remat="dots"),
                # H3: weight gathering (contracting FSDP-sharded weight dims
                # moves the activations).
                "mb1_wgather": lambda c: dataclasses.replace(
                    c, microbatch=1, fsdp_gather_weights=True),
            },
        ),
    }


def run_variant(arch, shape_name, name, transform, out_dir: Path | None, *,
                mesh=None, cfg=None, shape=None, verbose: bool = True) -> dict:
    """One variant's row: ``transform`` of the arch's config (or of
    ``cfg``), one card's program traced on the representative form of
    ``mesh`` (default: the production mesh) at ``shape`` (a
    :class:`~repro_torch.configs.base.ShapeConfig`, default
    ``SHAPES[shape_name]``).  Written to ``out_dir`` when given."""
    result = {"arch": arch, "shape": shape_name, "variant": name}
    t0 = time.time()
    try:
        cfg_v = transform(cfg if cfg is not None else get_config(arch))
        shape = shape if shape is not None else SHAPES[shape_name]
        mesh = mesh if mesh is not None else mesh_mod.make_production_mesh()
        row = dryrun.production_row(cfg_v, shape, mesh)
        pc, memory = row["per_card"], row["memory"]
        result["mesh"] = "x".join(map(str, mesh.shape.values()))
        result["roofline"] = pc["roofline"]
        result["collectives_by_op"] = {k: v["bytes"] for k, v in pc["collectives"].items()
                                       if isinstance(v, dict)}
        result["collectives_by_axis"] = pc["collectives_by_axis"]
        result["cost"] = pc["cost"]
        result["state_bytes_per_card"] = memory["state_bytes_per_card"]
        result["peak_bytes"] = memory["peak_estimate_bytes"]
        result["ok"] = True
    except Exception as e:  # noqa: BLE001 — reported as a failed variant
        result["ok"] = False
        result["error"] = f"{type(e).__name__}: {e}"
        result["traceback"] = traceback.format_exc()[-3000:]
    result["total_s"] = round(time.time() - t0, 1)
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / f"{arch}__{shape_name}__{name}.json").write_text(
            json.dumps(result, indent=1))
    if verbose:
        r = result.get("roofline", {})
        status = "OK" if result["ok"] else f"FAIL {result.get('error', '')[:60]}"
        print(f"[{status}] {arch} {shape_name} {name}: "
              f"comp={r.get('compute_s', 0):.4f}s coll={r.get('collective_s', 0):.4f}s "
              f"mem={r.get('memory_s', 0):.3f}s "
              f"peak={(result.get('peak_bytes') or 0) / 2**30:.2f}GiB ({result['total_s']}s)",
              flush=True)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", choices=["moe", "vl", "rwkv"], required=True)
    ap.add_argument("--variant", default=None)
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    args = ap.parse_args(argv)

    arch, shape, variants = _variants()[args.cell]
    todo = {args.variant: variants[args.variant]} if args.variant else variants
    failures = 0
    for name, transform in todo.items():
        res = run_variant(arch, shape, name, transform, Path(args.out))
        failures += 0 if res["ok"] else 1
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
