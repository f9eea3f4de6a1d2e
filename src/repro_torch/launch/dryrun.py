"""One-card dry run: trace one step of every (arch x shape) cell on the meta
device (counterpart of ``repro.launch.dryrun``).

The reference lowers and compiles each cell for a 256-chip TPU pod on 512
placeholder host devices and reads XLA's memory and cost analyses.  The
port traces each cell's step as a user calls it, on ``meta`` tensors, under
:func:`repro_torch.core.lowering.cost_counting`: nothing is allocated and
nothing executes, yet every aten op and every kernel launch of the step is
seen, at full width and full depth.  From the trace it reports:

* ``memory``: the state the cell needs (parameters, optimizer moments,
  decode state and inputs; raw and rounded as the card's allocator rounds
  each tensor, to 512 bytes), the peak of the live bytes the step adds to
  it, their sum, and ``fits_one_card`` against the H100's 80 GiB less
  :data:`MEMORY_RESERVE`;
* ``cost``: FLOPs by class (aten ops and kernels), bytes accessed (the
  unfused upper bound for aten ops, each kernel's own bytes);
* ``launches``: each kernel's launches and the plans its planner chose;
* ``roofline``: the terms against the H100's peaks, the fused-execution
  estimate ``memory_analytic_s`` and ``dominant_fused``;
* ``model_flops`` and ``useful_flops_ratio`` (model FLOPs over traced).

Each cell is built as the reference builds it: train from
:func:`~repro_torch.train.step.abstract_train_state`, the batch specs and
``make_train_step``; prefill through ``make_prefill_step``; decode through
``make_decode_step`` with ``remat="none"`` and ``microbatch=1`` (and
``enc_out`` for the encoder-decoder arch).  :func:`make_cell` builds the
same step on any device, so the card can run what the meta trace counted.

Usage::

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-1b --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--out DIR]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --table [--out DIR]

Exit status 1 if any cell failed, else 0.

``--mesh production`` reads every cell on the H100 production mesh
(:func:`~repro_torch.launch.mesh.make_production_mesh`, 256 cards as
(data=32, model=8); ``--multi-pod`` the 512 of (pod=2, data=32, model=8);
``--both-meshes`` both) instead of tracing it on one card: each card's
share of the state (parameters, the optimizer moments of a train cell,
the decode state of a decode cell, and the inputs) from the spec trees
under the cell's rules, every dimension divided by its mesh axes' extent
and rounded up, as XLA pads, and whether that share fits the card's
:data:`~repro_torch.core.h100.HBM_BYTES`.  The per-card peak (the
activations) is not known until the dense layers run sharded: the row
says so.  Nothing is traced and no card is touched::

  PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh production --all
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path
from typing import Any, Callable

import torch

from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import get_config, list_archs
from repro_torch.core.lowering import CostCounter, cost_counting
from repro_torch.launch import inputs as I
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import roofline as R
from repro_torch.model import model as M
from repro_torch.model.layers import dtype_of
from repro_torch.model.sharding import axes_size, make_rules, to_pspec
from repro_torch.serve import engine
from repro_torch.train import step as train_mod
from repro_torch.tree import tree_leaves

__all__ = ["MESH_TAG", "MEMORY_RESERVE", "ALLOC_ROUND", "DEFAULT_OUT", "SkipCell", "Cell",
           "make_cell", "trace_cell", "run_cell", "tree_bytes", "production_mesh_tag",
           "per_card_bytes", "production_state", "run_production_cell", "main"]

#: Where ``--out`` defaults to: ``build/`` at the root of the checkout,
#: which ``.gitignore`` lists.
DEFAULT_OUT = Path(__file__).resolve().parents[3] / "build" / "dryrun"
#: The mesh of every cell: one card.
MESH_TAG = "1xH100"
#: What a cell may not count on of the card's 80 GiB: the CUDA context,
#: cuBLAS workspaces and the caching allocator's unused block tails.
MEMORY_RESERVE = 4 * 2**30
#: The caching allocator's rounding of every allocation.
ALLOC_ROUND = 512


class SkipCell(Exception):
    pass


def _mode_for(shape_name: str, kind: str) -> str:
    if kind == "train":
        return "train"
    if kind == "prefill":
        return "prefill"
    return "decode_long" if shape_name == "long_500k" else "decode"


def tree_bytes(tree) -> tuple[int, int]:
    """(bytes, bytes as the allocator holds them: each tensor rounded up to
    :data:`ALLOC_ROUND`) of every tensor leaf of ``tree``."""
    raw = alloc = 0
    for x in tree_leaves(tree):
        if isinstance(x, torch.Tensor):
            n = x.numel() * x.element_size()
            raw += n
            alloc += -(-n // ALLOC_ROUND) * ALLOC_ROUND if n else 0
    return raw, alloc


@dataclasses.dataclass
class Cell:
    """One cell's step on one device: ``run()`` calls it once as a user
    does (prefill and decode under ``torch.inference_mode()``); ``trees``
    holds what it needs resident (``params``, ``opt`` for training,
    ``decode_state``, ``inputs``)."""

    cfg: Any
    shape: Any
    trees: dict
    run: Callable[[], Any]

    def state_bytes(self) -> dict:
        parts = {k: tree_bytes(v) for k, v in self.trees.items()}
        return {
            "state_bytes": sum(p[0] for p in parts.values()),
            "state_bytes_allocated": sum(p[1] for p in parts.values()),
            "state_by_part": {k: p[0] for k, p in parts.items()},
        }


def _real_inputs(specs: dict, cfg, device, gen) -> dict:
    """Real tensors shaped like meta ``specs``: token ids below the
    vocabulary, N(0, 1) embeddings, positions 0..S-1."""
    out = {}
    for k, x in specs.items():
        if k == "positions":
            s = x.shape[-1]
            out[k] = torch.arange(s, device=device).expand(x.shape).contiguous()
        elif x.dtype in (torch.int64, torch.int32):
            out[k] = torch.randint(0, cfg.vocab_size, x.shape, generator=gen,
                                   dtype=x.dtype, device=device)
        else:
            out[k] = torch.randn(x.shape, generator=gen, device=device).to(x.dtype)
    return out


def make_cell(cfg, shape, *, device="meta", seed: int = 0) -> Cell:
    """The cell's step as the reference builds it, on ``device``: meta
    trees for the dry run, or random parameters and inputs from ``seed``
    on a real device (the card's check of the trace).  ``shape``: a name
    of :data:`SHAPES` or a :class:`~repro_torch.configs.base.ShapeConfig`."""
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    device = torch.device(device)
    meta = device.type == "meta"
    gen = None if meta else torch.Generator(device=device).manual_seed(seed)
    if shape.kind == "decode":
        cfg = dataclasses.replace(cfg, remat="none", microbatch=1)
    if shape.kind == "train":
        state = (train_mod.abstract_train_state(cfg) if meta
                 else train_mod.init_train_state(cfg, seed, device=device))
        batch, _ = I.batch_specs(cfg, shape)
        batch = batch if meta else _real_inputs(batch, cfg, device, gen)
        step = train_mod.make_train_step(cfg)
        return Cell(cfg, shape, {"params": state.params, "opt": state.opt, "inputs": batch},
                    lambda: step(state, batch))
    params = M.abstract_params(cfg) if meta else M.init_params(cfg, seed, device=device)
    if shape.kind == "prefill":
        batch, _ = I.batch_specs(cfg, shape)
        batch = batch if meta else _real_inputs(batch, cfg, device, gen)
        prefill = engine.make_prefill_step(cfg)
        kw = {}
        if "frontend_embeds" in batch:
            kw["frontend_embeds"] = batch["frontend_embeds"]
        if "positions" in batch:
            kw["positions"] = batch["positions"]
        if "enc_embeds" in batch:
            kw["enc_tokens_embeds"] = batch["enc_embeds"]

        def run_prefill():
            with torch.inference_mode():
                return prefill(params, batch["tokens"], **kw)

        return Cell(cfg, shape, {"params": params, "inputs": batch}, run_prefill)
    state, tokens, length, extras, _ = I.decode_specs(cfg, shape)
    if not meta:
        state = M.init_decode_state(cfg, shape.global_batch, shape.seq_len, device=device)
        tokens = _real_inputs({"tokens": tokens}, cfg, device, gen)["tokens"]
        length = torch.tensor(shape.seq_len - 1, dtype=torch.int32, device=device)
        extras = {k: torch.randn(v.shape, generator=gen, device=device).to(dtype_of(cfg))
                  for k, v in extras.items()}
    decode = engine.make_decode_step(cfg)

    def run_decode():
        with torch.inference_mode():
            return decode(params, state, tokens, length, **extras)

    inputs = {"tokens": tokens, "length": length, **extras}
    return Cell(cfg, shape, {"params": params, "decode_state": state, "inputs": inputs},
                run_decode)


def trace_cell(arch: str, shape_name: str) -> tuple[Cell, CostCounter, Any]:
    """Trace one step of the cell on the meta device: (cell, counter,
    the step's outputs).  Raises :class:`SkipCell` for an inapplicable
    cell (the counterpart of the reference's ``lower_cell``)."""
    cfg = get_config(arch)
    ok, why = I.cell_is_applicable(cfg, shape_name)
    if not ok:
        raise SkipCell(why)
    cell = make_cell(cfg, shape_name, device="meta")
    with cost_counting() as counter:
        out = cell.run()
    return cell, counter, out


def _memory(cell: Cell, counter: CostCounter) -> dict:
    mem = cell.state_bytes()
    peak = mem["state_bytes"] + counter.peak_live
    mem.update({
        "peak_live_bytes": counter.peak_live,
        "peak_estimate_bytes": peak,
        "capacity_bytes": mesh_mod.HBM_BYTES,
        "reserve_bytes": MEMORY_RESERVE,
        "fits_one_card": peak <= mesh_mod.HBM_BYTES - MEMORY_RESERVE,
    })
    return mem


def run_cell(arch: str, shape_name: str, *, out_dir: Path | None = None,
             verbose: bool = True, roofline: bool = True) -> dict:
    """Trace one cell and return (and with ``out_dir`` write) its JSON row."""
    tag = f"{arch}__{shape_name}__{MESH_TAG}"
    result = {"arch": arch, "shape": shape_name, "mesh": MESH_TAG}
    t0 = time.time()
    try:
        cell, counter, _ = trace_cell(arch, shape_name)
        result["trace_s"] = round(time.time() - t0, 1)
        result["memory"] = _memory(cell, counter)
        result["cost"] = counter.as_dict()
        result["launches"] = counter.launches()
        result["kernel_plans"] = {n: k.plans for n, k in sorted(counter.kernels.items())}
        if roofline:
            from repro_torch.launch.roofline_run import extrapolated_costs

            ex = extrapolated_costs(arch, shape_name, counter)
            tot = ex["extrapolated"]
            terms = R.roofline_terms(
                {"flops": tot["flops"], "flops_by_class": tot["flops_by_class"],
                 "bytes accessed": tot["bytes"]},
                {"total_bytes": tot["coll"]})
            result["roofline"] = terms.as_dict()
            # The fused-execution estimate (the traced bytes are unfused).
            mode = _mode_for(shape_name, cell.shape.kind)
            ana = R.analytic_hbm_bytes(cell.cfg, cell.shape, 1, mode, tp=1)
            result["roofline"]["memory_analytic_s"] = ana / mesh_mod.HBM_BW
            result["roofline"]["hbm_bytes_analytic"] = ana
            terms_f = {
                "compute": result["roofline"]["compute_s"],
                "memory(fused est)": result["roofline"]["memory_analytic_s"],
                "collective": result["roofline"]["collective_s"],
            }
            result["roofline"]["dominant_fused"] = max(terms_f, key=terms_f.get)
            result["model_flops"] = R.model_flops(cell.cfg, cell.shape)
            result["useful_flops_ratio"] = (
                result["model_flops"] / tot["flops"] if tot["flops"] else None)
        result["ok"] = True
    except SkipCell as e:
        result["ok"] = True
        result["skipped"] = str(e)
    except Exception as e:  # noqa: BLE001 — reported as a failed cell
        result["ok"] = False
        result["error"] = f"{type(e).__name__}: {e}"
        result["traceback"] = traceback.format_exc()[-4000:]
    return _finish(tag, result, t0, out_dir, cell_line if verbose else None)


def _finish(tag: str, result: dict, t0: float, out_dir: Path | None, line) -> dict:
    """Time a cell's row, write it to ``out_dir`` (if given) as
    ``<tag>.json`` and print ``line(tag, result)`` (if given)."""
    result["total_s"] = round(time.time() - t0, 1)
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / f"{tag}.json").write_text(json.dumps(result, indent=1))
    if line is not None:
        print(line(tag, result), flush=True)
    return result


def cell_line(tag: str, result: dict) -> str:
    """One cell's printed line (the reference's format, plus the fit)."""
    status = "SKIP" if result.get("skipped") else ("OK" if result["ok"] else "FAIL")
    extra = ""
    if "roofline" in result:
        r = result["roofline"]
        extra = (f" dom={r.get('dominant_fused', r['dominant'])} "
                 f"comp={r['compute_s']:.4f}s mem={r['memory_s']:.4f}s "
                 f"memF={r.get('memory_analytic_s', 0):.4f}s "
                 f"coll={r['collective_s']:.4f}s")
    if "memory" in result:
        m = result["memory"]
        extra += (f" state={m['state_bytes'] / 2**30:.2f}GiB "
                  f"peak={m['peak_estimate_bytes'] / 2**30:.2f}GiB "
                  f"fits={m['fits_one_card']}")
    if "error" in result:
        extra += f" {result['error']}"
    return f"[{status}] {tag} ({result['total_s']}s){extra}"


def summary_table(out_dir: Path) -> str:
    """A markdown table of every cell's JSON row in ``out_dir``: fits one
    card, state and peak GiB, FLOPs bf16 / f32, bytes, the bound, the
    dominant term (traced bytes; the fused estimate), ``model_flops`` and
    the useful ratio; the skipped cells in one line below it."""
    lines = ["| Cell | Fits | State / peak GiB | FLOPs bf16 / f32 | Bytes | Bound ms "
             "| Dominant (fused) | model_flops | Useful |",
             "|---|---|---|---|---|---|---|---|---|"]
    skipped = []
    for path in sorted(out_dir.glob(f"*__{MESH_TAG}.json")):
        r = json.loads(path.read_text())
        cell = f"{r['arch']} {r['shape']}"
        if r.get("skipped") or "roofline" not in r:
            skipped.append(cell)
            continue
        m, c, f = r["memory"], r["cost"], r["roofline"]
        by = c["flops_by_class"]
        bound = max(f["compute_s"], f["memory_s"], f["collective_s"]) * 1e3
        lines.append(
            f"| {cell} | {'yes' if m['fits_one_card'] else 'no'} "
            f"| {m['state_bytes'] / 2**30:.2f} / {m['peak_estimate_bytes'] / 2**30:.2f} "
            f"| {by['bf16']:.3g} / {by['f32']:.3g} | {c['bytes_accessed']:.3g} "
            f"| {bound:.4g} | {f['dominant']} ({f['dominant_fused'].split('(')[0]}) "
            f"| {r['model_flops']:.3g} | {r['useful_flops_ratio']:.3f} |")
    if skipped:
        lines.append(f"\nSkipped: {', '.join(skipped)}.")
    return "\n".join(lines)


# --------------------------------------------------------------------------
# The production mesh: each card's share of the state, from the specs
# --------------------------------------------------------------------------

def production_mesh_tag(multi_pod: bool) -> str:
    """``32x8`` or ``2x32x8``: the production mesh's shape."""
    return "x".join(map(str, mesh_mod.PRODUCTION_SHAPE[multi_pod].values()))


def per_card_bytes(tree, specs, mesh) -> int:
    """Bytes one card holds of ``tree`` (meta tensors) split by ``specs``
    (a tree of :class:`~repro_torch.model.sharding.PartitionSpec` of the
    same structure) over ``mesh``: every dimension divided by the extent
    of its mesh axes and rounded up, as XLA pads an uneven split."""
    total = 0
    for x, spec in zip(tree_leaves(tree), tree_leaves(specs), strict=True):
        n = 1
        for i, size in enumerate(x.shape):
            n *= -(-size // axes_size(mesh, spec[i] if i < len(spec) else None))
        total += n * x.element_size()
    return total


def production_state(cfg, shape, mesh) -> dict:
    """``{part: (meta tree, spec tree)}`` of one cell on ``mesh``, built as
    the reference's ``lower_cell`` builds its shardings: the train state's
    specs and the batch's; the parameters' and the batch's for prefill;
    for decode (``remat="none"``, ``microbatch=1``) the parameters', the
    decode state's, the (B, 1) tokens', the replicated length's and
    ``enc_out``'s."""
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    rules = make_rules(mesh, _mode_for(shape.name, shape.kind))
    if shape.kind == "train":
        state = train_mod.abstract_train_state(cfg)
        specs = train_mod.train_state_pspecs(cfg, rules)
        batch, axes = I.batch_specs(cfg, shape)
        return {"params": (state.params, specs.params), "opt": (state.opt, specs.opt),
                "inputs": (batch, I.resolve_pspecs(axes, rules))}
    if shape.kind == "prefill":
        batch, axes = I.batch_specs(cfg, shape)
        return {"params": (M.abstract_params(cfg), M.param_pspecs(cfg, rules)),
                "inputs": (batch, I.resolve_pspecs(axes, rules))}
    dcfg = dataclasses.replace(cfg, remat="none", microbatch=1)
    state, tokens, length, extras, extras_axes = I.decode_specs(dcfg, shape)
    inputs = {"tokens": tokens, "length": length, **extras}
    in_specs = {"tokens": to_pspec(("batch", None), rules), "length": to_pspec((), rules),
                **I.resolve_pspecs(extras_axes, rules)}
    return {"params": (M.abstract_params(dcfg), M.param_pspecs(dcfg, rules)),
            "decode_state": (state, M.decode_state_pspecs(
                dcfg, shape.global_batch, shape.seq_len, rules)),
            "inputs": (inputs, in_specs)}


def run_production_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
                        out_dir: Path | None = None, verbose: bool = True) -> dict:
    """One cell's per-card state on the production mesh: its JSON row."""
    mesh_tag = production_mesh_tag(multi_pod)
    tag = f"{arch}__{shape_name}__{mesh_tag}"
    result = {"arch": arch, "shape": shape_name, "mesh": mesh_tag}
    t0 = time.time()
    try:
        cfg = get_config(arch)
        ok, why = I.cell_is_applicable(cfg, shape_name)
        if not ok:
            raise SkipCell(why)
        mesh = mesh_mod.make_production_mesh(multi_pod=multi_pod)
        parts = production_state(cfg, shape_name, mesh)
        by_part = {k: per_card_bytes(t, sp, mesh) for k, (t, sp) in parts.items()}
        per_card = sum(by_part.values())
        result["memory"] = {
            "cards": int(mesh.devices.size),
            "state_bytes": sum(tree_bytes(t)[0] for t, _ in parts.values()),
            "state_bytes_per_card": per_card,
            "state_per_card_by_part": by_part,
            "capacity_bytes": mesh_mod.HBM_BYTES,
            "state_fits": per_card <= mesh_mod.HBM_BYTES,
            "peak_estimate_bytes": None,
            "peak_note": "the per-card peak (activations) is not known until the "
                         "dense layers run sharded",
        }
        result["ok"] = True
    except SkipCell as e:
        result["ok"] = True
        result["skipped"] = str(e)
    except Exception as e:  # noqa: BLE001 — reported as a failed cell
        result["ok"] = False
        result["error"] = f"{type(e).__name__}: {e}"
        result["traceback"] = traceback.format_exc()[-4000:]
    return _finish(tag, result, t0, out_dir, production_line if verbose else None)


def production_line(tag: str, result: dict) -> str:
    """One production-mesh cell's printed line."""
    status = "SKIP" if result.get("skipped") else ("OK" if result["ok"] else "FAIL")
    extra = ""
    if "memory" in result:
        m = result["memory"]
        parts = " ".join(f"{k}={v / 2**30:.2f}" for k, v in m["state_per_card_by_part"].items())
        extra = (f" state/card={m['state_bytes_per_card'] / 2**30:.2f}GiB ({parts}) "
                 f"of {m['cards']} cards, fits={m['state_fits']}, peak not known")
    if "error" in result:
        extra += f" {result['error']}"
    return f"[{status}] {tag} ({result['total_s']}s){extra}"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--no-roofline", action="store_true")
    ap.add_argument("--table", action="store_true",
                    help="only print the markdown table of the rows in --out")
    ap.add_argument("--mesh", choices=("one", "production"), default="one",
                    help="trace each cell on one card (default), or read each card's "
                         "share of its state on the production mesh")
    args = ap.parse_args(argv)

    out_dir = Path(args.out)
    if args.table:
        print(summary_table(out_dir))
        return
    archs = [args.arch] if args.arch else list(list_archs())
    shapes = [args.shape] if args.shape else list(SHAPES)
    failures = 0
    if args.mesh == "production" or args.multi_pod or args.both_meshes:
        meshes = [False, True] if args.both_meshes else [args.multi_pod]
        for multi_pod in meshes:
            for arch in archs:
                for shape in shapes:
                    res = run_production_cell(arch, shape, multi_pod=multi_pod,
                                              out_dir=out_dir)
                    failures += 0 if res["ok"] else 1
        print(f"done; failures={failures}", flush=True)
        raise SystemExit(1 if failures else 0)
    for arch in archs:
        for shape in shapes:
            tag = f"{arch}__{shape}__{MESH_TAG}"
            if args.skip_existing and (out_dir / f"{tag}.json").exists():
                prev = json.loads((out_dir / f"{tag}.json").read_text())
                if prev.get("ok"):
                    print(f"[CACHED] {tag}", flush=True)
                    continue
            res = run_cell(arch, shape, out_dir=out_dir, roofline=not args.no_roofline)
            failures += 0 if res["ok"] else 1
    print(f"done; failures={failures}", flush=True)
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
