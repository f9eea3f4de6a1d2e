"""Every plan of the CUDA matmul beside the planner's choice, on the card.

For each product the script launches ``kernels/matmul_fwd/csrc/matmul_fwd.cu``
with every output tile of the variant that ``kernel.plan`` picks and every
split of K into whole k-tiles (at most ``MAX_SPLIT``), through
``kernel.launch_plan``, which counts no launch.  It checks each plan's C
against the plain version (``card_checks.matmul_error``), times it as
``chip_smoke.py``'s phase 4 does (device µs per call, the calls queued
behind ``torch.cuda._sleep``, inputs cycled through more bytes than the
L2), and prints one JSON object a product: the planner's plan and time, the
fastest plan and time, and ``torch.matmul`` on the same operands (TF32
off).  The planner's rule for splitting K was set from this output.

    python -m repro_torch.benchmarks.matmul_plans [--shapes MxNxK,...] [--reps N]

runs on the card only, and raises without one.
"""

from __future__ import annotations

import argparse
import json
import math

import torch

from repro_torch.kernels import card_checks as CC
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.matmul_fwd import kernel as MK

#: (M, N, K): the Rodinia suite's 256^3 and deeper products of the same
#: output, the reference test's (512, 256) x (256, 384), and larger outputs
#: at a shallow and a deep K.
SHAPES = ((256, 256, 256), (256, 256, 1024), (256, 256, 4096), (512, 384, 256),
          (1024, 1024, 256), (1024, 1024, 2048), (2048, 2048, 512))


def _time_us(fn, arg_sets, reps):
    """Median over 5 rounds of the device µs per call of ``reps`` calls
    queued behind a sleep, cycling through ``arg_sets``."""
    for args in arg_sets[:2]:
        fn(*args)
    torch.cuda.synchronize()
    out, n = [], 0
    for _ in range(5):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000_000)
        e0.record()
        for _ in range(reps):
            fn(*arg_sets[n % len(arg_sets)])
            n += 1
        e1.record()
        e1.synchronize()
        out.append(e0.elapsed_time(e1) * 1e3 / reps)
    return sorted(out)[2]


def sweep(m, n, k, dtype, reps, device):
    """One product: every plan's time and check, the planner's choice, and
    ``torch.matmul``'s time."""
    nbytes = (m * k + k * n + m * n) * torch.tensor([], dtype=dtype).element_size()
    g = torch.Generator(device=device).manual_seed(0)
    sets = [(torch.randn((m, k), generator=g, device=device).to(dtype),
             torch.randn((k, n), generator=g, device=device).to(dtype))
            for _ in range(max(2, math.ceil(128 * 2**20 / nbytes)))]
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    chosen = MK.plan(m, n, k, dtype, sms)
    variant = chosen[0]
    _, k_step, _, tiles = MK.VARIANTS[variant]
    k_tiles = -(-k // k_step)
    splits = [d for d in range(1, min(k_tiles, MK.MAX_SPLIT) + 1) if k_tiles % d == 0]
    want = MK.matmul_ref(*sets[0])
    plans = []
    for tile_m, tile_n in tiles:
        for split in splits:
            p = (variant, tile_m, tile_n, split)
            ratio = CC.matmul_error(MK.launch_plan(*sets[0], *p), want)[2]
            if ratio > 1.0:
                raise SystemExit(f"matmul plan {p} at {m}x{n}x{k} {dtype}: error "
                                 f"{ratio:.3f} x its tolerance")
            plans.append({"plan": p, "us": _time_us(
                lambda a, b, p=p: MK.launch_plan(a, b, *p), sets, reps)})
    best = min(plans, key=lambda r: r["us"])
    return {"shape": f"{m}x{n}x{k}", "dtype": str(dtype).split(".")[-1], "sms": sms,
            "planner": {"plan": chosen,
                        "us": next(r["us"] for r in plans if r["plan"] == chosen)},
            "fastest": best, "torch_matmul_us": _time_us(torch.matmul, sets, reps),
            "plans": plans}


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", default=None,
                    help="comma-separated MxNxK (default: the module's SHAPES)")
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args(argv)
    device = resolve_device(None)
    torch.backends.cuda.matmul.allow_tf32 = False
    shapes = SHAPES if args.shapes is None else [
        tuple(int(x) for x in s.split("x")) for s in args.shapes.split(",")]
    rows = []
    for m, n, k in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            row = sweep(m, n, k, dtype, args.reps, device)
            print(json.dumps(row), flush=True)
            rows.append(row)
    return rows


if __name__ == "__main__":
    main()
