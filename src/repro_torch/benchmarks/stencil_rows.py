"""The 5-point stencil at PERF.md's row 13 shapes, timed on the card as
``chip_smoke.py``'s phase 4 times it, beside ``F.conv2d`` and the launch
floor.

For each grid (256 x 512, the Rodinia suite's hotspot; 8192 x 8192) the
script times ``stencil2d_cuda`` on f32 inputs cycled through more bytes
than the L2, and, where the checkout has a stencil plan, every rows-a-thread
tile through ``launch_plan``; then ``F.conv2d`` with the 3 x 3 cross
weights (``padding=1``, boundary 0, cuDNN TF32 off, ``cudnn.benchmark`` on,
checked against the kernel first) and the launch floor, an empty
``torch.cuda._sleep(0)`` timed the same way.  Device µs per call: the median
of 5 rounds of ``--reps`` calls queued behind ``torch.cuda._sleep``.  It
prints one JSON object a grid.  It uses only the wrapper's signature, so
pointing PYTHONPATH at a ``git archive`` of another commit times that
commit's kernel with the same script, and two commits compare in one call:

    PYTHONPATH=<checkout>/src python src/repro_torch/benchmarks/stencil_rows.py [--reps N]

runs on the card only, and raises without one.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess

import torch

#: Rodinia's hotspot coefficients (``benchmarks/rodinia.py:HOTSPOT``).
HOTSPOT = (0.6, 0.1, 0.1, 0.1, 0.1)
GRIDS = ((256, 512), (8192, 8192))
#: The card's memory rate (bytes/s), for the bytes bound.
HBM_BYTES_PER_S = 3.35e12


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
        torch.cuda._sleep(200_000_000)
        e0.record()
        for _ in range(reps):
            fn(*arg_sets[n % len(arg_sets)])
            n += 1
        e1.record()
        e1.synchronize()
        out.append(e0.elapsed_time(e1) * 1e3 / reps)
    return sorted(out)[2]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=100)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("stencil_rows: no CUDA device")
    from repro_torch.kernels.stencil2d import kernel as ST

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    F = torch.nn.functional
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    weight = torch.tensor([[0.0, HOTSPOT[1], 0.0], [HOTSPOT[3], HOTSPOT[0], HOTSPOT[4]],
                           [0.0, HOTSPOT[2], 0.0]], device=dev)[None, None]
    with torch.inference_mode():
        floor = _time_us(lambda: torch.cuda._sleep(0), [()] * 4, 200)
        for h, w in GRIDS:
            nbytes = 2 * h * w * 4 + 5 * 4
            n = max(2, math.ceil(128 * 2**20 / nbytes))
            g = torch.Generator(device=dev).manual_seed(h + w)
            c = torch.tensor(HOTSPOT, device=dev)
            sets = [(torch.randn((h, w), generator=g, device=dev), c) for _ in range(n)]
            reps = args.reps if h < 8192 else max(10, args.reps // 5)

            def conv2d(x, c):
                return F.conv2d(x[None, None], weight, padding=1)

            x = sets[0][0]
            err = float((conv2d(x, c)[0, 0] - ST.stencil2d_cuda(x, c)).abs().max())
            if err > 1e-5 * float(x.abs().max()):
                raise SystemExit(f"conv2d disagrees with stencil2d_cuda at {h}x{w}: {err}")
            row = {"grid": f"{h}x{w} f32 hotspot", "card": card, "sms": sms,
                   "stencil_us": _time_us(lambda x, c: ST.stencil2d_cuda(x, c), sets, reps),
                   "conv2d_us": _time_us(conv2d, sets, reps), "launch_floor_us": floor,
                   "bytes_bound_us": nbytes / HBM_BYTES_PER_S * 1e6, "conv2d_err": err}
            if hasattr(ST, "plan_stencil"):
                row["plan_rows"] = ST.plan_stencil(h, w, torch.float32, sms)
                row["plans_us"] = {r: _time_us(lambda x, c, r=r: ST.launch_plan(x, c, rows=r),
                                               sets, reps) for r in ST.ROW_TILES}
            print(json.dumps(row))


if __name__ == "__main__":
    main()
