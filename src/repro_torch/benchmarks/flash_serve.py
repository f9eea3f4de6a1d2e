"""The serving flash-attention forward at the shapes of PERF.md's rows 11-11k,
timed on the card as ``chip_smoke.py``'s phase 4 times them.

For each shape the script launches ``flash_attention_cuda`` without the
log-sum-exp (the serving call) on bf16 inputs cycled through more bytes
than the L2, and prints one JSON object: the row, the shape and the device
µs per call (the median of 5 rounds of ``--reps`` calls queued behind
``torch.cuda._sleep``).  It uses only the wrapper's serving signature, so
pointing PYTHONPATH at a ``git archive`` of another commit times that
commit's kernel with the same script, and two commits compare in one call:

    PYTHONPATH=<checkout>/src python src/repro_torch/benchmarks/flash_serve.py [--reps N]

runs on the card only, and raises without one.
"""

from __future__ import annotations

import argparse
import json
import math

import torch

#: (row, B, Hq, Hkv, T, S, D, causal, window): PERF.md's rows 11-11k.
ROWS = (
    ("11", 1, 10, 1, 4096, 4096, 256, True, 2048),
    ("11 causal", 1, 10, 1, 4096, 4096, 256, True, None),
    ("11b", 1, 4, 1, 4096, 4096, 256, True, 1024),
    ("11c", 1, 4, 1, 4096, 4096, 256, True, None),
    ("11d", 1, 14, 2, 4096, 4096, 64, True, None),
    ("11e", 1, 32, 8, 4096, 4096, 128, True, None),
    ("11f", 1, 48, 8, 4096, 4096, 128, True, None),
    ("11g", 1, 28, 4, 4096, 4096, 128, True, None),
    ("11h", 1, 64, 4, 1024, 1024, 128, True, None),
    ("11i", 1, 16, 16, 4096, 4096, 64, False, None),
    ("11j", 1, 16, 16, 1024, 4096, 64, False, None),
    ("11k", 4, 16, 16, 1, 1024, 64, False, None),
)


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flash_serve: no card (torch.cuda.is_available() is false)")
    from repro_torch.kernels.local_attention.kernel import flash_attention_cuda

    for row, b, hq, hkv, t, s, d, causal, window in ROWS:
        nbytes = 2 * (2 * b * hq * t * d + 2 * b * hkv * s * d)
        g = torch.Generator(device="cuda").manual_seed(0)
        sets = [tuple(torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
                      for shape in ((b, hq, t, d), (b, hkv, s, d), (b, hkv, s, d)))
                for _ in range(max(2, math.ceil(128 * 2**20 / nbytes)))]
        with torch.inference_mode():
            us = _time_us(lambda q, k, v: flash_attention_cuda(q, k, v, causal=causal,
                                                               window=window),
                          sets, args.reps)
        print(json.dumps({"row": row, "shape": f"B={b} Hq={hq} Hkv={hkv} T={t} S={s} D={d} "
                          + (f"W={window}" if window else "causal" if causal else "full"),
                          "device_us": us}), flush=True)
        del sets
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
