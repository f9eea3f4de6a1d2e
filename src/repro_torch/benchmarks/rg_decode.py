"""RecurrentGemma-2B's decode paths, repeated, on the card: tok/s of
``ServeEngine.generate`` and ``serve`` over several runs in one process,
and the host's µs per call of the elevator window's wrapper.

The workload is ``chip_smoke.py``'s phase 3e: full-size recurrentgemma-2b
with random bf16 weights from seed 0, ``generate`` at B=4 with 256-token
prompts, 32 new tokens, K=8, and ``serve`` of 6 ragged requests (8-48
prompt tokens, 2-16 new) on 4 slots.  After one warm-up of each, every rep
runs both and prints one JSON line.  Then ``elevator_decode_window_cuda``
at B=4, K=1, D=2560 in f32 (one generated token's call) runs ``--calls``
times with no synchronisation between calls: its host µs per call
(checks, plan and launch), and, where the checkout has ``plan_window``,
the µs of that plan alone, in one more line.  The script imports
``repro_torch`` from ``sys.path``, so one copy of it measures any checkout
of the port:

    PYTHONPATH=<checkout>/src python src/repro_torch/benchmarks/rg_decode.py [--reps N]

runs on the card only, and raises without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from repro_torch.configs.registry import get_config
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.elevator_scan import decode as ED
from repro_torch.model import model as M
from repro_torch.serve.engine import Request, ServeEngine


def _requests(rng, vocab):
    return [Request(tokens=rng.integers(0, vocab, int(rng.integers(8, 49))),
                    max_new_tokens=int(rng.integers(2, 17))) for _ in range(6)]


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _window_host_us(device, calls):
    g = torch.Generator(device=device).manual_seed(0)
    a = torch.rand((4, 1, 2560), generator=g, device=device) * 0.5 + 0.5
    x = torch.randn((4, 1, 2560), generator=g, device=device)
    h = torch.randn((4, 2560), generator=g, device=device)
    for _ in range(10):
        ED.elevator_decode_window_cuda(a, x, h)
    _, dt = _timed(lambda: [ED.elevator_decode_window_cuda(a, x, h) for _ in range(calls)])
    row = {"window_call_host_us": dt * 1e6 / calls, "calls": calls}
    if hasattr(ED, "plan_window"):
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        t0 = time.perf_counter()
        for _ in range(calls):
            ED.plan_window(4, 1, 2560, torch.float32, sms, 16)
        row["plan_window_us"] = (time.perf_counter() - t0) * 1e6 / calls
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--calls", type=int, default=2000)
    args = ap.parse_args(argv)
    device = resolve_device(None)
    cfg = get_config("recurrentgemma-2b")
    params = M.init_params(cfg, seed=0, device=device)
    engine = ServeEngine(cfg, params, max_len=512, decode_window=8)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (4, 256))
    reqs = _requests(rng, cfg.vocab_size)
    with torch.inference_mode():                              # warm-up
        engine.generate(prompts[:, :80], 2)
        engine.serve(reqs[:1], slots=4)
    for rep in range(args.reps):
        _, gen_s = _timed(lambda: engine.generate(prompts, 32))
        results, serve_s = _timed(lambda: engine.serve(reqs, slots=4))
        emitted = sum(r.size for r in results)
        print(json.dumps({"rep": rep, "generate_tok_s": 4 * 32 / gen_s, "generate_s": gen_s,
                          "serve_tok_s": emitted / serve_s, "serve_s": serve_s,
                          "serve_tokens": emitted}), flush=True)
    print(json.dumps(_window_host_us(device, args.calls)))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())


if __name__ == "__main__":
    main()
