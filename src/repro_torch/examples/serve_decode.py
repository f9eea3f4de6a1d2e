"""Serving example: batched decoding with KV caches and recurrent state (the
port of ``examples/serve_decode.py``).

Covers three families: dense local:global (gemma3), hybrid
(recurrentgemma) and attention-free (rwkv6), all through the same
ServeEngine, twice:

* lockstep ``generate``: one batch, every request padded to the longest;
* continuous ``serve``: a ragged request queue through 2 slots with
  per-request budgets, temperature/top-k sampling inside the window, and
  EOS-freed slots recycled to the next queued request; then the
  fault-isolation layer: a chaos-injected NaN is quarantined in-window and
  recovered by re-prefill (typed ``recovered`` outcome), a per-request
  deadline and a bounded queue produce ``deadline`` / ``shed`` outcomes,
  and neighbours stay bit-identical throughout.

    PYTHONPATH=src python -m repro_torch.examples.serve_decode [--device cpu]

runs the reduced configs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs.registry import get_config
from repro_torch.kernels.common import resolve_device
from repro_torch.model import model as M
from repro_torch.serve.chaos import ChaosInjector
from repro_torch.serve.engine import Request, ServeEngine

ARCHS = ["gemma3-1b", "recurrentgemma-2b", "rwkv6-1.6b"]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run there)")
    dev = resolve_device(ap.parse_args(argv).device)
    rng = np.random.default_rng(0)
    results = {}
    for arch in ARCHS:
        cfg = get_config(arch).reduced()
        params = M.init_params(cfg, 0, device=dev)
        # decode_window=8: one prompt prefill, then 16 tokens in
        # ceil(16/8)=2 decode dispatches that update the state in place.
        engine = ServeEngine(cfg, params, max_len=96, decode_window=8, device=dev)
        prompts = rng.integers(0, cfg.vocab_size, (4, 12))
        t0 = time.perf_counter()
        out = engine.generate(prompts, num_new_tokens=16)
        dt = time.perf_counter() - t0
        print(f"{arch:22s} lockstep   -> {tuple(out.shape)} in {dt:.2f}s "
              f"({engine.last_decode_dispatches} decode dispatches); "
              f"sample: {out[0, -6:].tolist()}")

        # Continuous batching: 6 ragged requests through 2 slots.  Each
        # request decodes at its own position and frees its slot the
        # moment its budget (or EOS) hits, detected inside the window.
        reqs = [Request(tokens=rng.integers(0, cfg.vocab_size, (int(rng.integers(4, 13)),)),
                        max_new_tokens=int(rng.integers(3, 17))) for _ in range(6)]
        sampling = dict(slots=2, temperature=0.7, top_k=32, seed=0)
        t0 = time.perf_counter()
        # Local-attention rings sized for recovery, as under chaos below, so
        # the two runs attend over the same shapes.
        outs = engine.serve(reqs, **sampling, recoverable=True)
        dt = time.perf_counter() - t0
        st = engine.last_serve_stats
        print(f"{arch:22s} continuous -> {[int(o.size) for o in outs]} tokens in "
              f"{dt:.2f}s ({st['decode_dispatches']} dispatches, {st['admissions']} "
              f"admissions; outcomes {sorted({o.outcome for o in outs})})")

        # Fault isolation: the same queue under chaos: one pinned
        # NaN-in-state fault (quarantined in-window, recovered by masked
        # re-prefill from the accepted prefix), one request on a
        # zero-millisecond deadline, and a 1-deep bounded queue that sheds
        # the last arrivals.  Every stream under chaos is bit-identical to
        # the run above (same seed, per-(request, token) sampling).
        chaos = ChaosInjector(seed=1, nan_at=(2,))
        c_outs = engine.serve(reqs, **sampling, chaos=chaos)
        chaos_st = engine.last_serve_stats
        identical = all(np.array_equal(np.asarray(a), np.asarray(b))
                        for a, b in zip(outs, c_outs))
        print(f"{arch:22s} chaos      -> outcomes {[o.outcome for o in c_outs]} "
              f"({chaos_st['quarantines']} quarantined, {chaos_st['recoveries']} recovered; "
              f"streams bit-identical: {identical})")

        d_reqs = [Request(tokens=r.tokens, max_new_tokens=r.max_new_tokens,
                          deadline_ms=0.0 if i == 0 else None)
                  for i, r in enumerate(reqs)]
        d_outs = engine.serve(d_reqs, **sampling, max_queue=1)
        print(f"{arch:22s} lifecycle  -> outcomes {[o.outcome for o in d_outs]} "
              f"(deadline_ms=0 on request 0, queue bounded at 2 slots + 1)")
        results[arch] = {
            "generate": out.cpu(), "continuous": [o.outcome for o in outs],
            "chaos": [o.outcome for o in c_outs], "identical": identical,
            "recoveries": chaos_st["recoveries"],
            "lifecycle": [o.outcome for o in d_outs],
        }
    return results


if __name__ == "__main__":
    main()
