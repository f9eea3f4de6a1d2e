"""Serving launcher for the port: lockstep ``generate`` or the
continuous-batching ``serve`` of :class:`repro_torch.serve.engine.ServeEngine`.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b --continuous

runs full-size RWKV6-1.6B (random weights from ``--seed``, bf16) on the
card.  ``--smoke`` takes the reduced f32 config; ``--device cpu`` runs on
the CPU with the kernels' plain versions:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b --smoke \
      --continuous --device cpu

With ``--continuous`` the requests are a ragged queue (prompt lengths and
budgets drawn per request, as the reference's launcher draws them); the
launcher exits nonzero if any request ends short of its budget without
EOS, any token falls outside the vocabulary, or any slot's state is not
finite.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs.registry import get_config
from repro_torch.model import model as M
from repro_torch.serve.engine import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced f32 config of the same family")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--decode-window", type=int, default=8,
                    help="tokens generated per decode window (K)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--continuous", action="store_true",
                    help="continuous-batching scheduler (ragged queue, "
                         "slot recycling) instead of lockstep generate()")
    ap.add_argument("--requests", type=int, default=8,
                    help="[--continuous] queued requests")
    ap.add_argument("--slots", type=int, default=4,
                    help="[--continuous] batch slots")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy")
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--eos-id", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    print(f"initializing {cfg.name} ({cfg.param_count()/1e6:.1f}M params)...")
    params = M.init_params(cfg, args.seed, device=args.device)
    engine = ServeEngine(cfg, params, max_len=args.max_len,
                         decode_window=args.decode_window, device=args.device)
    rng = np.random.default_rng(args.seed)

    if args.continuous:
        if args.prompt_len < 1 or args.new_tokens < 1 or args.requests < 1:
            raise SystemExit("--continuous needs --prompt-len, --new-tokens "
                             "and --requests all >= 1")
        p_lo = min(4, args.prompt_len)
        n_lo = min(2, args.new_tokens)
        reqs = []
        for _ in range(args.requests):
            p = int(rng.integers(p_lo, args.prompt_len + 1))
            toks = rng.integers(0, cfg.vocab_size, (p,)).astype(np.int32)
            reqs.append(Request(tokens=toks, max_new_tokens=int(
                rng.integers(n_lo, args.new_tokens + 1))))
        t0 = time.perf_counter()
        outs = engine.serve(reqs, slots=args.slots,
                            temperature=args.temperature, top_k=args.top_k,
                            eos_id=args.eos_id, seed=args.seed)
        dt = time.perf_counter() - t0
        st = engine.last_serve_stats
        emitted = sum(o.size for o in outs)
        useful = sum(r.max_new_tokens for r in reqs)
        print(f"served {len(reqs)} ragged requests ({emitted}/{useful} "
              f"tokens) in {dt:.2f}s on {engine.device} ({emitted/dt:.1f} "
              f"tok/s; {st['decode_dispatches']} decode windows, "
              f"{st['admissions']} admissions at K={args.decode_window})")
        counts: dict[str, int] = {}
        for o in outs:
            counts[o.outcome] = counts.get(o.outcome, 0) + 1
        print("outcomes:", " ".join(f"{k}={v}" for k, v in sorted(counts.items())))
        print("first request tokens:", outs[0].tolist())
        for i, (r, o) in enumerate(zip(reqs, outs)):
            if o.outcome == "ok" and o.size != r.max_new_tokens:
                raise SystemExit(f"request {i}: {o.size} tokens, budget "
                                 f"{r.max_new_tokens}")
            if o.outcome == "eos" and o.tokens[-1] != args.eos_id:
                raise SystemExit(f"request {i}: eos outcome without eos")
            if o.outcome not in ("ok", "eos"):
                raise SystemExit(f"request {i}: outcome {o.outcome}")
            if o.size and not (0 <= o.tokens.min() and o.tokens.max() < cfg.vocab_size):
                raise SystemExit(f"request {i}: token outside the vocabulary")
    else:
        prompts = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len))
        t0 = time.perf_counter()
        out = engine.generate(prompts, args.new_tokens)
        dt = time.perf_counter() - t0
        total_new = args.batch * args.new_tokens
        print(f"generated {tuple(out.shape)} in {dt:.2f}s on {engine.device} "
              f"({total_new/dt:.1f} tok/s incl. prefill; "
              f"{engine.last_decode_dispatches} decode windows at "
              f"K={args.decode_window})")
        print("first sequence:", out[0].tolist())
        gen = out[:, args.prompt_len:]
        if gen.numel() and not (0 <= int(gen.min()) and int(gen.max()) < cfg.vocab_size):
            raise SystemExit("token outside the vocabulary")
    if not bool(M.decode_state_finite(engine.last_state).all()):
        raise SystemExit("decode state not finite")


if __name__ == "__main__":
    main()
