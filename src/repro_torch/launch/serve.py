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
EOS (or without the deadline, shed or recovery that a flag below allows),
any token falls outside the vocabulary, or any slot's state is not finite.

Fault isolation (all ``--continuous``): ``--deadline-ms`` and
``--max-queue`` bound latency and queue depth (typed ``deadline`` and
``shed`` outcomes), ``--watchdog-timeout`` arms the dispatch watchdog,
``--snapshot-every`` / ``--snapshot-dir`` save the serve and
``--restore-from`` resumes it, and ``--chaos-seed`` with
``--chaos-{nan,drop,hang}-{rate,at}`` runs the chaos drill: the same
requests are first served fault-free, and the launcher exits nonzero
unless every injected fault is recovered and every stream equals the
fault-free run (tier-1 lane 3c's drill):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b --smoke \
      --continuous --device cpu --requests 6 --slots 2 --prompt-len 8 \
      --new-tokens 6 --max-len 64 --decode-window 2 --chaos-seed 7 \
      --chaos-nan-at 2 --chaos-drop-at 4 --watchdog-timeout 30
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs.registry import get_config
from repro_torch.model import model as M
from repro_torch.serve.chaos import ChaosInjector
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
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="[--continuous] wall-clock budget per request; "
                         "expired requests end with outcome 'deadline'")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="[--continuous] bounded admission queue beyond the "
                         "slot pool; overflow is shed, not queued")
    ap.add_argument("--watchdog-timeout", type=float, default=None,
                    help="[--continuous] per-dispatch hang deadline (s)")
    ap.add_argument("--snapshot-every", type=int, default=0,
                    help="[--continuous] snapshot the serve every N decode "
                         "windows (needs --snapshot-dir)")
    ap.add_argument("--snapshot-dir", default=None)
    ap.add_argument("--restore-from", default=None,
                    help="[--continuous] resume a snapshotted serve (same "
                         "requests, flags and seed)")
    ap.add_argument("--chaos-seed", type=int, default=None,
                    help="[--continuous] seed-deterministic fault injection "
                         "(drill mode: exits nonzero unless every fault is "
                         "recovered and every stream equals the fault-free run)")
    ap.add_argument("--chaos-nan-rate", type=float, default=0.0)
    ap.add_argument("--chaos-drop-rate", type=float, default=0.0)
    ap.add_argument("--chaos-hang-rate", type=float, default=0.0)
    ap.add_argument("--chaos-nan-at", type=int, nargs="*", default=(),
                    help="pin NaN faults to decode-window indices")
    ap.add_argument("--chaos-drop-at", type=int, nargs="*", default=())
    ap.add_argument("--chaos-hang-at", type=int, nargs="*", default=())
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
        sampling = dict(slots=args.slots, temperature=args.temperature,
                        top_k=args.top_k, eos_id=args.eos_id, seed=args.seed)
        chaos = baseline = None
        if args.chaos_seed is not None:
            chaos = ChaosInjector(
                seed=args.chaos_seed, nan_rate=args.chaos_nan_rate,
                drop_rate=args.chaos_drop_rate, hang_rate=args.chaos_hang_rate,
                nan_at=tuple(args.chaos_nan_at), drop_at=tuple(args.chaos_drop_at),
                hang_at=tuple(args.chaos_hang_at))
            # The drill's oracle: every stream under chaos must equal this
            # fault-free run of the same requests, bit for bit (rings sized
            # for recovery as under chaos, so the shapes agree too).
            baseline = engine.serve(reqs, **sampling, recoverable=True)
        t0 = time.perf_counter()
        outs = engine.serve(reqs, **sampling, deadline_ms=args.deadline_ms,
                            max_queue=args.max_queue,
                            watchdog_timeout_s=args.watchdog_timeout,
                            snapshot_every=args.snapshot_every,
                            snapshot_dir=args.snapshot_dir,
                            restore_from=args.restore_from, chaos=chaos)
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
        allowed = {"ok", "eos"}
        allowed |= {"deadline"} if args.deadline_ms is not None else set()
        allowed |= {"shed"} if args.max_queue is not None else set()
        allowed |= {"recovered"} if chaos is not None or args.restore_from else set()
        for i, (r, o) in enumerate(zip(reqs, outs)):
            if o.outcome not in allowed:
                raise SystemExit(f"request {i}: outcome {o.outcome}")
            if o.outcome in ("ok", "recovered") and o.size != r.max_new_tokens and (
                    args.eos_id is None or o.tokens[-1] != args.eos_id):
                raise SystemExit(f"request {i}: {o.size} tokens, budget "
                                 f"{r.max_new_tokens}")
            if o.outcome == "eos" and o.tokens[-1] != args.eos_id:
                raise SystemExit(f"request {i}: eos outcome without eos")
            if o.size and not (0 <= o.tokens.min() and o.tokens.max() < cfg.vocab_size):
                raise SystemExit(f"request {i}: token outside the vocabulary")
        if chaos is not None:
            _check_drill(chaos, st, baseline, outs)
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


def _check_drill(chaos, st, baseline, outs):
    """The chaos drill's verdict: faults were injected, every NaN was
    quarantined and recovered, and every stream equals the fault-free
    run."""
    faults = sum(chaos.counters.values())
    print(f"chaos drill: {faults} injected faults {dict(chaos.counters)}; "
          f"quarantines={st['quarantines']} recoveries={st['recoveries']} "
          f"retries={st['dispatch_retries']} "
          f"watchdog_timeouts={st['watchdog_timeouts']}")
    if faults == 0:
        raise SystemExit("chaos drill injected no faults: pin some with "
                         "--chaos-nan-at etc.")
    if chaos.counters["nan"] and st["recoveries"] < chaos.counters["nan"]:
        raise SystemExit("chaos drill: NaN faults injected but not all recovered")
    for i, (want, got) in enumerate(zip(baseline, outs)):
        if not np.array_equal(np.asarray(want), np.asarray(got)):
            raise SystemExit(f"chaos drill: request {i} diverged from the "
                             "fault-free run: isolation broken")
    print("chaos drill: all faults recovered; every stream bit-identical to "
          "the fault-free run")


if __name__ == "__main__":
    main()
