"""Serving launcher for the port: lockstep ``generate`` or the
continuous-batching ``serve`` of :class:`repro_torch.serve.engine.ServeEngine`.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b --continuous

runs full-size RWKV6-1.6B (random weights from ``--seed``, bf16) on the
card.  ``--arch`` takes every arch the port runs
(``repro_torch.configs.registry.list_archs()``: rwkv6-1.6b,
recurrentgemma-2b, gemma3-1b, qwen2-0.5b, minitron-8b, nemotron-4-15b,
qwen2-vl-7b, dbrx-132b, qwen3-moe-235b-a22b); the encoder-decoder
seamless-m4t-large-v2 is refused, as in the reference: its decoding
needs the encoder's frames, which
:func:`repro_torch.serve.engine.make_decode_step` takes.  ``--smoke``
takes the reduced f32 config; ``--device cpu`` runs on the CPU with the
kernels' plain versions:

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

``--paged`` keeps the KV caches in page pools (``--page-size``,
``--pool-pages``) and runs the paged drill: the same requests are first
served by a dense engine on the same weights, and the launcher exits
nonzero unless every stream equals it bit for bit, the page-table audit is
clean, and an explicitly sized pool beats the dense footprint.
``--prefix-len N`` also registers one N-token shared prefix and admits
every request through it (tier-1 lane 3d's drill):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b --smoke \
      --continuous --paged --requests 5 --slots 2 --prompt-len 6 \
      --new-tokens 6 --max-len 128 --decode-window 2 --prefix-len 40 \
      --pool-pages 4 --temperature 0.8 --top-k 16 --device cpu

``--checksum-every N`` arms the silent-corruption checksum chain (a shadow
recompute every N windows), and ``--chaos-bitflip-at`` pins finite bit
flips that only the chain can see.  ``--replicas N`` serves the same queue
through a health-checked replica fleet (:mod:`repro_torch.serve.fleet`)
and runs the fleet drill: ``--chaos-replica-kill-at K`` kills replica 1 at
its K-th decode window (its requests resume on the survivors from its last
snapshot), the bit flips land on the same replica, and the launcher exits
nonzero unless the kill fired and was handed off, every flip was detected,
every outcome is ok, eos or recovered, and every stream equals a
fault-free single engine's (tier-1 lane 3e's drill):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b --smoke \
      --continuous --replicas 3 --requests 6 --slots 2 --prompt-len 10 \
      --new-tokens 16 --max-len 96 --decode-window 4 --snapshot-every 1 \
      --checksum-every 2 --chaos-bitflip-at 1 --chaos-replica-kill-at 3 \
      --device cpu
"""

from __future__ import annotations

import argparse
import sys
import tempfile
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
    ap.add_argument("--paged", action="store_true",
                    help="[--continuous] pooled KV pages and per-slot page tables "
                         "(drill mode: exits nonzero unless every stream equals "
                         "the dense engine's)")
    ap.add_argument("--page-size", type=int, default=32,
                    help="[--paged] tokens per KV page (a multiple of 32)")
    ap.add_argument("--pool-pages", type=int, default=None,
                    help="[--paged] private pages per node pool (default: the "
                         "dense-equivalent count)")
    ap.add_argument("--prefix-len", type=int, default=0,
                    help="[--paged] register one shared prefix of this many "
                         "tokens and admit every request through it")
    ap.add_argument("--replicas", type=int, default=1,
                    help="[--continuous] serve through a replica fleet (drill "
                         "mode: exits nonzero unless every request completes "
                         "bit-identically on the survivors)")
    ap.add_argument("--checksum-every", type=int, default=0,
                    help="[--continuous] arm the silent-corruption checksum "
                         "chain; shadow spot check every N windows")
    ap.add_argument("--chaos-bitflip-at", type=int, nargs="*", default=(),
                    help="pin silent state bit flips to decode-window indices "
                         "(needs --checksum-every to detect)")
    ap.add_argument("--chaos-replica-kill-at", type=int, nargs="*", default=(),
                    help="[--replicas] kill one replica at these decode-window "
                         "counts (fires once; needs --snapshot-every for the "
                         "handoff)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    if cfg.is_enc_dec:
        print("the port decodes an enc-dec arch against its frames with "
              "repro_torch.model.model.encode and "
              "repro_torch.serve.engine.make_decode_step(cfg)(..., enc_out=)", file=sys.stderr)
        raise SystemExit("enc-dec serving demo: use examples/serve_decode.py")
    if args.paged and not args.continuous:
        raise SystemExit("--paged requires --continuous")
    if args.replicas < 1:
        raise SystemExit("--replicas must be >= 1")
    if args.replicas > 1 and not args.continuous:
        raise SystemExit("--replicas requires --continuous")
    if args.chaos_bitflip_at and not args.checksum_every:
        raise SystemExit("--chaos-bitflip-at needs --checksum-every to be detectable")
    print(f"initializing {cfg.name} ({cfg.param_count()/1e6:.1f}M params)...")
    params = M.init_params(cfg, args.seed, device=args.device)
    engine = ServeEngine(cfg, params, max_len=args.max_len,
                         decode_window=args.decode_window, device=args.device,
                         paged=args.paged, page_size=args.page_size,
                         pool_pages=args.pool_pages)
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
        if args.paged and args.prefix_len:
            if args.prefix_len < args.page_size:
                raise SystemExit("--prefix-len must cover at least one page")
            prefix = rng.integers(0, cfg.vocab_size, (args.prefix_len,)).astype(np.int32)
            pid = engine.register_prefix(prefix)
            reqs = [Request(tokens=np.concatenate([prefix, r.tokens]),
                            max_new_tokens=r.max_new_tokens, prefix_id=pid) for r in reqs]
        sampling = dict(slots=args.slots, temperature=args.temperature,
                        top_k=args.top_k, eos_id=args.eos_id, seed=args.seed)
        if args.replicas > 1:
            return _fleet_drill(args, cfg, params, reqs, sampling)
        dense_ref = None
        if args.paged:
            # The paged drill's oracle: a dense engine on the same weights and
            # requests (it prefills the prefix again for every request).
            dense_ref = ServeEngine(cfg, params, max_len=args.max_len,
                                    decode_window=args.decode_window,
                                    device=args.device).serve(
                [Request(tokens=r.tokens, max_new_tokens=r.max_new_tokens)
                 for r in reqs], **sampling)
        chaos = baseline = None
        if args.chaos_seed is not None:
            chaos = ChaosInjector(
                seed=args.chaos_seed, nan_rate=args.chaos_nan_rate,
                drop_rate=args.chaos_drop_rate, hang_rate=args.chaos_hang_rate,
                nan_at=tuple(args.chaos_nan_at), drop_at=tuple(args.chaos_drop_at),
                hang_at=tuple(args.chaos_hang_at),
                bitflip_at=tuple(args.chaos_bitflip_at))
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
                            restore_from=args.restore_from, chaos=chaos,
                            checksum_every=args.checksum_every)
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
        if args.paged:
            _check_paged(engine, st, dense_ref, outs, explicit_pool=args.pool_pages is not None)
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
    if chaos.counters["bitflip"] and not st["corruptions"]:
        raise SystemExit("chaos drill: bit flips injected but the checksum chain "
                         "detected none")
    for i, (want, got) in enumerate(zip(baseline, outs)):
        if not np.array_equal(np.asarray(want), np.asarray(got)):
            raise SystemExit(f"chaos drill: request {i} diverged from the "
                             "fault-free run: isolation broken")
    print("chaos drill: all faults recovered; every stream bit-identical to "
          "the fault-free run")


def _fleet_drill(args, cfg, params, reqs, sampling):
    """Serve ``reqs`` through a fleet of ``--replicas`` engines sharing one
    params tree, with the pinned kill and bit flips on replica 1, and hold
    it to the single-engine bar: the kill fired and was handed off, every
    flip was detected, every outcome is ok, eos or recovered, and every
    stream equals a fault-free single engine's."""
    from repro_torch.serve.fleet import FleetRouter

    kill_at = tuple(args.chaos_replica_kill_at)
    bitflip_at = tuple(args.chaos_bitflip_at)
    if kill_at and not args.snapshot_every:
        raise SystemExit("--chaos-replica-kill-at needs --snapshot-every (the "
                         "handoff resumes from the victim's snapshot)")

    def build():
        return ServeEngine(cfg, params, max_len=args.max_len,
                           decode_window=args.decode_window, device=args.device,
                           paged=args.paged, page_size=args.page_size,
                           pool_pages=args.pool_pages)

    # The oracle: a fault-free single engine, its rings sized for recovery
    # as the fleet's sessions size theirs, so every shape agrees.
    baseline = build().serve(reqs, **sampling, recoverable=True)
    engines = [build() for _ in range(args.replicas)]
    chaos = None
    if kill_at or bitflip_at or args.chaos_seed is not None:
        chaos = [None] * args.replicas
        chaos[1] = ChaosInjector(
            seed=args.chaos_seed or 0, nan_rate=args.chaos_nan_rate,
            nan_at=tuple(args.chaos_nan_at), bitflip_at=bitflip_at,
            replica_kill_at=kill_at)
    with tempfile.TemporaryDirectory(prefix="fleet_snap_") as tmp:
        t0 = time.perf_counter()
        fleet = FleetRouter(
            engines, reqs, **sampling, deadline_ms=args.deadline_ms,
            max_queue=args.max_queue, watchdog_timeout_s=args.watchdog_timeout,
            snapshot_every=args.snapshot_every,
            snapshot_root=args.snapshot_dir or (tmp if args.snapshot_every else None),
            checksum_every=args.checksum_every, chaos=chaos)
        outs = fleet.run()
        dt = time.perf_counter() - t0
    emitted = sum(o.size for o in outs)
    st = fleet.stats
    per = fleet.stats_by_replica()
    print(f"fleet served {len(reqs)} requests over {args.replicas} replicas "
          f"({emitted} tokens) in {dt:.2f}s ({emitted / dt:.1f} tok/s; "
          f"{st['rounds']} rounds, {st['assignments']} assignments, "
          f"{st['replica_deaths']} deaths, {st['handoffs']} handoffs, "
          f"{st['handoff_requeued_fresh']} requeued fresh)")
    print("per-replica windows:", [s["decode_dispatches"] for s in per],
          "corruptions:", [s["corruptions"] for s in per],
          "spot checks:", [s["checksum_spot_checks"] for s in per],
          "states:", [m.state for m in fleet.monitors])
    counts: dict[str, int] = {}
    for o in outs:
        counts[o.outcome] = counts.get(o.outcome, 0) + 1
    print("outcomes:", " ".join(f"{k}={v}" for k, v in sorted(counts.items())))
    if kill_at:
        if not st["replica_deaths"]:
            raise SystemExit("fleet drill: the pinned replica kill never fired")
        if not (st["handoffs"] or st["handoff_requeued_fresh"]):
            raise SystemExit("fleet drill: a replica died but nothing was handed "
                             "off or requeued")
    if bitflip_at and not sum(s["corruptions"] for s in per):
        raise SystemExit("fleet drill: bit flips injected but the checksum chain "
                         "detected none")
    bad = [o.outcome for o in outs if o.outcome not in ("ok", "eos", "recovered")]
    if bad:
        raise SystemExit(f"fleet drill: unclean outcomes {bad}")
    for i, (want, got) in enumerate(zip(baseline, outs)):
        if not np.array_equal(np.asarray(want), np.asarray(got)):
            raise SystemExit(f"fleet drill: request {i} diverged from the fault-free "
                             "single-engine run: the handoff broke bit-identity")
    print("fleet drill: every request completed on the survivors, every stream "
          "bit-identical to the fault-free single-engine run")


def _check_paged(engine, st, dense_ref, outs, *, explicit_pool: bool):
    """The paged drill's verdict: a clean page-table audit, an explicitly
    sized pool below the dense footprint, and every stream (outcome and
    tokens) equal to the dense engine's."""
    pg = engine.last_paged_stats
    print(f"paged: page_size={pg['page_size']} shared_pages={pg['shared_pages']} "
          f"pool_bytes={pg['pool_bytes']} dense_bytes={pg['dense_bytes']} "
          f"peak_mapped_bytes={pg['peak_mapped_bytes']} "
          f"prefix_admissions={st['prefix_admissions']} page_waits={st['page_waits']}")
    if pg["page_table_violations"]:
        raise SystemExit(f"paged drill: {pg['page_table_violations']} page-table "
                         "violations (double-map / freed-page reach)")
    if explicit_pool and pg["pool_bytes"] >= pg["dense_bytes"]:
        raise SystemExit("paged drill: explicitly sized pool does not beat the dense "
                         f"footprint ({pg['pool_bytes']} >= {pg['dense_bytes']} bytes)")
    for i, (want, got) in enumerate(zip(dense_ref, outs)):
        if want.outcome != got.outcome or not np.array_equal(np.asarray(want),
                                                             np.asarray(got)):
            raise SystemExit(f"paged drill: request {i} diverged from the dense engine "
                             f"({want.outcome} vs {got.outcome}): paging must be an "
                             "exact storage-layout change")
    print("paged drill: every stream bit-identical to the dense engine")


if __name__ == "__main__":
    main()
