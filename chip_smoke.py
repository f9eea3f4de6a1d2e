#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero, with no result line):

1. build: compile every CUDA source of the port with nvcc, in parallel;
2. kernels against their plain PyTorch versions on the card, at full
   RWKV6 widths (H=32, Dh=64), in f32 with TF32 off and in bf16: the
   chunked kernel (B=4, T=256, chunk 16, and T=100 -> chunk 10), the
   decode step (B=4) and the decode window (K in 1, 8, 37, 64), and the
   window bit for bit against K chained single steps;
2b. the training kernels against their plain versions, at the same widths
   and dtypes, B=4, T=256 chunk 16 and T=100 chunk 10: the training forward
   on (out, S, s_hist), the backward on its six outputs with random
   cotangents, and ``WKVFunction``'s grads on the card against the same
   Function on CPU copies;
3. the serving path: full-size rwkv6-1.6b in bf16 (random weights from a
   seed) through ``ServeEngine.generate`` (B=4, 256-token prompts, 32 new
   tokens, K=8) and ``ServeEngine.serve`` (6 ragged requests, 4 slots,
   K=8), with every kernel's launch count set to 0 just before and read
   just after; then the reduced f32 model on the card against the same
   model on the CPU (logits and greedy tokens), and one generate call
   under the profiler;
3b. the training path: the serving engine freed, full-size rwkv6-1.6b in
   bf16 through ``init_train_state`` and ``make_train_step`` (microbatch 2,
   full remat), 6 steps of B=8, T=256 from ``data.make_batch``, with the
   training kernels' launch counts set to 0 just before and read just
   after (they must equal the counts the step's structure gives); finite
   losses and parameters, the last loss below the first; then one step
   under the profiler;
3c. one train step of the reduced f32 model on the card against the CPU:
   loss, grad norm and updated parameters;
4. each kernel's median time at its main path's shapes beside its plain
   version's time and its bound, printed as one ``{"kernels": [...]}``
   line; then the card's name and power limit, and the result line.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
PEAK_BF16_FLOPS = 989e12           # H100 SXM dense bf16 tensor-core rate
H, DH = 32, 64

#: (max error) <= ATOL + RTOL * max|plain|, per dtype, with the reason.
TOLERANCE = {
    # f32: the same f32 arithmetic in another summation order.
    "float32": (1e-5, 2e-5),
    # bf16: out is rounded to bf16 (8-bit mantissa) by both versions, so
    # f32 sums that differ in the last bits may round one bf16 ulp apart.
    "bfloat16": (1e-3, 8e-3),
}
#: The training kernels, per output: (max error) <= ATOL + RTOL * max|plain|
#: of that output.  The backward's grads reach the hundreds (dw divides by
#: w) and sum products of e^{+-64}-scaled factors, so f32 is held relative
#: to each output's largest value; bf16 grads are rounded to bf16 by both
#: versions, one ulp (2**-8 relative) plus the f32 difference.
TRAIN_TOLERANCE = {
    "float32": (1e-5, 1e-4),
    "bfloat16": (1e-3, 8e-3),
}


def _inputs(torch, b, t, dtype, seed):
    """WKV inputs on the card with the model's value ranges: the decay
    w = exp(-exp(logit)) with the logit spanning the model's clip."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def n(*shape, s=1.0):
        return torch.randn(shape, generator=g, device="cuda") * s

    logit = torch.rand((b, H, t, DH), generator=g, device="cuda") * 7.386 - 6.0
    w = torch.exp(-torch.exp(logit))
    r, k, v = n(b, H, t, DH, s=0.5), n(b, H, t, DH, s=0.5), n(b, H, t, DH)
    u = n(H, DH, s=0.3)
    h0 = n(b, H, DH, DH, s=0.5)
    return [a.to(dtype).contiguous() for a in (r, k, v, w, u)] + [h0]


def _err(got, want):
    """(max abs error, max |want|) over the (out, S) pair."""
    e = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, want))
    s = max(float(b.float().abs().max()) for b in want)
    return e, s


def _time_ms(torch, fn, arg_sets, reps):
    """(device ms, call ms) per call, medians over ``reps`` calls that
    cycle through ``arg_sets`` (more bytes than the 50 MB L2, so every call
    finds its inputs cold, as the decode loop does).

    Device time: the calls are queued behind a ``torch.cuda._sleep`` so the
    card runs them back to back, and the span between two CUDA events is
    divided by their number.  Call time: CUDA events around one call at a
    time, so it also holds the host's cost of issuing the call."""
    for args in arg_sets[:2]:
        fn(*args)
    torch.cuda.synchronize()
    dev = []
    for _ in range(5):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(200_000_000)
        e0.record()
        for i in range(reps):
            fn(*arg_sets[i % len(arg_sets)])
        e1.record()
        e1.synchronize()
        dev.append(e0.elapsed_time(e1) / reps)
    call = []
    for i in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn(*arg_sets[i % len(arg_sets)])
        e1.record()
        e1.synchronize()
        call.append(e0.elapsed_time(e1))
    return sorted(dev)[len(dev) // 2], sorted(call)[len(call) // 2]


def _cold_sets(make, nbytes_each):
    n = max(2, math.ceil(128 * 2**20 / nbytes_each))
    return [make(seed) for seed in range(n)]


def _nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    import numpy as np

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import common
    from repro_torch.kernels.wkv import bwd as BW
    from repro_torch.kernels.wkv import decode as D
    from repro_torch.kernels.wkv import kernel as KC
    from repro_torch.model import model as M
    from repro_torch.serve.engine import Request, ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev_name = torch.cuda.get_device_name(0)
    print(f"device: {dev_name}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # ---- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    common.build_libraries()
    for name in common.KERNEL_SOURCES:
        common.load_library(name)
    print(f"[build] {len(common.KERNEL_SOURCES)} libraries in "
          f"{time.perf_counter() - t0:.2f}s")
    for name, (sec, report) in common.BUILD_REPORT.items():
        lines = [ln.strip() for ln in report.splitlines()
                 if "registers" in ln or "spill" in ln or "error" in ln]
        print(f"[build] {name}: {sec:.2f}s " + " | ".join(lines))

    # ---- 2. kernels against their plain versions ---------------------------
    worst = {"wkv_cuda": 0.0, "wkv_decode_cuda": 0.0, "wkv_decode_window_cuda": 0.0}

    def check(kname, case, dtype, got, want):
        atol, rtol = TOLERANCE[str(dtype).split(".")[-1]]
        e, s = _err(got, want)
        tol = atol + rtol * s
        ok = e <= tol and all(bool(torch.isfinite(a).all()) for a in got)
        print(f"[kernels] {kname:24s} {case:22s} {str(dtype):15s} "
              f"max_abs_err={e:.3e} tol={tol:.3e} (max|plain|={s:.2f}) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"{kname} {case} {dtype}: error {e} > {tol}")
        worst[kname] = max(worst[kname], e)

    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            for b, t, chunk in ((4, 256, 16), (4, 100, 10)):
                a = _inputs(torch, b, t, dtype, seed=1)
                got = KC.wkv_cuda(*a, chunk=chunk)
                torch.cuda.synchronize()
                check("wkv_cuda", f"B={b} T={t} chunk={chunk}", dtype, got,
                      KC.wkv_plain(*a, chunk=chunk))
            a = _inputs(torch, 4, 1, dtype, seed=2)
            got = D.wkv_decode_cuda(*a)
            torch.cuda.synchronize()
            check("wkv_decode_cuda", "B=4", dtype, got, D.wkv_decode_plain(*a))
            for kw in (1, 8, 37, 64):
                a = _inputs(torch, 4, kw, dtype, seed=3 + kw)
                got = D.wkv_decode_window_cuda(*a)
                torch.cuda.synchronize()
                check("wkv_decode_window_cuda", f"B=4 K={kw}", dtype, got,
                      D.wkv_decode_plain(*a))
                r, k, v, w, u, s = a
                outs = []
                for i in range(kw):
                    sl = slice(i, i + 1)
                    o, s = D.wkv_decode_cuda(r[:, :, sl].contiguous(),
                                             k[:, :, sl].contiguous(),
                                             v[:, :, sl].contiguous(),
                                             w[:, :, sl].contiguous(), u, s)
                    outs.append(o)
                same = torch.equal(torch.cat(outs, 2), got[0]) and torch.equal(s, got[1])
                print(f"[kernels] window K={kw} {dtype} bit-identical to "
                      f"{kw} chained single steps: {same}")
                if not same:
                    raise SystemExit("decode window differs from chained single steps")

    # ---- 2b. the training kernels against their plain versions -------------
    worst.update(_train_kernel_checks(torch, KC, BW))

    # ---- 3. the serving path -------------------------------------------------
    cfg = get_config("rwkv6-1.6b")
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in _leaves(params))
    print(f"[model] {cfg.name}: {n_params / 1e9:.3f}B params in {cfg.dtype}, "
          f"initialized in {time.perf_counter() - t0:.1f}s")
    engine = ServeEngine(cfg, params, max_len=512, decode_window=8)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (4, 256))
    reqs = [Request(tokens=rng.integers(0, cfg.vocab_size, int(rng.integers(8, 49))),
                    max_new_tokens=int(rng.integers(2, 17))) for _ in range(6)]
    engine.generate(prompts[:, :80], 2)                       # warm-up
    engine.serve(reqs[:1], slots=4)
    torch.cuda.synchronize()

    counters = (KC.wkv_cuda, D.wkv_decode_cuda, D.wkv_decode_window_cuda)
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    out = engine.generate(prompts, 32)
    torch.cuda.synchronize()
    dt_gen = time.perf_counter() - t0
    gen_state_ok = bool(M.decode_state_finite(engine.last_state).all())
    t0 = time.perf_counter()
    results = engine.serve(reqs, slots=4)
    torch.cuda.synchronize()
    dt_serve = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    serve_state_ok = bool(M.decode_state_finite(engine.last_state).all())

    gen = out[:, 256:].cpu().numpy()
    print(f"[main] generate B=4 P=256 +32 K=8: {dt_gen:.3f}s, "
          f"{4 * 32 / dt_gen:.1f} tok/s incl. prefill; state finite: {gen_state_ok}")
    emitted = sum(r.size for r in results)
    print(f"[main] serve 6 requests, 4 slots, K=8: {emitted} tokens in "
          f"{dt_serve:.3f}s, {emitted / dt_serve:.1f} tok/s; outcomes "
          f"{[r.outcome for r in results]}; state finite: {serve_state_ok}")
    print(f"[main] launches during generate + serve: {launches}")
    if gen.shape != (4, 32) or gen.min() < 0 or gen.max() >= cfg.vocab_size:
        raise SystemExit(f"generate: bad tokens, shape {gen.shape}")
    for req, res in zip(reqs, results):
        if res.outcome != "ok" or res.size != req.max_new_tokens:
            raise SystemExit(f"serve: {res.outcome} with {res.size} tokens")
        if res.tokens.min() < 0 or res.tokens.max() >= cfg.vocab_size:
            raise SystemExit("serve: token outside the vocabulary")
    if not (gen_state_ok and serve_state_ok):
        raise SystemExit("decode state not finite")
    if min(launches.values()) < 1:
        raise SystemExit(f"a kernel of the main path never launched: {launches}")

    _reference_check(torch, get_config, M, ServeEngine, np)
    _profile_generate(torch, engine, prompts)

    # ---- 3b. the training path ----------------------------------------------
    del engine, params
    torch.cuda.empty_cache()
    train_launches = _train_main_path(torch, cfg, KC, BW)
    _train_reference_check(torch, get_config)
    launches.update(train_launches)

    # ---- 4. times at the main path's shapes --------------------------------
    bf = torch.bfloat16
    rows = []
    with torch.inference_mode():
        specs = (
            (KC.wkv_cuda, lambda *a: KC.wkv_plain(*a, chunk=16),
             lambda *a: KC.wkv_cuda(*a, chunk=16), 256, 16,
             "src/repro_torch/kernels/wkv/csrc/wkv_chunked.cu",
             "src/repro/kernels/wkv/kernel.py:217 (wkv_pallas)"),
            (D.wkv_decode_cuda, D.wkv_decode_plain, D.wkv_decode_cuda, 1, 1,
             "src/repro_torch/kernels/wkv/csrc/wkv_decode.cu",
             "src/repro/kernels/wkv/decode.py:121 (wkv_decode_pallas)"),
            (D.wkv_decode_window_cuda, D.wkv_decode_plain,
             D.wkv_decode_window_cuda, 32, 32,
             "src/repro_torch/kernels/wkv/csrc/wkv_decode.cu",
             "src/repro/kernels/wkv/decode.py:158 (wkv_decode_window_pallas)"),
        )
        for counter, plain, kern, t, chunk, source, replaces in specs:
            one = _inputs(torch, 4, t, bf, seed=0)
            nbytes = _nbytes(one) + _nbytes(one[:1]) + 4 * 32 * DH * DH * 4
            sets = _cold_sets(lambda s: _inputs(torch, 4, t, bf, s), nbytes)
            ms, call_ms = _time_ms(torch, kern, sets, reps=100)
            plain_ms, _ = _time_ms(torch, plain, sets, reps=5)
            flops = _flops(4, t, chunk, windowed=(counter is not KC.wkv_cuda))
            b_ms = nbytes / HBM_BYTES_PER_S * 1e3
            f_ms = flops / PEAK_BF16_FLOPS * 1e3
            rows.append({
                "name": counter.__name__, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[counter.__name__],
                "max_abs_err": worst[counter.__name__],
                "ms": ms, "plain_ms": plain_ms, "bound_ms": max(b_ms, f_ms),
                "bound_by": "bytes" if b_ms >= f_ms else "operations",
                "library_ms": None, "call_ms": call_ms,
                "shape": f"B=4 H=32 T={t} Dh=64 bf16" + (
                    f" chunk={chunk}" if counter is KC.wkv_cuda else ""),
            })
            print(f"[time] {counter.__name__:24s} {rows[-1]['shape']:32s} "
                  f"device {ms * 1e3:8.2f} us, per call {call_ms * 1e3:8.2f} us "
                  f"(plain {plain_ms * 1e3:9.1f} us, bound "
                  f"{rows[-1]['bound_ms'] * 1e3:.2f} us by {rows[-1]['bound_by']})")
        # The window at the other admission bucket of the main path.
        sets = _cold_sets(lambda s: _inputs(torch, 4, 64, bf, s), 8 * 2**20)
        ms, call_ms = _time_ms(torch, D.wkv_decode_window_cuda, sets, 100)
        print(f"[time] wkv_decode_window_cuda   B=4 H=32 T=64 Dh=64 bf16{'':9s}"
              f"device {ms * 1e3:8.2f} us, per call {call_ms * 1e3:8.2f} us")
    rows += _time_train_kernels(torch, KC, BW, launches, worst)

    print(json.dumps({"kernels": rows}))
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev_name, "count": torch.cuda.device_count()}}))


def _cotangents(torch, b, t, dtype, seed):
    """Random output cotangents on the card: d_out (B,H,T,Dh) in ``dtype``,
    d_s_out (B,H,Dh,Dh) f32."""
    g = torch.Generator(device="cuda").manual_seed(1000 + seed)
    d_out = torch.randn((b, H, t, DH), generator=g, device="cuda").to(dtype)
    d_s = torch.randn((b, H, DH, DH), generator=g, device="cuda")
    return d_out, d_s


def _train_kernel_checks(torch, KC, BW):
    """Phase 2b.  Returns the worst max abs error of each training kernel."""
    from repro_torch.kernels.wkv.vjp import WKVFunction

    worst = {"wkv_train_cuda": 0.0, "wkv_bwd_cuda": 0.0, "WKVFunction": 0.0}

    def check(kname, case, dtype, got, want):
        atol, rtol = TRAIN_TOLERANCE[str(dtype).split(".")[-1]]
        errs = [float((a.float().cpu() - b.float().cpu()).abs().max())
                for a, b in zip(got, want)]
        tols = [atol + rtol * float(b.float().abs().max()) for b in want]
        ok = (all(e <= t for e, t in zip(errs, tols))
              and all(bool(torch.isfinite(a).all()) for a in got))
        print(f"[train-kernels] {kname:16s} {case:22s} {str(dtype):15s} "
              f"max_abs_err per output {['%.2e' % e for e in errs]} "
              f"tol {['%.2e' % t for t in tols]} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"{kname} {case} {dtype}: errors {errs} > {tols}")
        worst[kname] = max(worst[kname], max(errs))

    for dtype in (torch.float32, torch.bfloat16):
        for b, t, chunk in ((4, 256, 16), (4, 100, 10)):
            a = _inputs(torch, b, t, dtype, seed=11)
            case = f"B={b} T={t} chunk={chunk}"
            with torch.no_grad():
                got = KC.wkv_train_cuda(*a, chunk=chunk)
                torch.cuda.synchronize()
                check("wkv_train_cuda", case, dtype, got, KC.wkv_train_plain(*a, chunk=chunk))
                inf = KC.wkv_cuda(*a, chunk=chunk)
                if not (torch.equal(inf[0], got[0]) and torch.equal(inf[1], got[1])):
                    raise SystemExit("the training forward's (out, S) differ from inference")
                d_out, d_s = _cotangents(torch, b, t, dtype, seed=t)
                bargs = (*a[:5], got[2], d_out, d_s)
                gb = BW.wkv_bwd_cuda(*bargs, chunk=chunk)
                torch.cuda.synchronize()
                check("wkv_bwd_cuda", case, dtype, gb, BW.wkv_bwd_plain(*bargs, chunk=chunk))
                again = BW.wkv_bwd_cuda(*bargs, chunk=chunk)
                if not all(torch.equal(x, y) for x, y in zip(gb, again)):
                    raise SystemExit("wkv_bwd_cuda does not repeat bit for bit")
        # WKVFunction: the same Function on the card and on CPU copies.
        a = _inputs(torch, 4, 256, dtype, seed=12)
        d_out, d_s = _cotangents(torch, 4, 256, dtype, seed=12)
        grads = {}
        for dev in ("cuda", "cpu"):
            args = [x.detach().to(dev).requires_grad_(True) for x in a]
            out, s_fin = WKVFunction.apply(*args, 16)
            loss = ((out.float() * d_out.to(dev).float()).sum()
                    + (s_fin * d_s.to(dev)).sum())
            grads[dev] = torch.autograd.grad(loss, args)
        torch.cuda.synchronize()
        check("WKVFunction", "grads B=4 T=256 card/cpu", dtype, grads["cuda"], grads["cpu"])
    del worst["WKVFunction"]
    return worst


def _train_main_path(torch, cfg, KC, BW, steps=6, batch=8, seq=256):
    """Phase 3b: full-size training through the port's entry points.
    Returns the training kernels' launch counts over the ``steps`` steps."""
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import step as TS
    from repro_torch.tree import tree_leaves

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = TS.init_train_state(cfg, 0)
    torch.cuda.synchronize()
    print(f"[train] {cfg.name} {cfg.dtype}: train state initialized in "
          f"{time.perf_counter() - t0:.1f}s; microbatch {cfg.microbatch}, remat {cfg.remat}")
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch, seed=0)
    step_fn = TS.make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=steps))
    n_micro = max(1, cfg.microbatch)
    remat_runs = 2 if cfg.remat == "full" else 1    # first pass + recompute
    want = {"wkv_train_cuda": remat_runs * cfg.num_layers * n_micro * steps,
            "wkv_bwd_cuda": cfg.num_layers * n_micro * steps}
    batches = [make_batch(dcfg, i) for i in range(steps)]
    counters = (KC.wkv_train_cuda, BW.wkv_bwd_cuda, KC.wkv_cuda)
    for fn in counters:
        fn.launches = 0
    losses, times = [], []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, batches[i])
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss)
        print(f"[train] step {i}  loss {loss:.4f}  grad_norm {gnorm:.3f}  "
              f"{times[-1] * 1e3:.1f} ms  {batch * seq / times[-1]:,.0f} tok/s")
        if not math.isfinite(loss) or not math.isfinite(gnorm):
            raise SystemExit(f"train: non-finite loss {loss} / grad norm {gnorm}")
    launches = {fn.__name__: fn.launches for fn in counters}
    peak = torch.cuda.max_memory_allocated()
    steady = sorted(times[1:])[len(times[1:]) // 2]
    print(f"[train] launches during {steps} steps: {launches}; derived {want}")
    print(f"[train] B={batch} T={seq}: median step (steps 1-{steps - 1}) "
          f"{steady * 1e3:.1f} ms, {batch * seq / steady:,.0f} tok/s; first step "
          f"{times[0] * 1e3:.1f} ms; peak memory {peak / 2**30:.2f} GiB; "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    if not all(bool(torch.isfinite(p).all()) for p in tree_leaves(state.params)):
        raise SystemExit("train: a parameter is not finite")
    if not losses[-1] < losses[0]:
        raise SystemExit(f"train: loss did not fall: {losses}")
    if launches["wkv_cuda"] != 0 or any(launches[k] != n for k, n in want.items()):
        raise SystemExit(f"train: launch counts {launches} != derived {want}")
    _profile(torch, lambda: step_fn(state, batches[0]),
             f"train step B={batch} T={seq}", top=10)
    return {k: launches[k] for k in want}


def _train_reference_check(torch, get_config):
    """Phase 3c: one train step (microbatch 2) of the reduced f32 model on
    the card against the CPU, from the same weights and batch: loss and
    grad norm within 1e-5 / 1e-4 relative, parameters within 1e-5 (a first
    AdamW step moves each by at most 2 lr = 6e-6 at these settings)."""
    import dataclasses

    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.optim import adamw
    from repro_torch.train import step as TS
    from repro_torch.tree import tree_leaves, tree_map

    cfg = dataclasses.replace(get_config("rwkv6-1.6b").reduced(), microbatch=2)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=4, seed=2)
    params = TS.init_train_state(cfg, 1, device="cpu").params
    out = {}
    for dev in ("cpu", "cuda"):
        # A copy per device: the step updates the parameters in place.
        moved = tree_map(lambda p: p.detach().to(dev, copy=True).requires_grad_(True), params)
        state = TS.TrainState(moved, adamw.init_state(moved), None)
        state, m = TS.make_train_step(cfg)(state, make_batch(dcfg, 0, device=dev))
        out[dev] = (float(m["loss"]), float(m["grad_norm"]),
                    [p.detach().cpu() for p in tree_leaves(state.params)])
    (l_c, g_c, p_c), (l_g, g_g, p_g) = out["cpu"], out["cuda"]
    perr = max(float((a - b).abs().max()) for a, b in zip(p_g, p_c))
    print(f"[reference] reduced f32 train step, card vs CPU: loss {l_g:.6f} vs "
          f"{l_c:.6f}, grad norm {g_g:.6f} vs {g_c:.6f}, params max_abs_err "
          f"{perr:.2e} (tol 1e-5)")
    if (abs(l_g - l_c) > 1e-5 * abs(l_c) or abs(g_g - g_c) > 1e-4 * abs(g_c)
            or perr > 1e-5):
        raise SystemExit("card and CPU disagree on the reduced train step")


def _time_train_kernels(torch, KC, BW, launches, worst, b=4, t=256, chunk=16):
    """Phase 4 rows of the training kernels at the training path's shape."""
    bf = torch.bfloat16
    n = t // chunk
    hist_bytes = b * H * n * DH * DH * 4
    state_bytes = b * H * DH * DH * 4
    rows = []
    with torch.inference_mode():
        one = _inputs(torch, b, t, bf, seed=0)
        io = _nbytes(one[:1])                      # one (B,H,T,Dh) bf16 tensor
        fwd_bytes = _nbytes(one) + io + state_bytes + hist_bytes
        fwd_sets = _cold_sets(lambda s: _inputs(torch, b, t, bf, s), fwd_bytes)

        def bwd_set(seed):
            a = _inputs(torch, b, t, bf, seed)
            hist = KC.wkv_train_cuda(*a, chunk=chunk)[2]
            return (*a[:5], hist, *_cotangents(torch, b, t, bf, seed))

        bwd_bytes = (_nbytes(one[:5]) + hist_bytes + io + state_bytes      # in
                     + 4 * io + b * H * DH * 4 + state_bytes)             # out
        bwd_sets = _cold_sets(bwd_set, bwd_bytes)
        specs = (
            (KC.wkv_train_cuda, lambda *a: KC.wkv_train_cuda(*a, chunk=chunk),
             lambda *a: KC.wkv_train_plain(*a, chunk=chunk), fwd_sets, fwd_bytes,
             _flops(b, t, chunk, windowed=False),
             "src/repro_torch/kernels/wkv/csrc/wkv_chunked.cu",
             "src/repro/kernels/wkv/kernel.py:237 (wkv_pallas_train)"),
            (BW.wkv_bwd_cuda, lambda *a: BW.wkv_bwd_cuda(*a, chunk=chunk),
             lambda *a: BW.wkv_bwd_plain(*a, chunk=chunk), bwd_sets, bwd_bytes,
             _bwd_flops(b, t, chunk),
             "src/repro_torch/kernels/wkv/csrc/wkv_bwd.cu",
             "src/repro/kernels/wkv/bwd.py:164 (wkv_pallas_bwd)"),
        )
        for counter, kern, plain, sets, nbytes, flops, source, replaces in specs:
            ms, call_ms = _time_ms(torch, kern, sets, reps=50)
            plain_ms, _ = _time_ms(torch, plain, sets, reps=3)
            b_ms = nbytes / HBM_BYTES_PER_S * 1e3
            f_ms = flops / PEAK_BF16_FLOPS * 1e3
            rows.append({
                "name": counter.__name__, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[counter.__name__],
                "max_abs_err": worst[counter.__name__],
                "ms": ms, "plain_ms": plain_ms, "bound_ms": max(b_ms, f_ms),
                "bound_by": "bytes" if b_ms >= f_ms else "operations",
                "library_ms": None, "call_ms": call_ms,
                "shape": f"B={b} H=32 T={t} Dh=64 bf16 chunk={chunk}",
            })
            print(f"[time] {counter.__name__:24s} {rows[-1]['shape']:32s} "
                  f"device {ms * 1e3:8.2f} us, per call {call_ms * 1e3:8.2f} us "
                  f"(plain {plain_ms * 1e3:9.1f} us, bound "
                  f"{rows[-1]['bound_ms'] * 1e3:.2f} us by {rows[-1]['bound_by']}; "
                  f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
    return rows


def _bwd_flops(b, t, chunk):
    """Floating-point operations of one backward call, a multiply-add as
    two, per chunk of L: scores, dscores, the dscores products for d_rdec
    and d_kinv and scores^T do (5 triangles of L(L-1)/2 Dh), do S^T, V G^T,
    k_rem G and r_dec^T do (4 L Dh^2), the S.G row sums (Dh^2), and about
    40 elementwise operations per (token, column)."""
    n, L = t // chunk, chunk
    per_chunk = 2 * (5 * L * (L - 1) // 2 * DH + 4 * L * DH * DH + DH * DH) + 40 * L * DH
    return b * H * n * per_chunk


def _profile_generate(torch, engine, prompts):
    """Where the time of one ``generate`` call (B=4, P=256, 16 new tokens)
    goes."""
    _profile(torch, lambda: engine.generate(prompts, 16), "generate B=4 P=256 +16 K=8")


def _profile(torch, fn, what, top=8):
    """Wall time of ``fn()``, the card's busy and idle shares, and the
    kernels with the most device time, from the device-side kernel events
    of ``torch.profiler`` (whose own overhead lengthens the wall time, so
    the busy share it gives is a lower bound)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            acc = by_name.setdefault(e.name, [0.0, 0])
            acc[0] += e.time_range.elapsed_us()
            acc[1] += 1
    if not by_name:
        print("[profile] the profiler recorded no kernels: device time not measured")
        return
    busy = sum(us for us, _ in by_name.values())
    print(f"[profile] {what} under the profiler: wall "
          f"{wall_us / 1e3:.1f} ms, kernels {busy / 1e3:.1f} ms, card busy "
          f"{100 * busy / wall_us:.1f}%, idle {100 - 100 * busy / wall_us:.1f}%")
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"[profile]   {us / 1e3:8.2f} ms {n:6d}x  {name[:90]}")


def _flops(b, t, chunk, windowed):
    """Floating-point operations of one call at (b, H, t, Dh): the decode
    kernels do 5 Dh^2 per token and head; the chunked kernel, per chunk of
    L, L(L-1) Dh (scores) + 2 L^2 Dh (intra) + 4 L Dh^2 (inter, update)."""
    if windowed:
        return b * H * t * 5 * DH * DH
    n, L = t // chunk, chunk
    return b * H * n * (L * (L - 1) * DH + 2 * L * L * DH + 4 * L * DH * DH)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def _reference_check(torch, get_config, M, ServeEngine, np):
    """The reduced f32 model with the kernels on the card against the same
    weights with the plain versions on the CPU: forward logits (T=80, the
    chunked kernel) within 1e-4, and greedy tokens (a 40-token prefill
    through the window kernel, then single steps) equal."""
    cfg = get_config("rwkv6-1.6b").reduced()
    p_cpu = M.init_params(cfg, seed=1, device="cpu")
    p_gpu = _to(p_cpu, "cuda")
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 80)))
    with torch.inference_mode():
        l_cpu = M.forward(p_cpu, cfg, toks)
        l_gpu = M.forward(p_gpu, cfg, toks.cuda()).cpu()
    err = float((l_cpu - l_gpu).abs().max())
    g_cpu = ServeEngine(cfg, p_cpu, max_len=128, device="cpu").generate(toks[:, :40], 12)
    g_gpu = ServeEngine(cfg, p_gpu, max_len=128).generate(toks[:, :40].cuda(), 12).cpu()
    same = torch.equal(g_cpu, g_gpu)
    print(f"[reference] reduced f32 model, card vs CPU: forward max_abs_err="
          f"{err:.2e} (tol 1e-4), greedy tokens equal: {same}")
    if err > 1e-4 or not same:
        raise SystemExit("card and CPU disagree on the reduced model")


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return None if tree is None else tree.to(device)


if __name__ == "__main__":
    main()
