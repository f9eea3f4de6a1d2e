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
3g. the sequence-parallel path, on the same weights and a seq mesh of 4
   shards of the card (``make_seq_mesh(4)``): the segment-summary kernels
   against their plain versions in f32 and bf16 on every output (a_seg and
   s_hist included; B=4 T=256, a shard of the main path B=1 T=1024 read in
   place from a 4096-token prompt, an odd shard), and bit for bit against
   the contiguous launches; the seq prefill (B=1, T=4096, 96
   ``wkv_summary_cuda`` launches and no ``wkv_cuda``),
   ``ServeEngine(mesh=...).generate`` (B=2, P=2048, +32, K=8) and a loss
   gradient (B=1, T=2048, full remat) against the same calls without a
   mesh, with exact launch counts, the prefill's and the gradient's
   distance from the same weights in f32 held to the no-mesh path's; then
   the reduced f32 seq path on the card against the CPU;
3b. the training path: the serving engine freed, full-size rwkv6-1.6b in
   bf16 through ``init_train_state`` and ``make_train_step`` (microbatch 2,
   full remat), 6 steps of B=8, T=256 from ``data.make_batch``, with the
   training kernels' launch counts set to 0 just before and read just
   after (they must equal the counts the step's structure gives); finite
   losses and parameters, the last loss below the first; then one step
   under the profiler;
3c. one train step of the reduced f32 model on the card against the CPU:
   loss, grad norm and updated parameters;
3d. RecurrentGemma's kernels against their plain versions on the card, in
   f32 with TF32 off and in bf16: the chunked elevator scan (B=4, T=256 and
   B=1, T=4096, D=2560), its decode window (K in 1, 8, 37, 64, bit for bit
   against K chained single launches), the token shift (T in 4, 67, 259,
   4096) and flash attention at Hq 10, Hkv 1, D 256 (causal window 2048 at
   T=4096, causal full, a non-causal window, the decode offset T=8 against
   S=300, T not a block multiple);
3e. the RecurrentGemma path, the RWKV6 engines and train state freed:
   full-size recurrentgemma-2b in bf16 (random weights from a seed, depth
   not cut) through ``ServeEngine.generate`` (B=4, 256-token prompts, 32
   new tokens, K=8), ``ServeEngine.serve`` (6 ragged requests, 4 slots,
   K=8) and prompt scoring (``make_prefill_step``, the cache-free
   ``forward``) at B=1, T=4096, every kernel's launch count set to 0 just
   before each call and held just after to the count the code's structure
   gives; then the reduced f32 model on the card against the CPU, and one
   generate call and one forward under the profiler;
3f. the paper demo: the 5-point stencil against its plain version in f32
   (bit for bit) and bf16 (hotspot and SRAD coefficients on the suite's
   256 x 512 grid, boundary 5.0 at 64 x 128, the odd 257 x 383, and 8192 x
   8192) and the operand-forwarding matmul (the suite's 256^3, the
   reference test's (512, 256) x (256, 384) with blocks (256, 128, 128),
   and 4096^3); then the Rodinia suite at its full shapes (all nine parity
   asserts, its CSV and geomean lines), with every launch count set to 0
   before and held at 0 after (its cases call neither kernel), and the two
   ops on the suite's inputs: ``matmul_fwd`` on the matrixMul operands
   against ``matmul_direct`` and ``stencil2d`` on the hotspot and SRAD grid
   against ``hotspot_direct`` and ``srad_direct``, counts held at 1 and 2;
4. each kernel's median time at its main path's shapes beside its plain
   version's time, its bound and, where one PyTorch call computes the same
   function, that call's time (the paper-demo kernels also at 8192^2 and
   4096^3), printed as one ``{"kernels": [...]}`` line; then the card's
   name and power limit, and the result line.
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
PEAK_F32_FLOPS = 67e12             # H100 SXM float32 outside the tensor cores
H, DH = 32, 64

#: (max error) <= ATOL + RTOL * max|plain|, per dtype, with the reason.
TOLERANCE = {
    # f32: the same f32 arithmetic in another summation order.
    "float32": (1e-5, 2e-5),
    # bf16: out is rounded to bf16 (8-bit mantissa) by both versions, so
    # f32 sums that differ in the last bits may round one bf16 ulp apart.
    "bfloat16": (1e-3, 8e-3),
}
#: Flash attention in f32 is held to TOLERANCE; in bf16, per element,
#: scaled to the element and to the RMS of its output row (over D):
#: |got - want| <= ULP * |want| + ROW * rms(want row).  Both versions round
#: the output to bf16 (one ulp apart at most, 2**-7 of the value); the
#: kernel also rounds P to bf16 before the P.V product, 2**-9 relative per
#: term, a random walk over the row's keys that stays several times under
#: 2**-5 of the row's RMS.  A fault that moves whole late rows by a few
#: percent exceeds the row term; a fully masked row must be exactly 0.
ATTN_BF16_ULP, ATTN_BF16_ROW = 2.0 ** -7, 2.0 ** -5
#: The training kernels, per output: (max error) <= ATOL + RTOL * max|plain|
#: of that output.  The backward's grads reach the hundreds (dw divides by
#: w) and sum products of e^{+-64}-scaled factors, so f32 is held relative
#: to each output's largest value; bf16 grads are rounded to bf16 by both
#: versions, one ulp (2**-8 relative) plus the f32 difference.
TRAIN_TOLERANCE = {
    "float32": (1e-5, 1e-4),
    "bfloat16": (1e-3, 8e-3),
}


def _inputs(torch, b, t, dtype, seed, slow=False):
    """WKV inputs on the card with the model's value ranges: the decay
    w = exp(-exp(logit)) with the logit spanning the model's clip.  With
    ``slow`` the decays lie in (0.85, 0.999) instead, so a segment's decay
    product stays above the f32 floor for a few hundred tokens."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def n(*shape, s=1.0):
        return torch.randn(shape, generator=g, device="cuda") * s

    logit = torch.rand((b, H, t, DH), generator=g, device="cuda") * 7.386 - 6.0
    w = torch.exp(-torch.exp(logit))
    if slow:
        w = 0.85 + 0.149 * torch.rand((b, H, t, DH), generator=g, device="cuda")
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
    finds its inputs cold, as the decode loop does).  The cycle runs on
    across the repetitions, so no set is used again before the others
    have passed through the L2.

    Device time: the calls are queued behind a ``torch.cuda._sleep`` so the
    card runs them back to back, and the span between two CUDA events is
    divided by their number.  Call time: CUDA events around one call at a
    time, so it also holds the host's cost of issuing the call."""
    for args in arg_sets[:2]:
        fn(*args)
    torch.cuda.synchronize()
    dev, n = [], 2
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
        dev.append(e0.elapsed_time(e1) / reps)
    call = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn(*arg_sets[n % len(arg_sets)])
        n += 1
        e1.record()
        e1.synchronize()
        call.append(e0.elapsed_time(e1))
    return sorted(dev)[len(dev) // 2], sorted(call)[len(call) // 2]


def _cold_sets(make, nbytes_each):
    """Input sets that together exceed the 50 MB L2 cache twice over."""
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

    # ---- 3g. the sequence-parallel path on a seq mesh of 4 shards ----------
    del engine
    torch.cuda.empty_cache()
    for name, err in _seq_kernel_checks(torch, KC, BW).items():
        worst[name] = max(worst.get(name, 0.0), err)
    seq_launches, seq_extra = _seq_main_path(torch, np, cfg, params)
    launches.update(seq_launches)
    _seq_reference_check(torch, np)

    # ---- 3b. the training path ----------------------------------------------
    del params
    torch.cuda.empty_cache()
    train_launches = _train_main_path(torch, cfg, KC, BW)
    _train_reference_check(torch, get_config)
    launches.update(train_launches)
    torch.cuda.empty_cache()

    # ---- 3d. RecurrentGemma's kernels against their plain versions ---------
    worst.update(_rg_kernel_checks(torch))

    # ---- 3e. the RecurrentGemma path ----------------------------------------
    launches.update(_rg_main_path(torch, np))
    _rg_reference_check(torch, np)

    # ---- 3f. the paper demo: stencil, matmul and the Rodinia suite --------
    worst.update(_paper_kernel_checks(torch))
    launches.update(_paper_main_path(torch))

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
    rows += _time_seq_kernels(torch, KC, launches, worst, seq_extra)
    rows += _time_rg_kernels(torch, launches, worst)
    rows += _time_paper_kernels(torch, launches, worst)

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
    # Copies (casts, .contiguous(), concatenations) and fills, whatever
    # their rank: what a layout change adds or removes shows here.
    for kind in ("copy", "fill"):
        hits = [(us, n) for name, (us, n) in by_name.items() if kind in name.lower()]
        print(f"[profile]   kernels named *{kind}*: {sum(us for us, _ in hits) / 1e3:.2f} ms "
              f"over {sum(n for _, n in hits)} launches")


def _flops(b, t, chunk, windowed):
    """Floating-point operations of one call at (b, H, t, Dh): the decode
    kernels do 5 Dh^2 per token and head; the chunked kernel, per chunk of
    L, L(L-1) Dh (scores) + 2 L^2 Dh (intra) + 4 L Dh^2 (inter, update)."""
    if windowed:
        return b * H * t * 5 * DH * DH
    n, L = t // chunk, chunk
    return b * H * n * (L * (L - 1) * DH + 2 * L * L * DH + 4 * L * DH * DH)


# ---------------------------------------------------------------------------
# The sequence-parallel path: the segment-summary kernels, then the seq
# prefill, generate and gradient of full-size RWKV6-1.6B on a seq mesh of 4
# shards of the one card (phase 3g and its rows of phase 4).
# ---------------------------------------------------------------------------

SEQ_KERNELS = ("wkv_summary_cuda", "wkv_train_summary_cuda")
SEQ_SHARDS = 4
#: Full-size bf16 against the same weights in f32 (no mesh), the seq path's
#: error over the no-mesh path's: at most this factor, for the prefill's
#: logits (max |error| / max |logit|) and for the gradient (per leaf,
#: ||g - g32|| / ||g32||, the worst leaf's ratio).  Both bf16 paths round
#: every layer's activations to bf16; the seq path rounds each shard's WKV
#: output once more (its zero-state sweep's bf16 output plus the f32 entry
#: correction, as the reference does), so it may sit a little further from
#: f32 than the single sweep.  Measured on an H100: 1.012 (logits, 9.4e-2
#: against 9.3e-2) and 1.010 (the worst leaf); a wrong carry or correction
#: puts the seq path far further off.
SEQ_BF16_ERROR_RATIO = 1.25


def _summary_inputs(torch, b, t, dtype, seed, full_t, start, slow):
    """r/k/v/w as the T-window start..start+t of (b, H, full_t, 64)
    tensors (what a shard of the main path hands the kernel), u, h0."""
    a = _inputs(torch, b, full_t, dtype, seed, slow=slow)
    return [x[:, :, start:start + t] for x in a[:4]] + a[4:]


def _seq_kernel_checks(torch, KC, BW):
    """Phase 3g, kernels: both summary wrappers against their plain versions
    on every output, in f32 (TF32 off) and bf16, at the card checks' shapes
    (a shard of each seq call of the main path among them), with the model's
    decays (a long segment's a_seg underflows to 0) and slow ones (a_seg in
    the normal range); their (out, S[, s_hist]) bit for bit equal to the
    contiguous launches'.  Then the backward kernel on the same windows and
    the training summary's s_hist, against its plain version and bit for
    bit against the contiguous launch.  Returns the worst errors."""
    from repro_torch.kernels import card_checks as CC

    worst = dict.fromkeys((*SEQ_KERNELS, "wkv_bwd_cuda"), 0.0)
    with torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16):
            kind = str(dtype).split(".")[-1]
            for b, t, chunk, full_t, start in CC.SUMMARY_CASES:
                for slow in (False, True):
                    a = _summary_inputs(torch, b, t, dtype, 20 + t, full_t, start, slow)
                    flat = [x.contiguous() for x in a]
                    case = (f"B={b} T={t} [{start}:{start + t}] of {full_t} chunk={chunk} "
                            f"{'slow' if slow else 'model'} decays")
                    for kname, kern, plain, bits in (
                            ("wkv_summary_cuda", KC.wkv_summary_cuda, KC.wkv_summary_plain,
                             KC.wkv_cuda),
                            ("wkv_train_summary_cuda", KC.wkv_train_summary_cuda,
                             KC.wkv_train_summary_plain, KC.wkv_train_cuda)):
                        got = kern(*a, chunk=chunk)
                        torch.cuda.synchronize()
                        want = plain(*a, chunk=chunk)
                        atol, rtol = (TOLERANCE if kname == "wkv_summary_cuda"
                                      else TRAIN_TOLERANCE)[kind]
                        errs = [float((x.float() - y.float()).abs().max())
                                for x, y in zip(got[:-1], want[:-1])]
                        tols = [atol + rtol * float(y.float().abs().max()) for y in want[:-1]]
                        ratio = CC.a_seg_ratio(got[-1], want[-1])
                        same = all(torch.equal(x, y) for x, y in
                                   zip(got[:-1], bits(*flat, chunk=chunk)))
                        a_err = float((got[-1] - want[-1]).abs().max())
                        ok = (all(e <= tl for e, tl in zip(errs, tols)) and ratio <= 1.0
                              and same and all(bool(torch.isfinite(x).all()) for x in got))
                        print(f"[seq-kernels] {kname:22s} {case:52s} {kind:8s} max_abs_err "
                              f"{['%.2e' % e for e in errs]} tol {['%.2e' % tl for tl in tols]}; "
                              f"a_seg max_abs_err {a_err:.2e} (max {float(want[-1].max()):.2e}), "
                              f"err/tol {ratio:.3f}; contiguous launch bit for bit: {same} "
                              f"{'ok' if ok else 'FAIL'}")
                        if not ok:
                            raise SystemExit(f"{kname} {case} {kind} disagrees with its plain "
                                             "version or its contiguous launch")
                        worst[kname] = max(worst[kname], *errs, a_err)
                    # The reverse sweep on the same windows (the seq gradient's
                    # backward), from the s_hist of the loop's last kernel, the
                    # training summary.
                    s_hist = got[2]
                    d_out, d_s = _cotangents(torch, b, t, dtype, seed=start + t)
                    bargs = (*a[:5], s_hist, d_out, d_s)
                    gb = BW.wkv_bwd_cuda(*bargs, chunk=chunk)
                    torch.cuda.synchronize()
                    want = BW.wkv_bwd_plain(*bargs, chunk=chunk)
                    atol, rtol = TRAIN_TOLERANCE[kind]
                    errs = [float((x.float() - y.float()).abs().max()) for x, y in zip(gb, want)]
                    tols = [atol + rtol * float(y.float().abs().max()) for y in want]
                    same = all(torch.equal(x, y) for x, y in zip(
                        gb, BW.wkv_bwd_cuda(*flat[:5], s_hist, d_out, d_s, chunk=chunk)))
                    ok = (all(e <= tl for e, tl in zip(errs, tols)) and same
                          and all(bool(torch.isfinite(x).all()) for x in gb))
                    print(f"[seq-kernels] {'wkv_bwd_cuda':22s} {case:52s} {kind:8s} max_abs_err "
                          f"{['%.2e' % e for e in errs]} tol {['%.2e' % tl for tl in tols]}; "
                          f"contiguous launch bit for bit: {same} {'ok' if ok else 'FAIL'}")
                    if not ok:
                        raise SystemExit(f"wkv_bwd_cuda {case} {kind} disagrees with its plain "
                                         "version or its contiguous launch")
                    worst["wkv_bwd_cuda"] = max(worst["wkv_bwd_cuda"], *errs)
    return worst


def _seq_main_path(torch, np, cfg, params, prompt=4096, gen_b=2, gen_p=2048, new=32,
                   k_w=8, grad_t=2048):
    """Phase 3g, main path: full-size RWKV6-1.6B in bf16 on ``make_seq_mesh(4)``
    (4 shards of the card) against the same calls without a mesh: the seq
    prefill (``make_seq_prefill_step``, B=1), ``ServeEngine(mesh=...)
    .generate`` and a loss gradient, each call's launch counts set to 0
    just before and held just after to the counts the code's structure
    gives.  Returns the counts of the seq calls and the timings phase 4
    prints beside the kernel rows."""
    import dataclasses
    from contextlib import nullcontext

    from repro_torch.launch.mesh import make_seq_mesh
    from repro_torch.model import model as M
    from repro_torch.model.sharding import make_rules, sharding_context
    from repro_torch.serve.engine import ServeEngine, make_prefill_step, make_seq_prefill_step
    from repro_torch.train.step import make_loss_fn
    from repro_torch.tree import tree_leaves, tree_map

    mesh = make_seq_mesh(SEQ_SHARDS)
    n_l, n_s = cfg.num_layers, SEQ_SHARDS
    counters = _counters()
    rng = np.random.default_rng(3)
    v = cfg.vocab_size

    def counted(fn):
        for c in counters.values():
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, {n: c.launches for n, c in counters.items()}

    def hold(what, got, want):
        want = {**dict.fromkeys(counters, 0), **want}
        print(f"[seq] launches during {what}: "
              f"{ {n: c for n, c in got.items() if c} }; derived "
              f"{ {n: c for n, c in want.items() if c} }")
        if got != want:
            raise SystemExit(f"{what}: launch counts {got} != derived {want}")

    total = dict.fromkeys(SEQ_KERNELS, 0)
    extra = {}
    # The same weights in f32: the yardstick both bf16 paths are held to.
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = tree_map(lambda p: p.float(), params)

    # -- the seq prefill against the prefill without a mesh, B=1, T=4096.
    tokens = torch.from_numpy(rng.integers(0, v, (1, prompt))).cuda()
    seq_step, plain_step = make_seq_prefill_step(cfg, mesh), make_prefill_step(cfg)
    with torch.inference_mode():
        seq_step(params, tokens[:, :1024])                          # warm-up
        plain_step(params, tokens[:, :1024])
        logits, dt_seq, got = counted(lambda: seq_step(params, tokens))
        hold(f"seq prefill B=1 T={prompt}", got, {"wkv_summary_cuda": n_l * n_s})
        total["wkv_summary_cuda"] += got["wkv_summary_cuda"]
        want, dt_plain, got = counted(lambda: plain_step(params, tokens))
        hold(f"prefill without a mesh B=1 T={prompt}", got, {"wkv_cuda": n_l})
        l32 = make_prefill_step(cfg32)(p32, tokens)[..., :v]
        lg, wt = logits[..., :v].float(), want[..., :v].float()
        scale = float(l32.abs().max())
        rel = float((lg - wt).abs().max()) / float(wt.abs().max())
        e_seq = float((lg - l32).abs().max()) / scale
        e_plain = float((wt - l32).abs().max()) / scale
        argmax = float((lg.argmax(-1) == wt.argmax(-1)).float().mean())
        fin = bool(torch.isfinite(lg).all())
        del logits, want, lg, wt, l32
    print(f"[seq-main] seq prefill (make_seq_prefill_step, {n_s} shards of the card) B=1 "
          f"T={prompt}: {dt_seq:.3f}s, {prompt / dt_seq:,.0f} tok/s; without a mesh "
          f"{dt_plain:.3f}s, {prompt / dt_plain:,.0f} tok/s; logits finite: {fin}; max |error| "
          f"/ max |logit| against the no-mesh prefill {rel:.3e}; against the f32 weights: "
          f"seq {e_seq:.3e}, no mesh {e_plain:.3e} (ratio {e_seq / max(e_plain, 1e-30):.3f}, bound "
          f"{SEQ_BF16_ERROR_RATIO}); argmax equal to the no-mesh prefill's at "
          f"{100 * argmax:.2f}% of positions")
    if not fin or e_seq > SEQ_BF16_ERROR_RATIO * e_plain:
        raise SystemExit("seq prefill: logits not finite or further from f32 than the bound")
    extra["prefill"] = (dt_seq, dt_plain)

    # -- generate on the seq mesh against the engine without one.
    eng_seq = ServeEngine(cfg, params, max_len=gen_p + new + 8, decode_window=k_w, mesh=mesh)
    eng = ServeEngine(cfg, params, max_len=gen_p + new + 8, decode_window=k_w)
    prompts = rng.integers(0, v, (gen_b, gen_p))
    eng_seq.generate(prompts[:, :1024], 2)                          # warm-up
    eng.generate(prompts[:, :1024], 2)
    steps = sum(min(k_w, new - i) for i in range(0, new, k_w)) - 1
    out_seq, dt_seq, got = counted(lambda: eng_seq.generate(prompts, new))
    hold(f"generate on the seq mesh B={gen_b} P={gen_p} +{new} K={k_w}", got,
         {"wkv_summary_cuda": n_l * n_s, "wkv_decode_cuda": n_l * steps})
    total["wkv_summary_cuda"] += got["wkv_summary_cuda"]
    out_plain, dt_plain, got = counted(lambda: eng.generate(prompts, new))
    hold("generate without a mesh", got, {"wkv_cuda": n_l, "wkv_decode_cuda": n_l * steps})
    gs, gp = out_seq[:, gen_p:].cpu().numpy(), out_plain[:, gen_p:].cpu().numpy()
    agree = float((gs == gp).mean())
    first = [int(np.argmax(r != q)) if (r != q).any() else new for r, q in zip(gs, gp)]
    state_ok = bool(M.decode_state_finite(eng_seq.last_state).all())
    print(f"[seq-main] generate on the seq mesh B={gen_b} P={gen_p} +{new} K={k_w}: "
          f"{dt_seq:.3f}s, {gen_b * new / dt_seq:.1f} tok/s incl. prefill; without a mesh "
          f"{dt_plain:.3f}s, {gen_b * new / dt_plain:.1f} tok/s; greedy tokens equal at "
          f"{100 * agree:.1f}% (first difference per row at token {first}); state finite: "
          f"{state_ok}")
    if gs.shape != (gen_b, new) or gs.min() < 0 or gs.max() >= v or not state_ok:
        raise SystemExit("seq generate: bad tokens or state")
    extra["generate"] = (dt_seq, dt_plain, agree)
    del eng_seq, eng
    torch.cuda.empty_cache()

    # -- a loss gradient on the seq mesh against the gradient without one.
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss_fn = make_loss_fn(cfg)
    toks = torch.from_numpy(rng.integers(0, v, (1, grad_t + 1))).cuda()
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    rules = make_rules(mesh, "prefill_seq")
    remat_runs = 2 if cfg.remat == "full" else 1        # forward + recompute

    def grads(seq, tree=params, wrt=leaves, fn=loss_fn):
        with sharding_context(mesh, rules) if seq else nullcontext():
            loss = fn(tree, batch)
            return float(loss.detach()), torch.autograd.grad(loss, wrt)

    grads(True)                                                      # warm-up
    (l_seq, g_seq), dt_seq, got = counted(lambda: grads(True))
    hold(f"loss gradient on the seq mesh B=1 T={grad_t} (remat {cfg.remat})", got,
         {"wkv_train_summary_cuda": remat_runs * n_l * n_s, "wkv_bwd_cuda": n_l * n_s})
    total["wkv_train_summary_cuda"] += got["wkv_train_summary_cuda"]
    (l_plain, g_plain), dt_plain, got = counted(lambda: grads(False))
    hold("loss gradient without a mesh", got,
         {"wkv_train_cuda": remat_runs * n_l, "wkv_bwd_cuda": n_l})
    for p in leaves:
        p.requires_grad_(False)
    leaves32 = [p.requires_grad_(True) for p in tree_leaves(p32)]
    l32, g32 = grads(False, p32, leaves32, make_loss_fn(cfg32))
    del p32, leaves32
    e_seq, e_plain, rels = [], [], []
    for a, b, c in zip(g_seq, g_plain, g32):
        norm = c.norm().clamp_min(1e-30)
        e_seq.append(float((a.float() - c).norm() / norm))
        e_plain.append(float((b.float() - c).norm() / norm))
        rels.append(float((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30)))
    ratio = max(x / max(y, 1e-30) for x, y in zip(e_seq, e_plain))
    fin = all(bool(torch.isfinite(g).all()) for g in g_seq)
    print(f"[seq-main] loss gradient on the seq mesh B=1 T={grad_t}: {dt_seq:.3f}s (without "
          f"a mesh {dt_plain:.3f}s); loss {l_seq:.6f} vs {l_plain:.6f} (f32 weights "
          f"{l32:.6f}); per leaf, against the no-mesh gradient ||g_seq - g_plain|| / "
          f"||g_plain|| median {sorted(rels)[len(rels) // 2]:.3e}, max {max(rels):.3e}; "
          f"against the f32 gradient, seq median {sorted(e_seq)[len(e_seq) // 2]:.3e} max "
          f"{max(e_seq):.3e}, no mesh median {sorted(e_plain)[len(e_plain) // 2]:.3e} max "
          f"{max(e_plain):.3e}; worst leaf's ratio {ratio:.3f} (bound "
          f"{SEQ_BF16_ERROR_RATIO}); finite: {fin}")
    if not fin or ratio > SEQ_BF16_ERROR_RATIO:
        raise SystemExit("seq gradient: not finite or further from f32 than the bound")
    extra["grad"] = (dt_seq, dt_plain)
    del g_seq, g_plain, g32
    torch.cuda.empty_cache()
    for p in leaves:
        p.requires_grad_(True)
    _profile(torch, lambda: grads(True), f"loss gradient on the seq mesh B=1 T={grad_t}", top=10)
    _profile(torch, lambda: grads(False), f"loss gradient without a mesh B=1 T={grad_t}", top=6)
    for p in leaves:
        p.requires_grad_(False)
    torch.cuda.empty_cache()
    _profile(torch, lambda: _no_grad_call(torch, seq_step, params, tokens),
             f"seq prefill B=1 T={prompt}, {n_s} shards", top=10)
    return total, extra


def _no_grad_call(torch, fn, *args):
    with torch.inference_mode():
        return fn(*args)


def _seq_reference_check(torch, np):
    """Phase 3g, reduced f32 RWKV6 on a seq mesh of 4 shards, the card
    against the CPU, within the CPU tests' tolerances: the seq prefill's
    logits (T=1024, 2e-3), the greedy tokens of ``generate`` on a 1024-token
    prompt (equal), and the seq gradient (T=256 over 4 shards, 3e-3 of each
    leaf's largest value)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import make_seq_mesh
    from repro_torch.model import model as M
    from repro_torch.model.sharding import make_rules, sharding_context
    from repro_torch.serve.engine import ServeEngine, make_seq_prefill_step
    from repro_torch.train.step import make_loss_fn
    from repro_torch.tree import tree_leaves, tree_unflatten

    cfg = get_config("rwkv6-1.6b").reduced()
    p_cpu = M.init_params(cfg, seed=1, device="cpu")
    p_gpu = _to(p_cpu, "cuda")
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 1024)))
    meshes = {"cpu": make_seq_mesh(SEQ_SHARDS, device="cpu"), "cuda": make_seq_mesh(SEQ_SHARDS)}
    params = {"cpu": p_cpu, "cuda": p_gpu}
    logits, gen, grads = {}, {}, {}
    batch = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 257)))
    for dev in ("cpu", "cuda"):
        with torch.inference_mode():
            logits[dev] = make_seq_prefill_step(cfg, meshes[dev])(
                params[dev], toks.to(dev)).cpu()
        gen[dev] = ServeEngine(cfg, params[dev], max_len=1100, device=dev,
                               mesh=meshes[dev]).generate(toks.to(dev), 12).cpu()
        leaves = [p.detach().clone().requires_grad_(True) for p in tree_leaves(params[dev])]
        tree = tree_unflatten(params[dev], leaves)
        b = batch.to(dev)
        with sharding_context(meshes[dev], make_rules(meshes[dev], "prefill_seq")):
            loss = make_loss_fn(cfg)(tree, {"tokens": b[:, :-1], "labels": b[:, 1:]})
            grads[dev] = [g.cpu() for g in torch.autograd.grad(loss, leaves)]
    err = float((logits["cpu"] - logits["cuda"]).abs().max())
    same = torch.equal(gen["cpu"], gen["cuda"])
    gerr = max(float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
               for a, b in zip(grads["cuda"], grads["cpu"]))
    print(f"[reference] reduced f32 rwkv6 on a seq mesh of {SEQ_SHARDS}, card vs CPU: seq "
          f"prefill T=1024 max_abs_err={err:.2e} (tol 2e-3), greedy tokens equal: {same}, "
          f"seq grads T=256 worst err / max(1, max|g|) = {gerr:.2e} (tol 3e-3)")
    if err > 2e-3 or not same or gerr > 3e-3:
        raise SystemExit("card and CPU disagree on the reduced seq path")


def _time_seq_kernels(torch, KC, launches, worst, extra, t_full=4096, grad_t=2048, chunk=16):
    """Phase 4 rows of the summary kernels at a shard of the main path: one
    quarter (the window 2048..3072) of a 4096-token prompt at B=1 for the
    inference sweep, one quarter of the gradient's 2048 tokens for the
    training sweep (and a 1024-token shard beside it), read in place, zero
    h0, bf16.  Then the n=4 shard launches of one layer back to back against
    one ``wkv_cuda`` sweep over the whole 4096 tokens, and the prefill,
    generate and gradient wall times of phase 3g."""
    bf = torch.bfloat16
    rows = []

    def full(seed, n=t_full):
        """An n-token prompt's r/k/v/w/u and a zero h0, as the shards get."""
        a = _inputs(torch, 1, n, bf, seed)
        return a[:5] + [torch.zeros_like(a[5])]

    def row(name, kern, plain, t, n, hist, source_note):
        """The row of a shard of t tokens of an n-token prompt: cold input
        sets are windows of distinct prompts."""
        nbytes = (5 * H * t * DH * 2 + H * DH * 2 + 2 * H * DH * DH * 4 + H * DH * 4
                  + (H * (t // chunk) * DH * DH * 4 if hist else 0))

        def window(seed):
            a, s0 = full(seed, n), (seed % (n // t)) * t
            return [x[:, :, s0:s0 + t] for x in a[:4]] + a[4:]

        sets = _cold_sets(window, n * H * DH * 2 * 4)
        ms, call_ms = _time_ms(torch, lambda *a: kern(*a, chunk=chunk), sets, reps=50)
        plain_ms, _ = _time_ms(torch, lambda *a: plain(*a, chunk=chunk), sets, reps=3)
        flops = _flops(1, t, chunk, windowed=False)
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        f_ms = flops / PEAK_BF16_FLOPS * 1e3
        r = {"name": name, "route": "cuda",
             "source": "src/repro_torch/kernels/wkv/csrc/wkv_chunked.cu",
             "replaces": source_note, "launches": launches[name],
             "max_abs_err": worst[name], "ms": ms, "plain_ms": plain_ms,
             "bound_ms": max(b_ms, f_ms), "bound_by": "bytes" if b_ms >= f_ms else "operations",
             "library_ms": None, "call_ms": call_ms,
             "shape": f"B=1 H=32 T={t} (a window of {n}) Dh=64 bf16 chunk={chunk}"}
        print(f"[time] {name:24s} {r['shape']:50s} device {ms * 1e3:8.2f} us, per call "
              f"{call_ms * 1e3:8.2f} us (plain {plain_ms * 1e3:9.1f} us, bound "
              f"{r['bound_ms'] * 1e3:.2f} us by {r['bound_by']}; {nbytes / 1e6:.1f} MB, "
              f"{flops / 1e9:.2f} GFLOP)")
        return r

    with torch.inference_mode():
        rows.append(row("wkv_summary_cuda", KC.wkv_summary_cuda, KC.wkv_summary_plain,
                        t_full // SEQ_SHARDS, t_full, False,
                        "src/repro/kernels/wkv/kernel.py:262 (wkv_pallas_summary)"))
        grad_shard = row("wkv_train_summary_cuda", KC.wkv_train_summary_cuda,
                         KC.wkv_train_summary_plain, grad_t // SEQ_SHARDS, grad_t, True,
                         "src/repro/kernels/wkv/kernel.py:289 (wkv_pallas_train_summary)")
        long_shard = row("wkv_train_summary_cuda", KC.wkv_train_summary_cuda,
                         KC.wkv_train_summary_plain, t_full // SEQ_SHARDS, t_full, True,
                         "src/repro/kernels/wkv/kernel.py:289 (wkv_pallas_train_summary)")
        rows.append({**grad_shard, "large": [
            {k: long_shard[k] for k in ("shape", "ms", "call_ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms")}]})

        # One layer's n shard launches back to back against one sweep of the
        # whole prompt (the same tokens, the same chunk-steps in all).
        q = t_full // SEQ_SHARDS

        def shards(*a):
            for j in range(SEQ_SHARDS):
                KC.wkv_summary_cuda(*[x[:, :, j * q:(j + 1) * q] for x in a[:4]], *a[4:],
                                    chunk=chunk)

        full_sets = _cold_sets(full, t_full * H * DH * 2 * 5)
        ms_shards, _ = _time_ms(torch, shards, full_sets, reps=20)
        ms_one, _ = _time_ms(torch, lambda *a: KC.wkv_cuda(*a, chunk=chunk), full_sets, reps=20)
    print(f"[time] one layer of the seq prefill B=1 T={t_full}: {SEQ_SHARDS} summary launches "
          f"(each 64 blocks on 132 SMs) back to back {ms_shards * 1e3:.2f} us against one "
          f"wkv_cuda sweep {ms_one * 1e3:.2f} us ({ms_shards / ms_one:.2f}x)")
    (p_seq, p_plain), (g_seq, g_plain, agree), (d_seq, d_plain) = (
        extra["prefill"], extra["generate"], extra["grad"])
    print(f"[time] phase 3g wall: seq prefill {p_seq * 1e3:.1f} ms vs {p_plain * 1e3:.1f} ms "
          f"without a mesh ({p_plain / p_seq:.2f}x the tokens/s); generate {g_seq * 1e3:.1f} "
          f"vs {g_plain * 1e3:.1f} ms; gradient {d_seq * 1e3:.1f} vs {d_plain * 1e3:.1f} ms")
    return rows


# ---------------------------------------------------------------------------
# RecurrentGemma: the elevator scan and its decode window, the token shift
# and flash attention (phases 3d, 3e and their rows of phase 4).
# ---------------------------------------------------------------------------

RG_D = 2560                      # d_rnn of recurrentgemma-2b
RG_HQ, RG_HKV, RG_DH, RG_WINDOW = 10, 1, 256, 2048
RG_KERNELS = ("elevator_scan_cuda", "elevator_decode_window_cuda",
              "token_shift_cuda", "flash_attention_cuda")
WKV_KERNELS = ("wkv_cuda", "wkv_decode_cuda", "wkv_decode_window_cuda",
               "wkv_train_cuda", "wkv_bwd_cuda", "wkv_summary_cuda",
               "wkv_train_summary_cuda")


def _rg_modules():
    from repro_torch.kernels.elevator_scan import decode as ED
    from repro_torch.kernels.elevator_scan import kernel as EK
    from repro_torch.kernels.local_attention import kernel as FA
    from repro_torch.kernels.token_shift import kernel as TS
    return EK, ED, TS, FA


def _counters():
    """Every kernel wrapper of the port, by name."""
    from repro_torch.kernels.wkv import bwd as BW
    from repro_torch.kernels.wkv import decode as D
    from repro_torch.kernels.wkv import kernel as KC

    EK, ED, TS, FA = _rg_modules()
    MM, ST = _paper_modules()
    fns = (KC.wkv_cuda, D.wkv_decode_cuda, D.wkv_decode_window_cuda, KC.wkv_train_cuda,
           BW.wkv_bwd_cuda, KC.wkv_summary_cuda, KC.wkv_train_summary_cuda,
           EK.elevator_scan_cuda, ED.elevator_decode_window_cuda,
           TS.token_shift_cuda, FA.flash_attention_cuda, MM.matmul_fwd_cuda,
           ST.stencil2d_cuda)
    return {fn.__name__: fn for fn in fns}


def _scan_inputs(torch, b, t, dtype, seed):
    """Elevator-scan inputs on the card in the RG-LRU regime: decay a in
    (0.5, 1), x ~ N(0, 1), h0 ~ N(0, 1) f32."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.rand((b, t, RG_D), generator=g, device="cuda") * 0.5 + 0.5
    x = torch.randn((b, t, RG_D), generator=g, device="cuda")
    h0 = torch.randn((b, RG_D), generator=g, device="cuda")
    return a.to(dtype), x.to(dtype), h0


def _shift_inputs(torch, b, t, dtype, seed, taps=4):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((b, t, RG_D), generator=g, device="cuda")
    w = torch.randn((taps, RG_D), generator=g, device="cuda") * 0.1
    return x.to(dtype), w.to(dtype)


def _attn_inputs(torch, b, t, s, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, RG_HQ, t, RG_DH), generator=g, device="cuda")
    k = torch.randn((b, RG_HKV, s, RG_DH), generator=g, device="cuda")
    v = torch.randn((b, RG_HKV, s, RG_DH), generator=g, device="cuda")
    return q.to(dtype), k.to(dtype), v.to(dtype)


#: (T, S, causal, window) of the flash-attention checks.
ATTN_CASES = (
    (4096, 4096, True, RG_WINDOW),     # the local layers of a 4096-token forward
    (1024, 1024, True, None),          # causal, full
    (640, 640, False, 200),            # non-causal window
    (8, 300, True, None),              # decode offset
    (1000, 1000, True, 256),           # T not a block multiple
)


def _rg_kernel_checks(torch):
    """Phase 3d.  Returns the worst max abs error of each kernel."""
    EK, ED, TS, FA = _rg_modules()
    worst = dict.fromkeys(RG_KERNELS, 0.0)

    def check(kname, case, dtype, got, want):
        atol, rtol = TOLERANCE[str(dtype).split(".")[-1]]
        e, s = _err(got, want)
        tol = atol + rtol * s
        ok = e <= tol and all(bool(torch.isfinite(a).all()) for a in got)
        print(f"[rg-kernels] {kname:28s} {case:30s} {str(dtype):15s} "
              f"max_abs_err={e:.3e} tol={tol:.3e} (max|plain|={s:.2f}) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"{kname} {case} {dtype}: error {e} > {tol}")
        worst[kname] = max(worst[kname], e)

    def check_bf16_attention(case, got, want):
        g, w = got.float(), want.float()
        err = (g - w).abs()
        tol = ATTN_BF16_ULP * w.abs() + ATTN_BF16_ROW * w.pow(2).mean(-1, keepdim=True).sqrt()
        ratio = torch.where(tol > 0, err / tol.clamp_min(1e-30), err * float("inf"))
        r, e = float(ratio.nan_to_num(0.0).max()), float(err.max())
        ok = r <= 1.0 and bool(torch.isfinite(got).all())
        print(f"[rg-kernels] {'flash_attention_cuda':28s} {case:30s} torch.bfloat16  "
              f"max_abs_err={e:.3e} worst err/tol per element={r:.3f} "
              f"(tol {ATTN_BF16_ULP:.4g}*|plain| + {ATTN_BF16_ROW:.4g}*rms(row)) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"flash_attention_cuda {case} bfloat16: error {r} x tolerance")
        worst["flash_attention_cuda"] = max(worst["flash_attention_cuda"], e)

    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            for b, t in ((4, 256), (1, 4096)):
                a, x, h0 = _scan_inputs(torch, b, t, dtype, seed=t)
                got = EK.elevator_scan_cuda(a, x, h0)
                torch.cuda.synchronize()
                check("elevator_scan_cuda", f"B={b} T={t} D={RG_D}", dtype, [got],
                      [EK.elevator_scan_ref(a, x, h0)])
            for kw in (1, 8, 37, 64):
                a, x, h0 = _scan_inputs(torch, 4, kw, dtype, seed=100 + kw)
                got = ED.elevator_decode_window_cuda(a, x, h0)
                torch.cuda.synchronize()
                check("elevator_decode_window_cuda", f"B=4 K={kw} D={RG_D}", dtype, got,
                      ED.elevator_decode_window_plain(a, x, h0))
                h, outs = h0, []
                for i in range(kw):
                    o, h = ED.elevator_decode_window_cuda(a[:, i:i + 1].contiguous(),
                                                          x[:, i:i + 1].contiguous(), h)
                    outs.append(o)
                same = torch.equal(torch.cat(outs, 1), got[0]) and torch.equal(h, got[1])
                print(f"[rg-kernels] elevator window K={kw} {dtype} bit-identical to "
                      f"{kw} chained single launches: {same}")
                if not same:
                    raise SystemExit("elevator window differs from chained single launches")
            for b, t in ((4, 4), (4, 67), (4, 259), (1, 4096)):
                x, w = _shift_inputs(torch, b, t, dtype, seed=t)
                got = TS.token_shift_cuda(x, w)
                torch.cuda.synchronize()
                want = TS.token_shift_ref(x, w)
                check("token_shift_cuda", f"B={b} T={t} D={RG_D}", dtype, [got], [want])
                print(f"[rg-kernels] token shift T={t} {dtype} bit-identical to the plain "
                      f"version: {torch.equal(got, want)}")
            for t, s, causal, window in ATTN_CASES:
                q, k, v = _attn_inputs(torch, 1, t, s, dtype, seed=t + s)
                got = FA.flash_attention_cuda(q, k, v, causal=causal, window=window)
                torch.cuda.synchronize()
                case = f"T={t} S={s} {'causal' if causal else 'full'} W={window}"
                want = FA.attention_ref(q, k, v, causal=causal, window=window)
                if dtype == torch.bfloat16:
                    check_bf16_attention(case, got, want)
                else:
                    check("flash_attention_cuda", case, dtype, [got], [want])
    return worst


def _rg_requests(rng, vocab):
    from repro_torch.serve.engine import Request

    return [Request(tokens=rng.integers(0, vocab, int(rng.integers(8, 49))),
                    max_new_tokens=int(rng.integers(2, 17))) for _ in range(6)]


def _rg_main_path(torch, np, batch=4, prompt=256, new=32, k_w=8, score_t=4096):
    """Phase 3e: full-size recurrentgemma-2b through generate, serve and
    prompt scoring, each call's launch counts held to the counts its
    structure gives.  Returns the counts of the whole phase."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.elevator_scan.decode import ELEVATOR_DECODE_WINDOW_MAX
    from repro_torch.model import model as M
    from repro_torch.serve.engine import ServeEngine, _bucket32, make_prefill_step

    cfg = get_config("recurrentgemma-2b")
    n_rec = cfg.layer_kinds.count("rec")
    n_local = cfg.layer_kinds.count("local")
    counters = _counters()
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in _leaves(params))
    print(f"[rg] {cfg.name}: {n_params / 1e9:.3f}B params in {cfg.dtype} "
          f"({cfg.num_layers} layers: {n_rec} rec, {n_local} local), initialized in "
          f"{time.perf_counter() - t0:.1f}s")
    engine = ServeEngine(cfg, params, max_len=512, decode_window=k_w)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (batch, prompt))
    reqs = _rg_requests(rng, cfg.vocab_size)
    scoring = make_prefill_step(cfg)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, score_t))).cuda()
    with torch.inference_mode():                              # warm-up
        engine.generate(prompts[:, :80], 2)
        engine.serve(reqs[:1], slots=4)
        scoring(params, tokens[:, :256])
    torch.cuda.synchronize()

    def counted(fn):
        for c in counters.values():
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, {n: c.launches for n, c in counters.items()}

    def hold(what, got, want):
        want = {**dict.fromkeys(counters, 0), **want}
        print(f"[rg] launches during {what}: "
              f"{ {n: got[n] for n in RG_KERNELS} }; derived "
              f"{ {n: want[n] for n in RG_KERNELS} }; WKV kernels "
              f"{sum(got[n] for n in WKV_KERNELS)}")
        if got != want:
            raise SystemExit(f"{what}: launch counts {got} != derived {want}")

    total = dict.fromkeys(RG_KERNELS, 0)
    # generate: one prefill window of P tokens, then new - 1 single-token steps.
    out, dt, got = counted(lambda: engine.generate(prompts, new))
    steps = 1 + (new - 1)
    long_prefill = prompt > ELEVATOR_DECODE_WINDOW_MAX
    hold("generate", got, {
        "token_shift_cuda": n_rec * steps,
        "elevator_scan_cuda": n_rec * long_prefill,
        "elevator_decode_window_cuda": n_rec * (steps - long_prefill),
    })
    gen = out[:, prompt:].cpu().numpy()
    gen_ok = bool(M.decode_state_finite(engine.last_state).all())
    print(f"[rg-main] generate B={batch} P={prompt} +{new} K={k_w}: {dt:.3f}s, "
          f"{batch * new / dt:.1f} tok/s incl. prefill; state finite: {gen_ok}")
    if gen.shape != (batch, new) or gen.min() < 0 or gen.max() >= cfg.vocab_size or not gen_ok:
        raise SystemExit(f"rg generate: bad tokens or state, shape {gen.shape}")
    for n in RG_KERNELS:
        total[n] += got[n]

    # serve: one masked admission window per round and K single-token steps
    # per decode window; every admission bucket here is at most 64 tokens.
    results, dt, got = counted(lambda: engine.serve(reqs, slots=4))
    st = engine.last_serve_stats
    if _bucket32(max(len(r.tokens) for r in reqs)) > ELEVATOR_DECODE_WINDOW_MAX:
        raise SystemExit("rg serve: an admission bucket exceeds the window kernel")
    steps = st["admissions"] + st["decode_dispatches"] * k_w
    hold("serve", got, {"token_shift_cuda": n_rec * steps,
                        "elevator_decode_window_cuda": n_rec * steps})
    emitted = sum(r.size for r in results)
    serve_ok = bool(M.decode_state_finite(engine.last_state).all())
    print(f"[rg-main] serve 6 requests, 4 slots, K={k_w}: {emitted} tokens in {dt:.3f}s, "
          f"{emitted / dt:.1f} tok/s; {st}; outcomes {[r.outcome for r in results]}; "
          f"state finite: {serve_ok}")
    for req, res in zip(reqs, results):
        if res.outcome != "ok" or res.size != req.max_new_tokens:
            raise SystemExit(f"rg serve: {res.outcome} with {res.size} tokens")
        if res.tokens.min() < 0 or res.tokens.max() >= cfg.vocab_size:
            raise SystemExit("rg serve: token outside the vocabulary")
    if not serve_ok:
        raise SystemExit("rg serve: decode state not finite")
    for n in RG_KERNELS:
        total[n] += got[n]

    # prompt scoring: one cache-free forward (prefill_chunks 1).
    with torch.inference_mode():
        logits, dt, got = counted(lambda: scoring(params, tokens))
    hold(f"forward B=1 T={score_t}", got, {
        "token_shift_cuda": n_rec, "elevator_scan_cuda": n_rec,
        "flash_attention_cuda": n_local})
    fin = bool(torch.isfinite(logits[..., :cfg.vocab_size]).all())
    nll = float(torch.nn.functional.cross_entropy(
        logits[0, :-1, :cfg.vocab_size].float(), tokens[0, 1:]))
    print(f"[rg-main] forward (make_prefill_step) B=1 T={score_t}: {dt:.3f}s, "
          f"{score_t / dt:,.0f} tok/s; logits {tuple(logits.shape)} finite: {fin}; "
          f"mean NLL {nll:.3f} (random weights; ln V = {math.log(cfg.vocab_size):.3f})")
    if logits.shape != (1, score_t, cfg.padded_vocab) or not fin:
        raise SystemExit("rg forward: bad logits")
    for n in RG_KERNELS:
        total[n] += got[n]
    del logits

    _profile(torch, lambda: engine.generate(prompts, 16),
             f"rg generate B={batch} P={prompt} +16 K={k_w}")
    with torch.inference_mode():
        _profile(torch, lambda: scoring(params, tokens), f"rg forward B=1 T={score_t}", top=10)
    del engine, params
    torch.cuda.empty_cache()
    return total


def _rg_reference_check(torch, np):
    """The reduced f32 RecurrentGemma with the kernels on the card against
    the same weights with the plain versions on the CPU: forward logits
    at T=200 (past its window of 64) within 1e-4, and greedy tokens (a
    40-token prefill through the window kernels, then single steps)
    equal."""
    from repro_torch.configs.registry import get_config
    from repro_torch.model import model as M
    from repro_torch.serve.engine import ServeEngine

    cfg = get_config("recurrentgemma-2b").reduced()
    p_cpu = M.init_params(cfg, seed=1, device="cpu")
    p_gpu = _to(p_cpu, "cuda")
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 200)))
    with torch.inference_mode():
        l_cpu = M.forward(p_cpu, cfg, toks)
        l_gpu = M.forward(p_gpu, cfg, toks.cuda()).cpu()
    err = float((l_cpu - l_gpu).abs().max())
    g_cpu = ServeEngine(cfg, p_cpu, max_len=128, device="cpu").generate(toks[:, :40], 12)
    g_gpu = ServeEngine(cfg, p_gpu, max_len=128).generate(toks[:, :40].cuda(), 12).cpu()
    same = torch.equal(g_cpu, g_gpu)
    print(f"[reference] reduced f32 recurrentgemma, card vs CPU: forward T=200 "
          f"max_abs_err={err:.2e} (tol 1e-4), greedy tokens equal: {same}")
    if err > 1e-4 or not same:
        raise SystemExit("card and CPU disagree on the reduced recurrentgemma")


def _visible_pairs(t, s, causal, window):
    """Query-key pairs the attention mask admits (the work of this call)."""
    off = s - t
    total = 0
    for i in range(t):
        if causal:
            hi = min(s, i + off + 1)
            lo = max(0, i + off - window + 1) if window else 0
        else:
            hi = min(s, i + window) if window else s
            lo = max(0, i - window + 1) if window else 0
        total += max(0, hi - lo)
    return total


def _time_rg_kernels(torch, launches, worst):
    """Phase 4 rows of RecurrentGemma's kernels at the main path's shapes:
    the scan and the token shift of a 4096-token forward (B=1), the window
    at a generated token (K=1, B=4) and flash attention of a local layer
    of the forward.  ``library_ms``: a depthwise ``F.conv1d`` for the
    token shift and ``F.scaled_dot_product_attention`` with the same
    boolean mask and GQA for attention; no single PyTorch call computes a
    decayed linear scan, so the scan rows have none."""
    F = torch.nn.functional
    EK, ED, TS, FA = _rg_modules()
    f32, bf = torch.float32, torch.bfloat16
    rows = []

    def row(name, source, replaces, shape, sets, kern, plain, nbytes, flops,
            library=None, peak=PEAK_BF16_FLOPS, reps=50):
        ms, call_ms = _time_ms(torch, kern, sets, reps=reps)
        plain_ms, _ = _time_ms(torch, plain, sets, reps=3)
        lib_ms = _time_ms(torch, library, sets, reps=reps)[0] if library else None
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        f_ms = flops / peak * 1e3
        rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": worst[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(b_ms, f_ms),
            "bound_by": "bytes" if b_ms >= f_ms else "operations",
            "library_ms": lib_ms, "call_ms": call_ms, "shape": shape,
        })
        lib = f", library {lib_ms * 1e3:.2f} us" if lib_ms is not None else ""
        print(f"[time] {name:28s} {shape:40s} device {ms * 1e3:9.2f} us, per call "
              f"{call_ms * 1e3:9.2f} us (plain {plain_ms * 1e3:10.1f} us, bound "
              f"{rows[-1]['bound_ms'] * 1e3:.2f} us by {rows[-1]['bound_by']}{lib}; "
              f"{nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP)")

    scan_src = "src/repro_torch/kernels/elevator_scan/csrc/elevator_scan.cu"
    with torch.inference_mode():
        # The chunked scan of a 4096-token forward (f32 a and x, as the
        # model passes them) and of the generate prefill (B=4, T=256).
        for b, t in ((1, 4096), (4, 256)):
            nbytes = 3 * b * t * RG_D * 4 + b * RG_D * 4
            sets = _cold_sets(lambda s: _scan_inputs(torch, b, t, f32, s), nbytes)
            row("elevator_scan_cuda", scan_src,
                "src/repro/kernels/elevator_scan/kernel.py:78 (elevator_scan_pallas)",
                f"B={b} T={t} D={RG_D} f32", sets, EK.elevator_scan_cuda,
                EK.elevator_scan_ref, nbytes, 2 * b * t * RG_D, peak=PEAK_F32_FLOPS,
                reps=50 if t < 4096 else 20)
        # The window at one generated token: K=1, B=4.
        nbytes = 3 * 4 * RG_D * 4 + 2 * 4 * RG_D * 4
        sets = _cold_sets(lambda s: _scan_inputs(torch, 4, 1, f32, s), nbytes)
        row("elevator_decode_window_cuda", scan_src,
            "src/repro/kernels/elevator_scan/decode.py:64 (elevator_decode_window_pallas)",
            f"B=4 K=1 D={RG_D} f32", sets, ED.elevator_decode_window_cuda,
            ED.elevator_decode_window_plain, nbytes, 2 * 4 * RG_D, peak=PEAK_F32_FLOPS,
            reps=200)

        # The token shift of the forward (bf16, B=1, T=4096), its library
        # call a depthwise conv1d over the (B, D, T) layout conv1d takes.
        def conv1d(x, w):
            return F.conv1d(x, w, padding=w.shape[-1] - 1, groups=RG_D)

        for b, t in ((1, 4096), (4, 4)):
            nbytes = 2 * b * t * RG_D * 2 + 4 * RG_D * 2
            sets = _cold_sets(lambda s: _shift_inputs(torch, b, t, bf, s), nbytes)
            lib_sets = [(x.transpose(1, 2).contiguous(), w.t().flip(1)[:, None].contiguous())
                        for x, w in sets]
            got = conv1d(*lib_sets[0])[..., :t].transpose(1, 2)
            lib_err = float((got.float() - TS.token_shift_cuda(*sets[0]).float()).abs().max())
            print(f"[time] conv1d library call agrees with token_shift_cuda at T={t}: "
                  f"max_abs_err={lib_err:.3e}")
            ms_lib = _time_ms(torch, conv1d, lib_sets, reps=50)[0]
            row("token_shift_cuda",
                "src/repro_torch/kernels/token_shift/csrc/token_shift.cu",
                "src/repro/kernels/token_shift/kernel.py:55 (token_shift_pallas)",
                f"B={b} T={t} D={RG_D} taps=4 bf16", sets, TS.token_shift_cuda,
                TS.token_shift_ref, nbytes, 2 * 4 * b * t * RG_D, peak=PEAK_F32_FLOPS,
                reps=100)
            rows[-1]["library_ms"] = ms_lib
            print(f"[time]   conv1d library call: {ms_lib * 1e3:.2f} us")

        # Flash attention of one local layer in the forward.
        from repro_torch.kernels.local_attention.ref import attention_mask

        t = 4096
        mask = attention_mask(t, t, causal=True, window=RG_WINDOW, device="cuda")
        nbytes = 2 * (2 * RG_HQ * t * RG_DH + 2 * RG_HKV * t * RG_DH)
        flops = 4 * RG_DH * RG_HQ * _visible_pairs(t, t, True, RG_WINDOW)
        sets = _cold_sets(lambda s: _attn_inputs(torch, 1, t, t, bf, s), nbytes)

        def sdpa(q, k, v):
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True)

        lib_err = float((sdpa(*sets[0]).float() - FA.flash_attention_cuda(
            *sets[0], causal=True, window=RG_WINDOW).float()).abs().max())
        print(f"[time] SDPA library call agrees with flash_attention_cuda: "
              f"max_abs_err={lib_err:.3e}")
        row("flash_attention_cuda",
            "src/repro_torch/kernels/local_attention/csrc/flash_attention.cu",
            "src/repro/kernels/local_attention/kernel.py:137 (flash_attention_pallas)",
            f"B=1 Hq=10 Hkv=1 T={t} D=256 W={RG_WINDOW} bf16", sets,
            lambda q, k, v: FA.flash_attention_cuda(q, k, v, causal=True, window=RG_WINDOW),
            lambda q, k, v: FA.attention_ref(q, k, v, causal=True, window=RG_WINDOW),
            nbytes, flops, library=sdpa, reps=20)
    # One row per kernel in the result line: the main path's shape (the
    # first row of each name); the others are printed above.
    seen, out = set(), []
    for r in rows:
        if r["name"] not in seen:
            seen.add(r["name"])
            out.append(r)
    return out

# ---------------------------------------------------------------------------
# The paper demo: the 5-point stencil, the operand-forwarding matmul and the
# Rodinia suite (phase 3f and the rows of phase 4).
# ---------------------------------------------------------------------------

PAPER_KERNELS = ("matmul_fwd_cuda", "stencil2d_cuda")
def _paper_modules():
    from repro_torch.kernels.matmul_fwd import kernel as MM
    from repro_torch.kernels.stencil2d import kernel as ST
    return MM, ST


def _matmul_inputs(torch, m, k, n, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.randn((m, k), generator=g, device="cuda")
    b = torch.randn((k, n), generator=g, device="cuda")
    return a.to(dtype), b.to(dtype)


def _stencil_inputs(torch, h, w, dtype, seed, coeffs):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((h, w), generator=g, device="cuda")
    return x.to(dtype), torch.tensor(coeffs, device="cuda")


def _paper_kernel_checks(torch):
    """Phase 3f, kernels.  Returns the worst max abs error of each."""
    from repro_torch.kernels import card_checks as CC

    MM, ST = _paper_modules()
    worst = dict.fromkeys(PAPER_KERNELS, 0.0)
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            for h, w, coeffs, bnd in CC.STENCIL_CASES:
                x, c = _stencil_inputs(torch, h, w, dtype, seed=h + w, coeffs=coeffs)
                got = ST.stencil2d_cuda(x, c, boundary=bnd)
                torch.cuda.synchronize()
                want = ST.stencil2d_ref(x, c, bnd)
                err = (got.float() - want.float()).abs()
                same = torch.equal(got, want)
                # f32: bit for bit; bf16: one ulp of the plain output.
                ok = same if dtype == torch.float32 else bool(
                    (err <= CC.bf16_ulp(want)).all())
                print(f"[paper-kernels] stencil2d_cuda  {h}x{w} c={coeffs} b={bnd} "
                      f"{str(dtype):15s} max_abs_err={float(err.max()):.3e} "
                      f"bit-identical: {same} {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise SystemExit(f"stencil2d_cuda {h}x{w} {dtype} disagrees with its plain version")
                worst["stencil2d_cuda"] = max(worst["stencil2d_cuda"], float(err.max()))
            for m, k, n, bm, bn, bk in CC.MATMUL_CASES:
                a, b = _matmul_inputs(torch, m, k, n, dtype, seed=m + n)
                got = MM.matmul_fwd_cuda(a, b, block_m=bm, block_n=bn, block_k=bk)
                torch.cuda.synchronize()
                want = MM.matmul_ref(a, b)
                e, f32_tol, ratio = CC.matmul_error(got, want)
                scale = float(want.float().abs().max())
                print(f"[paper-kernels] matmul_fwd_cuda ({m},{k})x({k},{n}) blocks "
                      f"({bm},{bn},{bk}) {str(dtype):15s} max_abs_err={e:.3e} "
                      f"rel={e / scale:.3e} (f32 tol {CC.MATMUL_F32_RTOL:g}*max|plain| = "
                      f"{f32_tol:.3e}{'' if dtype == torch.float32 else ' + 1 bf16 ulp'}) "
                      f"worst err/tol={ratio:.3f} {'ok' if ratio <= 1.0 else 'FAIL'}")
                if not ratio <= 1.0 or not bool(torch.isfinite(got).all()):
                    raise SystemExit(f"matmul_fwd_cuda ({m},{k},{n}) {dtype}: error {e}")
                worst["matmul_fwd_cuda"] = max(worst["matmul_fwd_cuda"], e)
    return worst


def _paper_main_path(torch):
    """Phase 3f, main path: the Rodinia suite at full size (launches none of
    the port's kernels), then the ops on its inputs (one matmul, two
    stencils).  Returns the counts of the op calls."""
    from repro_torch.benchmarks import rodinia as RB
    from repro_torch.kernels.card_checks import matmul_error
    from repro_torch.kernels.matmul_fwd.ops import matmul_fwd
    from repro_torch.kernels.stencil2d.ops import stencil2d

    counters = _counters()

    def zero():
        for c in counters.values():
            c.launches = 0
        torch.cuda.synchronize()

    zero()
    t0 = time.perf_counter()
    rows = RB.run(reps=20)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    got = {n: c.launches for n, c in counters.items()}
    print(f"[rodinia] full shapes (N={RB.N}, MAT={RB.MAT}, GRID={RB.GRID}, bp={RB.BP}) on "
          f"the card, eager, 20 reps each: nine parity asserts passed in {dt:.2f}s")
    for line in RB.report(rows):
        print(f"[rodinia] {line}")
    print(f"[rodinia] geomean_wallclock_speedup,"
          f"{RB.geomean([r['speedup_wallclock'] for r in rows]):.2f}")
    print(f"[rodinia] launches during the suite: {got}; derived: all 0")
    if any(got.values()) or [r["device"] for r in rows] != ["cuda"] * 9:
        raise SystemExit(f"rodinia: launch counts {got} != 0 or a case left the card")

    inp = RB.make_inputs()
    with torch.inference_mode():
        zero()
        c = matmul_fwd(inp["a_m"], inp["b_m"])
        hot = stencil2d(inp["grid"], torch.tensor(RB.HOTSPOT, device="cuda"))
        srad = stencil2d(inp["grid"], torch.tensor(RB.SRAD, device="cuda"))
        torch.cuda.synchronize()
        got = {n: cn.launches for n, cn in counters.items()}
        want = {**dict.fromkeys(counters, 0), "matmul_fwd_cuda": 1, "stencil2d_cuda": 2}
        print(f"[rodinia] launches of the ops on the suite's inputs: "
              f"{ {n: got[n] for n in PAPER_KERNELS} }; derived "
              f"{ {n: want[n] for n in PAPER_KERNELS} }")
        if got != want:
            raise SystemExit(f"paper ops: launch counts {got} != derived {want}")
        e, f32_tol, ratio = matmul_error(c, RB.matmul_direct(inp["a_m"], inp["b_m"]))
        print(f"[rodinia] matmul_fwd on the matrixMul inputs vs matmul_direct: "
              f"max_abs_err={e:.3e} (tol {f32_tol:.3e}) {'ok' if ratio <= 1.0 else 'FAIL'}")
        if ratio > 1.0:
            raise SystemExit("matmul_fwd disagrees with the suite's matmul_direct")
        for name, out, direct in (("hotspot", hot, RB.hotspot_direct(inp["grid"])),
                                  ("srad", srad, RB.srad_direct(inp["grid"]))):
            err = float((out - direct).abs().max())
            tol = 1e-6 * float(direct.abs().max())
            print(f"[rodinia] stencil2d on the {name} grid vs {name}_direct: "
                  f"max_abs_err={err:.3e} (tol {tol:.3e}), bit-identical: "
                  f"{torch.equal(out, direct)} {'ok' if err <= tol else 'FAIL'}")
            if err > tol:
                raise SystemExit(f"stencil2d disagrees with the suite's {name}_direct")
    return {n: got[n] for n in PAPER_KERNELS}


def _time_paper_kernels(torch, launches, worst):
    """Phase 4 rows of the paper-demo kernels: the suite's shapes (the row of
    the result line) and the large ones (under the row's ``large`` key).
    ``library_ms``: ``torch.matmul`` on the same operands (f32 with TF32
    off), and for the stencil ``F.conv2d`` with the 3x3 cross weights and
    ``padding=1`` (boundary 0, cuDNN TF32 off, ``cudnn.benchmark`` on so
    that cuDNN times its algorithms and keeps the fastest), checked against
    the kernel before it is timed (that first call is the one that picks the
    algorithm)."""
    from repro_torch.benchmarks.rodinia import HOTSPOT

    F = torch.nn.functional
    MM, ST = _paper_modules()
    f32, bf = torch.float32, torch.bfloat16
    sources = {"matmul_fwd_cuda": "src/repro_torch/kernels/matmul_fwd/csrc/matmul_fwd.cu",
               "stencil2d_cuda": "src/repro_torch/kernels/stencil2d/csrc/stencil2d.cu"}
    replaces = {"matmul_fwd_cuda": "src/repro/kernels/matmul_fwd/kernel.py:50 (matmul_fwd_pallas)",
                "stencil2d_cuda": "src/repro/kernels/stencil2d/kernel.py:55 (stencil2d_pallas)"}
    measured = []

    def measure(name, shape, sets, kern, plain, library, nbytes, flops, peak, reps):
        ms, call_ms = _time_ms(torch, kern, sets, reps=reps)
        plain_ms, _ = _time_ms(torch, plain, sets, reps=max(3, reps // 4))
        lib_ms = _time_ms(torch, library, sets, reps=reps)[0]
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        f_ms = flops / peak * 1e3
        r = {"name": name, "route": "cuda", "source": sources[name], "replaces": replaces[name],
             "launches": launches[name], "max_abs_err": worst[name], "ms": ms,
             "plain_ms": plain_ms, "bound_ms": max(b_ms, f_ms),
             "bound_by": "bytes" if b_ms >= f_ms else "operations", "library_ms": lib_ms,
             "call_ms": call_ms, "shape": shape}
        measured.append(r)
        print(f"[time] {name:28s} {shape:40s} device {ms * 1e3:9.2f} us, per call "
              f"{call_ms * 1e3:9.2f} us (plain {plain_ms * 1e3:10.1f} us, bound "
              f"{r['bound_ms'] * 1e3:.2f} us by {r['bound_by']}, library "
              f"{lib_ms * 1e3:.2f} us; {nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP)")

    with torch.inference_mode():
        torch.backends.cudnn.benchmark = True
        for h, w in ((256, 512), (8192, 8192)):
            nbytes = 2 * h * w * 4 + 5 * 4
            sets = _cold_sets(lambda s: _stencil_inputs(torch, h, w, f32, s, HOTSPOT), nbytes)
            weight = torch.tensor([[0.0, HOTSPOT[1], 0.0],
                                   [HOTSPOT[3], HOTSPOT[0], HOTSPOT[4]],
                                   [0.0, HOTSPOT[2], 0.0]], device="cuda")[None, None]

            def conv2d(x, c):
                return F.conv2d(x[None, None], weight, padding=1)

            x, c = sets[0]
            lib_err = float((conv2d(x, c)[0, 0] - ST.stencil2d_cuda(x, c)).abs().max())
            print(f"[time] conv2d library call agrees with stencil2d_cuda at {h}x{w}: "
                  f"max_abs_err={lib_err:.3e}")
            if lib_err > 1e-5 * float(x.abs().max()):
                raise SystemExit("the conv2d library call disagrees with stencil2d_cuda")
            measure("stencil2d_cuda", f"{h}x{w} f32 hotspot", sets,
                    lambda x, c: ST.stencil2d_cuda(x, c),
                    lambda x, c: ST.stencil2d_ref(x, c), conv2d, nbytes, 9 * h * w,
                    PEAK_F32_FLOPS, reps=100 if h < 8192 else 20)
        torch.backends.cudnn.benchmark = False
        for dim, dtype, peak in ((256, f32, PEAK_F32_FLOPS), (4096, bf, PEAK_BF16_FLOPS),
                                 (4096, f32, PEAK_F32_FLOPS)):
            item = 4 if dtype == f32 else 2
            nbytes = 3 * dim * dim * item
            sets = _cold_sets(lambda s: _matmul_inputs(torch, dim, dim, dim, dtype, s), nbytes)
            measure("matmul_fwd_cuda", f"{dim}^3 {'f32' if dtype == f32 else 'bf16'}", sets,
                    lambda a, b: MM.matmul_fwd_cuda(a, b), MM.matmul_ref, torch.matmul,
                    nbytes, 2 * dim ** 3, peak, reps=100 if dim < 4096 else 10)
    # One row per kernel in the result line, at the suite's shape; the large
    # shapes ride along under "large".
    rows = []
    for name in ("stencil2d_cuda", "matmul_fwd_cuda"):
        mine = [r for r in measured if r["name"] == name]
        rows.append({**mine[0], "large": [
            {k: r[k] for k in ("shape", "ms", "call_ms", "plain_ms", "bound_ms", "bound_by",
                               "library_ms")} for r in mine[1:]]})
    return rows


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
