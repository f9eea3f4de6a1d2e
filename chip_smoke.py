#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero, with no result line):

1. build: compile every CUDA source of the port with nvcc, in parallel;
   for the two libraries redesigned around wgmma and TMA (matmul, flash
   attention) count the HGMMA and UTMALDG instructions in their SASS
   (``cuobjdump --dump-sass``) beside each wgmma kernel's registers, stack
   frame and local memory (``cuobjdump --dump-resource-usage``), and for
   the two WKV libraries redesigned around TMA rings (the chunked forward,
   the backward) the UTMALDG and UTMASTG instructions, for the decode
   window the UBLKCP (1-D bulk copy) instructions and for the elevator
   scan library (the RG-LRU scan's TMA ring, the staged window) the
   UTMALDG instructions, beside each kernel's registers, shared memory,
   stack frame and local memory (the token shift's too, and every kernel
   of the scan library), all read from the library file whether this run built it
   or found it in ``build/``; fail if a count is 0 or a kernel spills (a
   stack frame or local memory);
2. kernels against their plain PyTorch versions on the card, at full
   RWKV6 widths (H=32, Dh=64), in f32 with TF32 off and in bf16: the
   chunked kernel (B=4, T=256, chunk 16, and T=100 -> chunk 10), the
   decode step (B=4) and the decode window (K in 1, 8, 37, 64 at B=4 and
   B=1), the window bit for bit against K chained single steps and every
   column tile of the decode plan bit for bit against the planner's;
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
   B=1, T=4096, D=2560; bit for bit against its plain version in every
   plan, and against four chained 64-token windows), its decode window (K
   in 1, 8, 37, 64 at B=4 and B=1, bit for bit against K chained single
   launches and across every plan), the token shift (T in 4, 67, 259,
   4096; bit for bit against its plain version) and flash attention at Hq 10, Hkv 1, D 256 (causal window 2048 at
   T=4096, causal full at T=1024 and T=4096, a non-causal window, the
   decode offsets T=8 and T=1 against S=300, T not a block multiple), at
   D 128, 64, 32 (T=1000, window 256), and at Gemma3's Hq 4 (T=4096, causal
   window 1024 and causal with no window);
3e. the RecurrentGemma path, the RWKV6 engines and train state freed:
   full-size recurrentgemma-2b in bf16 (random weights from a seed, depth
   not cut) through ``ServeEngine.generate`` (B=4, 256-token prompts, 32
   new tokens, K=8), ``ServeEngine.serve`` (6 ragged requests, 4 slots,
   K=8) and prompt scoring (``make_prefill_step``, the cache-free
   ``forward``) at B=1, T=4096, every kernel's launch count set to 0 just
   before each call and held just after to the count the code's structure
   gives; then the reduced f32 model on the card against the CPU, and one
   generate call and one forward under the profiler;
3h. the Gemma3 path: full-size gemma3-1b in bf16 (random weights from a
   seed, depth not cut: 22 local layers of window 1024, 4 global) through
   ``ServeEngine.generate`` (B=4, 256-token prompts, 32 new tokens, K=8),
   ``ServeEngine.serve`` (6 ragged requests, 4 slots, K=8) and prompt
   scoring at B=1, T=4096, every launch count set to 0 just before each
   call and held just after: 0 for generate and serve (serving attends in
   plain PyTorch), 26 ``flash_attention_cuda`` for the forward, 22 of them
   windowed and 4 causal with no window; then the reduced f32 model on the
   card against the CPU, and one generate call and one forward under the
   profiler;
3i. fault isolation on the card: full-size rwkv6-1.6b serves phase 3's
   requests fault-free, then under a pinned NaN, a dropped dispatch, a hang
   fenced off by the watchdog and a preemption resumed from its snapshot:
   every request but the victim bit-identical to the fault-free run, the
   fault counts exact, the victim's shared prefix printed; full-size
   gemma3-1b under one NaN K row, neighbours bit-identical; the reduced f32
   rwkv6, gemma3 and recurrentgemma under one NaN, every stream (the
   victim's too) bit-identical to the fault-free run;
3f. the paper demo: the 5-point stencil against its plain version in f32
   (bit for bit) and bf16 (hotspot and SRAD coefficients on the suite's
   256 x 512 grid, boundary 5.0 at 64 x 128, the odd 257 x 383, and 8192 x
   8192) and the operand-forwarding matmul (the suite's 256^3, the
   reference test's (512, 256) x (256, 384) with blocks (256, 128, 128),
   4096^3, and the shapes that reach the planner's other branches:
   (1024, 256, 1024), (2048, 512, 2048), (33, 65, 17)); then the Rodinia
   suite at its full shapes (all nine parity asserts, its CSV and geomean
   lines), with every launch count set to 0 before and held at 0 after
   (its cases call neither kernel), and the two ops on the suite's inputs: ``matmul_fwd`` on the matrixMul operands
   against ``matmul_direct`` and ``stencil2d`` on the hotspot and SRAD grid
   against ``hotspot_direct`` and ``srad_direct``, counts held at 1 and 2;
4. each kernel's median time at its main path's shapes beside its plain
   version's time, its bound and, where one PyTorch call computes the same
   function, that call's time (the paper-demo kernels also at 8192^2, the
   matmul at 256^3 bf16 and 4096^3; flash attention also causal with no
   window at T=4096 against SDPA with ``is_causal=True``, whose backend is
   printed, and at Gemma3's two shapes (Hq 4, T=4096: window 1024 beside
   SDPA with the same mask and GQA, causal beside SDPA ``is_causal`` on K/V
   repeated to 4 heads) with their launches a forward; the WKV rows with
   their time per chunk, every column tile of the chunked forward and every
   cluster size of the backward at the training shape and at a seq shard,
   and a backward row at the seq gradient's shard; the decode rows with
   every column tile, the window at K in 1, 8, 32, 64 and B in 1, 4 with
   every column tile, and an empty kernel's time as the launch floor; the
   token shift at (B, T) = (1, 4096), (4, 4) and (4, 259); the elevator
   scan at (B, T) = (1, 4096) and (4, 256) in every plan; the elevator
   window at K in 1, 8, 32, 64 and B in 1, 4 in every plan, beside the
   launch floor plus its bytes bound), printed as one ``{"kernels":
   [...]}`` line;
   then the card's name and power limit, and the result line.
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
#: Flash attention in f32 is held to TOLERANCE; in bf16 to
#: ``card_checks.attn_bf16_ratio`` (per element, see there).
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
    _hopper_report(common)

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
            for b in (4, 1):
                for kw in (1, 8, 37, 64):
                    a = _inputs(torch, b, kw, dtype, seed=3 + kw + b)
                    got = D.wkv_decode_window_cuda(*a)
                    torch.cuda.synchronize()
                    check("wkv_decode_window_cuda", f"B={b} K={kw}", dtype, got,
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
                    plans = {c: D.launch_plan(*a, col_tile=c) for c in D.DECODE_TILES}
                    equal = all(torch.equal(p[0], got[0]) and torch.equal(p[1], got[1])
                                for p in plans.values())
                    print(f"[kernels] window B={b} K={kw} {dtype} bit-identical to "
                          f"{kw} chained single steps: {same}; every column tile "
                          f"{list(plans)} bit-equal: {equal}")
                    if not same:
                        raise SystemExit("decode window differs from chained single steps")
                    if not equal:
                        raise SystemExit("decode plans differ")

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

    # ---- 3h. the Gemma3 path ------------------------------------------------
    g3_launches, g3_split, g3_params = _g3_main_path(torch, np)
    launches["flash_attention_cuda"] += g3_launches["flash_attention_cuda"]
    _g3_reference_check(torch, np)

    # ---- 3i. fault isolation on the card ------------------------------------
    for name, n in _fault_isolation(torch, np, g3_params).items():
        launches[name] = launches.get(name, 0) + n
    del g3_params
    torch.cuda.empty_cache()

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
            f_ms = flops / PEAK_F32_FLOPS * 1e3     # f32 arithmetic on the CUDA cores
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
            if counter is KC.wkv_cuda:
                rows[-1]["chunk_us"] = ms * 1e3 / (t // chunk)
                rows[-1]["plans"] = _time_fwd_plans(torch, KC, sets, chunk)
            else:
                rows[-1]["plans"] = _time_decode_plans(torch, D, sets)
            print(f"[time] {counter.__name__:24s} {rows[-1]['shape']:32s} "
                  f"device {ms * 1e3:8.2f} us, per call {call_ms * 1e3:8.2f} us "
                  f"(plain {plain_ms * 1e3:9.1f} us, bound "
                  f"{rows[-1]['bound_ms'] * 1e3:.2f} us by {rows[-1]['bound_by']})"
                  + (f"; {rows[-1]['chunk_us']:.2f} us a chunk" if counter is KC.wkv_cuda
                     else "") + f"; every column tile {rows[-1]['plans']}")
        # What one launch costs the card: an empty kernel timed the same way.
        floor_ms, floor_call_ms = _time_ms(torch, lambda: torch.cuda._sleep(0), [()] * 4, 200)
        print(f"[time] launch floor (torch.cuda._sleep(0)): device {floor_ms * 1e3:.2f} us, "
              f"per call {floor_call_ms * 1e3:.2f} us")
        # The window at the admission buckets and at one token, B=1 and B=4.
        rows[2]["sweep"] = _time_decode_sweep(torch, D)
        for row in rows[1:3]:
            row["launch_floor_ms"] = floor_ms
    rows += _time_train_kernels(torch, KC, BW, launches, worst)
    rows += _time_seq_kernels(torch, KC, BW, launches, worst, seq_extra)
    rows += _time_rg_kernels(torch, launches, worst, floor_ms, g3_split)
    rows += _time_paper_kernels(torch, launches, worst)

    print(json.dumps({"kernels": rows}))
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev_name, "count": torch.cuda.device_count()}}))


def _resource_usage(text):
    """``cuobjdump --dump-resource-usage``'s output -> {function symbol:
    {"REG": registers, "STACK": stack frame bytes, "SHARED": static shared
    bytes, "LOCAL": local memory bytes, ...}}."""
    import re

    out, name = {}, None
    for ln in text.splitlines():
        m = re.match(r"\s*Function (\S+?):?$", ln)
        if m:
            name = m.group(1)
            continue
        if name is not None and "REG:" in ln:
            out[name] = {k: int(v) for k, v in re.findall(r"([A-Z]+(?:\[\d+\])?):(\d+)", ln)}
            name = None
    return out


def _hopper_report(common):
    """The redesigned libraries as built: the count of HGMMA (wgmma),
    UTMALDG (TMA load), UTMASTG (TMA store) and UBLKCP (1-D bulk copy)
    instructions from ``cuobjdump --dump-sass``, and the registers, static
    shared memory, stack frame and local memory of each redesigned kernel
    from ``cuobjdump --dump-resource-usage``.  Both read the library file, so
    a library built by an earlier run reads the same.  Fails if a library
    lacks its instructions (HGMMA and UTMALDG for the matmul and flash
    attention, UTMALDG for the WKV pair and the elevator scan, UBLKCP for
    the decode window), no
    such kernel is found, or one has a stack frame or local memory (where
    spills go)."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"

    def dump(flag, path):
        return subprocess.run([tool, flag, str(path)], capture_output=True, text=True,
                              check=True, timeout=300).stdout

    for name, marker, need in (*((n, "wgmma_kernel", ("HGMMA", "UTMALDG")) for n in HOPPER_LIBRARIES),
                               *((n, k, ("UTMALDG",)) for n, k in WKV_TMA_LIBRARIES.items()),
                               *((n, k, ops) for n, (k, ops) in DECODE_LIBRARIES.items()),
                               *((n, k, ops) for n, (k, ops) in SCAN_LIBRARIES.items())):
        path = common._lib_path(name)
        sass = dump("--dump-sass", path)
        counts = {op: sum(op in ln for ln in sass.splitlines())
                  for op in ("HGMMA", "UTMALDG", "UTMASTG", "UBLKCP")}
        kernels = {k: v for k, v in _resource_usage(dump("--dump-resource-usage", path)).items()
                   if marker in k}
        print(f"[build] {name}: SASS HGMMA {counts['HGMMA']}, UTMALDG {counts['UTMALDG']}, "
              f"UTMASTG {counts['UTMASTG']}, UBLKCP {counts['UBLKCP']}")
        if len(kernels) > 10:
            # The token shift's 84 instantiations (tap count, rows, vector
            # or scalar slots, dtype) and the scan library's, summarised.
            regs = [use.get("REG", 0) for use in kernels.values()]
            print(f"[build]   {len(kernels)} {marker}s: {min(regs)}-{max(regs)} registers "
                  f"at launch, stack {max(u.get('STACK', 0) for u in kernels.values())} B, "
                  f"local {max(u.get('LOCAL', 0) for u in kernels.values())} B at most")
        for k, use in sorted(kernels.items()) if len(kernels) <= 10 else ():
            short = k.split(marker)[-1][:14]
            print(f"[build]   {marker} {short}: {use.get('REG')} registers at launch, "
                  f"{use.get('SHARED')} bytes static smem, stack {use.get('STACK')} B, "
                  f"local {use.get('LOCAL')} B")
        if min((counts[op] for op in need), default=1) < 1 or not kernels:
            raise SystemExit(f"{name}: no {marker.split('_')[0]} kernel or no {need} in the "
                             f"binary: {counts}, {len(kernels)} {marker}s")
        spills = [k for k, use in kernels.items() if use.get("STACK", 0) or use.get("LOCAL", 0)]
        if spills:
            raise SystemExit(f"{name}: a {marker} spills (stack frame or local memory): "
                             f"{spills}")


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
            f_ms = flops / PEAK_F32_FLOPS * 1e3     # f32 arithmetic on the CUDA cores
            rows.append({
                "name": counter.__name__, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[counter.__name__],
                "max_abs_err": worst[counter.__name__],
                "ms": ms, "plain_ms": plain_ms, "bound_ms": max(b_ms, f_ms),
                "bound_by": "bytes" if b_ms >= f_ms else "operations",
                "library_ms": None, "call_ms": call_ms,
                "shape": f"B={b} H=32 T={t} Dh=64 bf16 chunk={chunk}",
                "chunk_us": ms * 1e3 / n,
                "plans": (_time_fwd_plans(torch, KC, sets, chunk, hist=True)
                          if counter is KC.wkv_train_cuda
                          else _time_bwd_plans(torch, BW, sets, chunk)),
            })
            print(f"[time] {counter.__name__:24s} {rows[-1]['shape']:32s} "
                  f"device {ms * 1e3:8.2f} us, per call {call_ms * 1e3:8.2f} us "
                  f"(plain {plain_ms * 1e3:9.1f} us, bound "
                  f"{rows[-1]['bound_ms'] * 1e3:.2f} us by {rows[-1]['bound_by']}; "
                  f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP); "
                  f"{rows[-1]['chunk_us']:.2f} us a chunk; every plan {rows[-1]['plans']}")
    return rows


def _time_fwd_plans(torch, KC, sets, chunk, hist=False, summary=False):
    """Device µs of the chunked forward with every column tile that fits,
    through ``launch_plan`` (counts no launch), on the row's input sets."""
    item = sets[0][0].element_size()
    return {f"cols={c}": round(1e3 * _time_ms(torch, lambda *a, c=c: KC.launch_plan(
                *a, chunk=chunk, col_tile=c, hist=hist, summary=summary), sets, reps=20)[0], 2)
            for c in KC.COL_TILES if KC.fwd_smem_bytes(chunk, c, item) <= KC.SMEM_LIMIT}


def _time_decode_plans(torch, D, sets):
    """Device µs of the decode window with every column tile, through
    ``launch_plan`` (counts no launch), on the row's input sets."""
    return {f"cols={c}": round(1e3 * _time_ms(torch, lambda *a, c=c: D.launch_plan(
                *a, col_tile=c), sets, reps=20)[0], 2) for c in D.DECODE_TILES}


def _time_decode_sweep(torch, D):
    """Phase 4: the decode window in bf16 at K in (1, 8, 32, 64) tokens and
    B in (1, 4): device and per-call µs of the planner's choice, every
    column tile, and the bound (its bytes: the inputs, out and the state
    read and written; its operations over the f32 peak)."""
    from repro_torch.kernels.common import sm_count

    out = []
    for b in (1, 4):
        for kw in (1, 8, 32, 64):
            one = _inputs(torch, b, kw, torch.bfloat16, seed=0)
            nbytes = _nbytes(one) + _nbytes(one[:1]) + b * H * DH * DH * 4
            sets = _cold_sets(lambda s: _inputs(torch, b, kw, torch.bfloat16, s), nbytes)
            ms, call_ms = _time_ms(torch, D.wkv_decode_window_cuda, sets, reps=100)
            b_ms = nbytes / HBM_BYTES_PER_S * 1e3
            f_ms = _flops(b, kw, kw, windowed=True) / PEAK_F32_FLOPS * 1e3
            plan = D.plan_decode_columns(b, H, kw, torch.bfloat16, sm_count(one[0].device))
            row = {"shape": f"B={b} K={kw}", "ms": ms, "call_ms": call_ms,
                   "bound_ms": max(b_ms, f_ms), "token_us": ms * 1e3 / kw,
                   "plan": f"cols={plan}", "plans": _time_decode_plans(torch, D, sets)}
            out.append(row)
            print(f"[time] decode window B={b} K={kw:2d} bf16: device {ms * 1e3:7.2f} us "
                  f"({row['token_us']:.3f} us a token), per call {call_ms * 1e3:7.2f} us, "
                  f"bound {row['bound_ms'] * 1e3:.2f} us; plan cols={plan}, every column "
                  f"tile {row['plans']}")
    return out


def _time_bwd_plans(torch, BW, sets, chunk):
    """Device µs of the backward with every cluster size that fits, through
    ``launch_plan`` (counts no launch), on the row's input sets."""
    from repro_torch.kernels.wkv.kernel import SMEM_LIMIT

    item = sets[0][0].element_size()
    return {f"cluster={c}": round(1e3 * _time_ms(torch, lambda *a, c=c: BW.launch_plan(
                *a, chunk=chunk, cluster=c), sets, reps=20)[0], 2)
            for c in BW.CLUSTERS if BW.bwd_smem_bytes(chunk, c, item) <= SMEM_LIMIT}


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
        logits, dt_seq, got = _counted(torch, counters, lambda: seq_step(params, tokens))
        hold(f"seq prefill B=1 T={prompt}", got, {"wkv_summary_cuda": n_l * n_s})
        total["wkv_summary_cuda"] += got["wkv_summary_cuda"]
        want, dt_plain, got = _counted(torch, counters, lambda: plain_step(params, tokens))
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
    out_seq, dt_seq, got = _counted(torch, counters, lambda: eng_seq.generate(prompts, new))
    hold(f"generate on the seq mesh B={gen_b} P={gen_p} +{new} K={k_w}", got,
         {"wkv_summary_cuda": n_l * n_s, "wkv_decode_cuda": n_l * steps})
    total["wkv_summary_cuda"] += got["wkv_summary_cuda"]
    out_plain, dt_plain, got = _counted(torch, counters, lambda: eng.generate(prompts, new))
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
    (l_seq, g_seq), dt_seq, got = _counted(torch, counters, lambda: grads(True))
    hold(f"loss gradient on the seq mesh B=1 T={grad_t} (remat {cfg.remat})", got,
         {"wkv_train_summary_cuda": remat_runs * n_l * n_s, "wkv_bwd_cuda": n_l * n_s})
    total["wkv_train_summary_cuda"] += got["wkv_train_summary_cuda"]
    extra["bwd_launches"] = got["wkv_bwd_cuda"]
    (l_plain, g_plain), dt_plain, got = _counted(torch, counters, lambda: grads(False))
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


def _time_seq_kernels(torch, KC, BW, launches, worst, extra, t_full=4096, grad_t=2048,
                      chunk=16):
    """Phase 4 rows of the summary kernels at a shard of the main path: one
    quarter (the window 2048..3072) of a 4096-token prompt at B=1 for the
    inference sweep, one quarter of the gradient's 2048 tokens for the
    training sweep (and a 1024-token shard beside it), read in place, zero
    h0, bf16; the backward at the gradient's shard (the same windows, the
    training summary's s_hist, random cotangents).  Then the n=4 shard
    launches of one layer back to back against one ``wkv_cuda`` sweep over
    the whole 4096 tokens, and the prefill, generate and gradient wall
    times of phase 3g."""
    from repro_torch.kernels.common import sm_count

    bf = torch.bfloat16
    rows = []

    def full(seed, n=t_full):
        """An n-token prompt's r/k/v/w/u and a zero h0, as the shards get."""
        a = _inputs(torch, 1, n, bf, seed)
        return a[:5] + [torch.zeros_like(a[5])]

    def window(seed, t, n):
        a, s0 = full(seed, n), (seed % (n // t)) * t
        return [x[:, :, s0:s0 + t] for x in a[:4]] + a[4:]

    def row(name, kern, plain, t, n, hist, source_note, plans=False):
        """The row of a shard of t tokens of an n-token prompt: cold input
        sets are windows of distinct prompts."""
        nbytes = (5 * H * t * DH * 2 + H * DH * 2 + 2 * H * DH * DH * 4 + H * DH * 4
                  + (H * (t // chunk) * DH * DH * 4 if hist else 0))
        sets = _cold_sets(lambda seed: window(seed, t, n), n * H * DH * 2 * 4)
        ms, call_ms = _time_ms(torch, lambda *a: kern(*a, chunk=chunk), sets, reps=50)
        plain_ms, _ = _time_ms(torch, lambda *a: plain(*a, chunk=chunk), sets, reps=3)
        flops = _flops(1, t, chunk, windowed=False)
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        f_ms = flops / PEAK_F32_FLOPS * 1e3      # f32 arithmetic on the CUDA cores
        r = {"name": name, "route": "cuda",
             "source": "src/repro_torch/kernels/wkv/csrc/wkv_chunked.cu",
             "replaces": source_note, "launches": launches[name],
             "max_abs_err": worst[name], "ms": ms, "plain_ms": plain_ms,
             "bound_ms": max(b_ms, f_ms), "bound_by": "bytes" if b_ms >= f_ms else "operations",
             "library_ms": None, "call_ms": call_ms,
             "shape": f"B=1 H=32 T={t} (a window of {n}) Dh=64 bf16 chunk={chunk}",
             "chunk_us": ms * 1e3 / (t // chunk)}
        if plans:
            r["plans"] = _time_fwd_plans(torch, KC, sets, chunk, hist=hist, summary=True)
        print(f"[time] {name:24s} {r['shape']:50s} device {ms * 1e3:8.2f} us, per call "
              f"{call_ms * 1e3:8.2f} us (plain {plain_ms * 1e3:9.1f} us, bound "
              f"{r['bound_ms'] * 1e3:.2f} us by {r['bound_by']}; {nbytes / 1e6:.1f} MB, "
              f"{flops / 1e9:.2f} GFLOP); {r['chunk_us']:.2f} us a chunk"
              + (f"; every column tile {r['plans']}" if plans else ""))
        return r

    def bwd_row(t, n):
        """The backward at the seq gradient's shard: windows of distinct
        prompts read in place, the training summary's s_hist of each."""
        def bwd_set(seed):
            a = window(seed, t, n)
            hist = KC.wkv_train_summary_cuda(*a, chunk=chunk)[2]
            return (*a[:5], hist, *_cotangents(torch, 1, t, bf, seed))

        nc = t // chunk
        nbytes = (5 * H * t * DH * 2 + H * DH * 2 + H * nc * DH * DH * 4 + H * DH * DH * 4
                  + 4 * H * t * DH * 2 + H * DH * 4 + H * DH * DH * 4)
        sets = _cold_sets(bwd_set, nbytes)
        ms, call_ms = _time_ms(torch, lambda *a: BW.wkv_bwd_cuda(*a, chunk=chunk), sets, reps=30)
        plain_ms, _ = _time_ms(torch, lambda *a: BW.wkv_bwd_plain(*a, chunk=chunk), sets, reps=2)
        flops = _bwd_flops(1, t, chunk)
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        f_ms = flops / PEAK_F32_FLOPS * 1e3
        r = {"name": "wkv_bwd_cuda", "route": "cuda",
             "source": "src/repro_torch/kernels/wkv/csrc/wkv_bwd.cu",
             "replaces": "src/repro/kernels/wkv/bwd.py:164 (wkv_pallas_bwd)",
             "launches": extra["bwd_launches"], "max_abs_err": worst["wkv_bwd_cuda"],
             "ms": ms, "plain_ms": plain_ms, "bound_ms": max(b_ms, f_ms),
             "bound_by": "bytes" if b_ms >= f_ms else "operations", "library_ms": None,
             "call_ms": call_ms, "chunk_us": ms * 1e3 / nc,
             "shape": f"B=1 H=32 T={t} (a window of {n}) Dh=64 bf16 chunk={chunk}: a shard "
                      "of the seq gradient",
             "plans": _time_bwd_plans(torch, BW, sets, chunk)}
        print(f"[time] {'wkv_bwd_cuda':24s} {r['shape']:50s} device {ms * 1e3:8.2f} us, per "
              f"call {call_ms * 1e3:8.2f} us (plain {plain_ms * 1e3:9.1f} us, bound "
              f"{r['bound_ms'] * 1e3:.2f} us by {r['bound_by']}; {nbytes / 1e6:.1f} MB, "
              f"{flops / 1e9:.2f} GFLOP); {r['chunk_us']:.2f} us a chunk; every cluster size "
              f"{r['plans']}")
        return r

    with torch.inference_mode():
        rows.append(row("wkv_summary_cuda", KC.wkv_summary_cuda, KC.wkv_summary_plain,
                        t_full // SEQ_SHARDS, t_full, False,
                        "src/repro/kernels/wkv/kernel.py:262 (wkv_pallas_summary)", plans=True))
        grad_shard = row("wkv_train_summary_cuda", KC.wkv_train_summary_cuda,
                         KC.wkv_train_summary_plain, grad_t // SEQ_SHARDS, grad_t, True,
                         "src/repro/kernels/wkv/kernel.py:289 (wkv_pallas_train_summary)")
        long_shard = row("wkv_train_summary_cuda", KC.wkv_train_summary_cuda,
                         KC.wkv_train_summary_plain, t_full // SEQ_SHARDS, t_full, True,
                         "src/repro/kernels/wkv/kernel.py:289 (wkv_pallas_train_summary)")
        rows.append({**grad_shard, "large": [
            {k: long_shard[k] for k in ("shape", "ms", "call_ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms", "chunk_us")}]})
        rows.append(bwd_row(grad_t // SEQ_SHARDS, grad_t))

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
    sms = sm_count(torch.device("cuda"))
    blocks = H * (DH // KC.plan_columns(1, H, q, chunk, bf, sms))
    print(f"[time] one layer of the seq prefill B=1 T={t_full}: {SEQ_SHARDS} summary launches "
          f"(each {blocks} blocks on {sms} SMs) back to back {ms_shards * 1e3:.2f} us against "
          f"one wkv_cuda sweep {ms_one * 1e3:.2f} us ({ms_shards / ms_one:.2f}x)")
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
G3_HQ, G3_WINDOW = 4, 1024       # gemma3-1b: 4 query heads over 1 KV head of 256
#: The libraries redesigned around wgmma and TMA (phase 1 counts their
#: HGMMA and UTMALDG instructions).
HOPPER_LIBRARIES = ("matmul_fwd", "flash_attention")
#: The WKV libraries redesigned around TMA rings (phase 1 counts their
#: UTMALDG and UTMASTG instructions), with their kernels' name.
WKV_TMA_LIBRARIES = {"wkv_chunked": "wkv_fwd_kernel", "wkv_bwd": "wkv_bwd_kernel"}
#: The decode-step libraries redesigned after them, with their kernels' name
#: and the instructions phase 1 must find: the decode window stages its
#: inputs by 1-D bulk copies (UBLKCP); the token shift has no such
#: instruction, only its registers and spills are read.
DECODE_LIBRARIES = {"wkv_decode": ("wkv_decode_kernel", ("UBLKCP",)),
                    "token_shift": ("token_shift_kernel", ())}
#: The RG-LRU scan library redesigned after them: every kernel of it (the
#: marker matches the scan's and the window's), and the TMA loads (UTMALDG)
#: of the scan's ring and the staged window phase 1 must find.
SCAN_LIBRARIES = {"elevator_scan": ("elevator_", ("UTMALDG",))}
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


def _attn_inputs(torch, b, t, s, dtype, seed, d=RG_DH, hq=RG_HQ):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, hq, t, d), generator=g, device="cuda")
    k = torch.randn((b, RG_HKV, s, d), generator=g, device="cuda")
    v = torch.randn((b, RG_HKV, s, d), generator=g, device="cuda")
    return q.to(dtype), k.to(dtype), v.to(dtype)


#: (T, S, causal, window, D) of the flash-attention checks.
ATTN_CASES = (
    (4096, 4096, True, RG_WINDOW, RG_DH),  # the local layers of a 4096-token forward
    (1024, 1024, True, None, RG_DH),       # causal, full
    (640, 640, False, 200, RG_DH),         # non-causal window
    (8, 300, True, None, RG_DH),           # decode offset
    (1000, 1000, True, 256, RG_DH),        # T not a block multiple
    (4096, 4096, True, None, RG_DH),       # causal, no window (gemma3's global layers)
    (1, 300, True, None, RG_DH),           # one valid row of a 128-row tile
    (1000, 1000, True, 256, 128),          # the other head widths
    (1000, 1000, True, 256, 64),
    (1000, 1000, True, 256, 32),
)
#: Gemma3's two flash shapes (Hq 4): its local layers' window and its
#: global layers' causal attention with no window, at a 4096-token forward.
G3_ATTN_CASES = (
    (4096, 4096, True, G3_WINDOW, RG_DH),
    (4096, 4096, True, None, RG_DH),
)


def _rg_kernel_checks(torch):
    """Phase 3d.  Returns the worst max abs error of each kernel."""
    from repro_torch.kernels import card_checks as CC

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
        r = CC.attn_bf16_ratio(got, want)
        e = float((got.float() - want.float()).abs().max())
        ok = r <= 1.0 and bool(torch.isfinite(got).all())
        print(f"[rg-kernels] {'flash_attention_cuda':28s} {case:30s} torch.bfloat16  "
              f"max_abs_err={e:.3e} worst err/tol per element={r:.3f} "
              f"(tol {CC.ATTN_BF16_ULP:.4g}*|plain| + {CC.ATTN_BF16_ROW:.4g}*rms(row)) "
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
                want = EK.elevator_scan_ref(a, x, h0)
                check("elevator_scan_cuda", f"B={b} T={t} D={RG_D}", dtype, [got], [want])
                # The serial chain runs the plain version's steps in its
                # order: bit for bit, in every plan.
                plans = EK.scan_plans(b, t, RG_D, dtype)
                bad = [p for p in plans
                       if not torch.equal(EK.launch_plan(a, x, h0, plan=p), want)]
                same = torch.equal(got, want) and not bad
                print(f"[rg-kernels] elevator scan B={b} T={t} {dtype} bit-identical to the "
                      f"plain version, the planner's plan and all {len(plans)} plans: {same}")
                if not same:
                    raise SystemExit(f"elevator scan differs from its plain version: {bad}")
            # The scan equals 64-token windows chained through their exit
            # states: one step function, one order.
            a, x, h0 = _scan_inputs(torch, 4, 256, dtype, seed=256)
            h, outs = h0, []
            for lo in range(0, 256, 64):
                o, h = ED.elevator_decode_window_cuda(a[:, lo:lo + 64].contiguous(),
                                                      x[:, lo:lo + 64].contiguous(), h)
                outs.append(o)
            same = torch.equal(torch.cat(outs, 1), EK.elevator_scan_cuda(a, x, h0))
            print(f"[rg-kernels] elevator scan B=4 T=256 {dtype} bit-identical to 4 chained "
                  f"64-token windows: {same}")
            if not same:
                raise SystemExit("elevator scan differs from chained windows")
            for b in (4, 1):
                for kw in (1, 8, 37, 64):
                    a, x, h0 = _scan_inputs(torch, b, kw, dtype, seed=100 + kw + b)
                    got = ED.elevator_decode_window_cuda(a, x, h0)
                    torch.cuda.synchronize()
                    check("elevator_decode_window_cuda", f"B={b} K={kw} D={RG_D}", dtype, got,
                          ED.elevator_decode_window_plain(a, x, h0))
                    h, outs = h0, []
                    for i in range(kw):
                        o, h = ED.elevator_decode_window_cuda(a[:, i:i + 1].contiguous(),
                                                              x[:, i:i + 1].contiguous(), h)
                        outs.append(o)
                    same = torch.equal(torch.cat(outs, 1), got[0]) and torch.equal(h, got[1])
                    plans = ED.window_plans(b, kw, RG_D, dtype)
                    bad = [p for p in plans if not all(
                        torch.equal(g, w) for g, w in zip(ED.launch_plan(a, x, h0, plan=p), got))]
                    print(f"[rg-kernels] elevator window B={b} K={kw} {dtype} bit-identical to "
                          f"{kw} chained single launches: {same}; all {len(plans)} plans "
                          f"bit-equal: {not bad}")
                    if not same or bad:
                        raise SystemExit(f"elevator window differs from chained single "
                                         f"launches or across plans: {bad}")
            for b, t in ((4, 4), (4, 67), (4, 259), (1, 4096)):
                x, w = _shift_inputs(torch, b, t, dtype, seed=t)
                got = TS.token_shift_cuda(x, w)
                torch.cuda.synchronize()
                want = TS.token_shift_ref(x, w)
                check("token_shift_cuda", f"B={b} T={t} D={RG_D}", dtype, [got], [want])
                same = torch.equal(got, want)
                print(f"[rg-kernels] token shift T={t} {dtype} bit-identical to the plain "
                      f"version: {same}")
                if not same:
                    raise SystemExit("token shift differs from its plain version")
            cases = [(RG_HQ,) + c for c in ATTN_CASES] + [(G3_HQ,) + c for c in G3_ATTN_CASES]
            for hq, t, s, causal, window, d in cases:
                q, k, v = _attn_inputs(torch, 1, t, s, dtype, seed=t + s, d=d, hq=hq)
                got = FA.flash_attention_cuda(q, k, v, causal=causal, window=window)
                torch.cuda.synchronize()
                case = f"T={t} S={s} {'causal' if causal else 'full'} W={window}" + (
                    f" D={d}" if d != RG_DH else "") + (f" Hq={hq}" if hq != RG_HQ else "")
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
    out, dt, got = _counted(torch, counters, lambda: engine.generate(prompts, new))
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
    results, dt, got = _counted(torch, counters, lambda: engine.serve(reqs, slots=4))
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
        logits, dt, got = _counted(torch, counters, lambda: scoring(params, tokens))
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


# ---------------------------------------------------------------------------
# Gemma3-1B (phase 3h) and fault-isolated serving (phase 3i).
# ---------------------------------------------------------------------------

def _counted(torch, counters, fn):
    """``fn()`` with every launch count set to 0 just before and read just
    after: (result, wall seconds, {kernel: launches})."""
    for c in counters.values():
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, {n: c.launches for n, c in counters.items()}


def _g3_requests(rng, vocab, n=6):
    """Phase 3's serve workload: after the (4, 256) generate prompts, n
    ragged requests of 8-48 prompt tokens and 2-16 new."""
    from repro_torch.serve.engine import Request

    rng.integers(0, vocab, (4, 256))
    return [Request(tokens=rng.integers(0, vocab, int(rng.integers(8, 49))),
                    max_new_tokens=int(rng.integers(2, 17))) for _ in range(n)]


def _g3_main_path(torch, np, batch=4, prompt=256, new=32, k_w=8, score_t=4096):
    """Phase 3h: full-size gemma3-1b (bf16, random weights from a seed,
    depth not cut) through generate, serve and prompt scoring, each call's
    launch counts held to the counts its structure gives: serving attends
    in plain PyTorch (no port kernel), the cache-free forward runs
    ``flash_attention_cuda`` once a layer, windowed in the local layers
    and causal with no window in the global ones.  The split is read at
    the call site (a pass-through recorder in ``ops``; the counts
    themselves are the wrapper's).  Returns (launches, the split per
    forward, params)."""
    from collections import Counter

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.local_attention import ops as FOPS
    from repro_torch.model import model as M
    from repro_torch.serve.engine import ServeEngine, make_prefill_step

    cfg = get_config("gemma3-1b")
    n_local, n_global = cfg.layer_kinds.count("local"), cfg.layer_kinds.count("global")
    counters = _counters()
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in _leaves(params))
    print(f"[g3] {cfg.name}: {n_params / 1e9:.3f}B params in {cfg.dtype} ({cfg.num_layers} "
          f"layers: {n_local} local W={cfg.attn_window}, {n_global} global), initialized in "
          f"{time.perf_counter() - t0:.1f}s")
    engine = ServeEngine(cfg, params, max_len=512, decode_window=k_w)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (batch, prompt))
    reqs = _g3_requests(np.random.default_rng(0), cfg.vocab_size)
    scoring = make_prefill_step(cfg)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, score_t))).cuda()
    with torch.inference_mode():                              # warm-up
        engine.generate(prompts[:, :80], 2)
        engine.serve(reqs[:1], slots=4)
        scoring(params, tokens[:, :256])

    def hold(what, got, want):
        want = {**dict.fromkeys(counters, 0), **want}
        print(f"[g3] launches during {what}: {got['flash_attention_cuda']} flash, "
              f"{sum(got.values())} in all; derived {sum(want.values())}")
        if got != want:
            raise SystemExit(f"{what}: launch counts {got} != derived {want}")

    out, dt, got = _counted(torch, counters, lambda: engine.generate(prompts, new))
    hold("generate", got, {})
    gen = out[:, prompt:].cpu().numpy()
    gen_ok = bool(M.decode_state_finite(engine.last_state).all())
    print(f"[g3-main] generate B={batch} P={prompt} +{new} K={k_w}: {dt:.3f}s, "
          f"{batch * new / dt:.1f} tok/s incl. prefill; state finite: {gen_ok}")
    if gen.shape != (batch, new) or gen.min() < 0 or gen.max() >= cfg.vocab_size or not gen_ok:
        raise SystemExit(f"g3 generate: bad tokens or state, shape {gen.shape}")

    results, dt, got = _counted(torch, counters, lambda: engine.serve(reqs, slots=4))
    hold("serve", got, {})
    emitted = sum(r.size for r in results)
    serve_ok = bool(M.decode_state_finite(engine.last_state).all())
    print(f"[g3-main] serve 6 requests, 4 slots, K={k_w}: {emitted} tokens in {dt:.3f}s, "
          f"{emitted / dt:.1f} tok/s; outcomes {[r.outcome for r in results]}; "
          f"state finite: {serve_ok}")
    for req, res in zip(reqs, results):
        if res.outcome != "ok" or res.size != req.max_new_tokens:
            raise SystemExit(f"g3 serve: {res.outcome} with {res.size} tokens")
        if res.tokens.min() < 0 or res.tokens.max() >= cfg.vocab_size:
            raise SystemExit("g3 serve: token outside the vocabulary")

    calls = Counter()
    real = FOPS.flash_attention_cuda

    def recording(q, k, v, **kw):
        calls[(kw.get("causal", True), kw.get("window"))] += 1
        return real(q, k, v, **kw)

    FOPS.flash_attention_cuda = recording
    try:
        with torch.inference_mode():
            logits, dt, got = _counted(torch, counters, lambda: scoring(params, tokens))
    finally:
        FOPS.flash_attention_cuda = real
    hold(f"forward B=1 T={score_t}", got, {"flash_attention_cuda": n_local + n_global})
    split = {"window": calls[(True, cfg.attn_window)], "causal": calls[(True, None)]}
    print(f"[g3] flash calls of the forward by (causal, window): {dict(calls)}")
    if split != {"window": n_local, "causal": n_global} or sum(calls.values()) != sum(
            split.values()):
        raise SystemExit(f"g3 forward: flash calls {dict(calls)}, want {n_local} windowed "
                         f"and {n_global} causal")
    fin = bool(torch.isfinite(logits[..., :cfg.vocab_size]).all())
    nll = float(torch.nn.functional.cross_entropy(
        logits[0, :-1, :cfg.vocab_size].float(), tokens[0, 1:]))
    print(f"[g3-main] forward (make_prefill_step) B=1 T={score_t}: {dt:.3f}s, "
          f"{score_t / dt:,.0f} tok/s; logits {tuple(logits.shape)} finite: {fin}; "
          f"mean NLL {nll:.3f} (random weights; ln V = {math.log(cfg.vocab_size):.3f})")
    if logits.shape != (1, score_t, cfg.padded_vocab) or not fin:
        raise SystemExit("g3 forward: bad logits")
    del logits
    _profile(torch, lambda: engine.generate(prompts, 16),
             f"g3 generate B={batch} P={prompt} +16 K={k_w}")
    with torch.inference_mode():
        _profile(torch, lambda: scoring(params, tokens), f"g3 forward B=1 T={score_t}", top=10)
    del engine
    torch.cuda.empty_cache()
    return {"flash_attention_cuda": got["flash_attention_cuda"]}, split, params


def _g3_reference_check(torch, np):
    """The reduced f32 Gemma3 with flash on the card against the same
    weights with the plain versions on the CPU: forward logits at T=200
    (past its window of 64, through its global layers) within 1e-4, and
    greedy tokens (a 40-token prefill, then single steps) equal."""
    from repro_torch.configs.registry import get_config
    from repro_torch.model import model as M
    from repro_torch.serve.engine import ServeEngine

    cfg = get_config("gemma3-1b").reduced()
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
    print(f"[reference] reduced f32 gemma3, card vs CPU: forward T=200 "
          f"max_abs_err={err:.2e} (tol 1e-4), greedy tokens equal: {same}")
    if err > 1e-4 or not same:
        raise SystemExit("card and CPU disagree on the reduced gemma3")


def _shared_prefix(np, a, b):
    """How many leading tokens the streams ``a`` and ``b`` share."""
    a, b = np.asarray(a), np.asarray(b)
    n = min(a.size, b.size)
    neq = np.nonzero(a[:n] != b[:n])[0]
    return int(neq[0]) if neq.size else n


def _victims(np, base, outs):
    """[(index, length of the prefix it shares with the fault-free run)]
    of every request that differs from that run."""
    return [(i, _shared_prefix(np, b, o)) for i, (b, o) in enumerate(zip(base, outs))
            if not np.array_equal(np.asarray(b), np.asarray(o))]


def _victim_prefixes(np, base, outs):
    """For each request that recovered: (index, shared prefix with the
    fault-free run, tokens in that run)."""
    return [(i, _shared_prefix(np, base[i], o), base[i].size)
            for i, o in enumerate(outs) if o.recoveries]


def _fault_isolation(torch, np, g3_params, k_w=8, timeout_s=3.0):
    """Phase 3i: fault isolation on the card.

    Full-size rwkv6-1.6b (bf16) serves phase 3's 6 requests on 4 slots,
    first fault-free, then under a fixed ``ChaosInjector``: at window 1 a
    NaN in one slot's state, a dropped dispatch and, on its retry, a hang
    that the watchdog fences off; a preemption after window 2, from whose
    snapshot (the victim still queued for recovery) a second serve
    resumes.  Every request but the
    victim must equal the fault-free run bit for bit and the counts must
    be exact; the victim re-prefills its prompt plus accepted tokens in
    one admission window (bf16 GEMMs of another shape) where the first run
    decoded them a step at a time, so its tokens may part at a near-tie:
    its shared prefix is printed, not held.  Full-size gemma3-1b: one NaN K row, caught by the
    logits check, neighbours bit-identical.  The reduced f32 models of all
    three archs: every stream, the victim's too, bit-identical to the
    fault-free run.  Returns the launch counts of the chaos serves."""
    import tempfile

    from repro_torch.configs.registry import get_config
    from repro_torch.model import model as M
    from repro_torch.serve.chaos import ChaosInjector, EnginePreempted
    from repro_torch.serve.engine import Request, ServeEngine

    counters = _counters()
    total = dict.fromkeys(counters, 0)

    def add(got):
        for n, c in got.items():
            total[n] += c

    cfg = get_config("rwkv6-1.6b")
    params = M.init_params(cfg, seed=0, device="cuda")
    engine = ServeEngine(cfg, params, max_len=512, decode_window=k_w)
    reqs = _g3_requests(np.random.default_rng(0), cfg.vocab_size)
    with torch.inference_mode():
        engine.serve(reqs[:1], slots=4)                       # warm-up
    base, dt, _ = _counted(torch, counters, lambda: engine.serve(reqs, slots=4, recoverable=True))
    windows = engine.last_serve_stats["decode_dispatches"]
    print(f"[chaos] rwkv6 fault-free serve: {windows} windows in {dt:.3f}s")
    if windows < 3:
        raise SystemExit(f"chaos: the fault-free serve ran {windows} windows; the drill needs 3")
    chaos = ChaosInjector(seed=0, nan_at=(1,), drop_at=(1,), hang_at=(1,), preempt_after=2,
                          max_hang_s=10 * timeout_s)
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as snap:
        def preempted():
            try:
                engine.serve(reqs, slots=4, chaos=chaos, watchdog_timeout_s=timeout_s,
                             snapshot_every=1, snapshot_dir=snap)
            except EnginePreempted as e:
                return str(e)
            raise SystemExit("chaos: the pinned preemption never fired")

        msg, dt1, got = _counted(torch, counters, preempted)
        add(got)
        first = dict(engine.last_serve_stats)
        outs, dt2, got = _counted(torch, counters,
                                  lambda: engine.serve(reqs, slots=4, restore_from=snap))
        add(got)
    st = engine.last_serve_stats
    diff = _victims(np, base, outs)
    victims = [i for i, r in enumerate(outs) if r.recoveries]
    print(f"[chaos] rwkv6 chaos serve: {msg} after {dt1:.3f}s ({first['snapshots']} snapshots); "
          f"resumed in {dt2:.3f}s; events {chaos.events}; stats {st}")
    print(f"[chaos] rwkv6 victim (index, equal prefix, fault-free tokens): "
          f"{_victim_prefixes(np, base, outs)}; outcomes {[r.outcome for r in outs]}; "
          f"requests differing from the fault-free run (index, equal prefix): {diff}")
    want = {"quarantines": 1, "recoveries": 1, "dispatch_drops": 1, "watchdog_timeouts": 1,
            "dispatch_retries": 2}
    if {k: st[k] for k in want} != want or len(victims) != 1:
        raise SystemExit(f"chaos: rwkv6 counts {st}, want {want} and one victim")
    if any(i not in victims for i, _ in diff):
        raise SystemExit(f"chaos: a neighbour of the victim diverged: {diff}")
    if st["decode_dispatches"] <= first["decode_dispatches"]:
        raise SystemExit("chaos: the restored serve did not continue the counters")
    if sum(got.values()) < 1:
        raise SystemExit("chaos: the rwkv6 chaos serve launched no kernel")
    print(f"[chaos] launches during the rwkv6 chaos serves: "
          f"{ {n: c for n, c in total.items() if c} }")
    del engine, params
    torch.cuda.empty_cache()

    cfg = get_config("gemma3-1b")
    engine = ServeEngine(cfg, g3_params, max_len=512, decode_window=k_w)
    reqs = _g3_requests(np.random.default_rng(0), cfg.vocab_size)
    base = engine.serve(reqs, slots=4, recoverable=True)
    chaos = ChaosInjector(seed=0, nan_at=(1,))
    outs, dt, got = _counted(torch, counters, lambda: engine.serve(reqs, slots=4, chaos=chaos))
    add(got)
    st = engine.last_serve_stats
    diff = _victims(np, base, outs)
    victims = [i for i, r in enumerate(outs) if r.recoveries]
    print(f"[chaos] gemma3 NaN K row at window 1: events {chaos.events}; quarantines "
          f"{st['quarantines']}, recoveries {st['recoveries']}; victim (index, equal prefix, "
          f"fault-free tokens) {_victim_prefixes(np, base, outs)}; differing (index, equal "
          f"prefix): {diff}; {sum(got.values())} port kernel launches")
    if (st["quarantines"], st["recoveries"], len(victims)) != (1, 1, 1) or any(
            i not in victims for i, _ in diff) or sum(got.values()):
        raise SystemExit("chaos: gemma3 quarantine failed or a neighbour diverged")
    del engine
    torch.cuda.empty_cache()

    spec = [(5, 9), (12, 3), (7, 14), (3, 6), (9, 11)]
    for arch in ("rwkv6-1.6b", "gemma3-1b", "recurrentgemma-2b"):
        cfg = get_config(arch).reduced()
        p_cpu = M.init_params(cfg, seed=0, device="cpu")
        rng = np.random.default_rng(0)
        reqs = [Request(tokens=rng.integers(0, cfg.vocab_size, (pl,)), max_new_tokens=nn)
                for pl, nn in spec]
        eng = ServeEngine(cfg, _to(p_cpu, "cuda"), max_len=96, decode_window=4)
        base = eng.serve(reqs, slots=3)
        outs = eng.serve(reqs, slots=3, chaos=ChaosInjector(seed=1, nan_at=(2,)))
        st = eng.last_serve_stats
        cpu = ServeEngine(cfg, p_cpu, max_len=96, decode_window=4, device="cpu").serve(
            reqs, slots=3)
        same = not _victims(np, base, outs)
        print(f"[chaos] reduced f32 {arch} on the card: quarantines {st['quarantines']}, "
              f"every stream (victim's too) bit-identical to the fault-free run: {same}; "
              f"fault-free streams equal the CPU's: {not _victims(np, base, cpu)}")
        if not same or st["quarantines"] != 1:
            raise SystemExit(f"chaos: reduced {arch} diverged under a NaN fault")
    return total


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


def _scan_plan_times(torch, EK, sets, reps):
    """Device µs of the chunked scan in every plan of ``scan_plans``
    through ``launch_plan`` (counts no launch), on the row's input sets."""
    b, t, d = sets[0][1].shape
    return {f"{p.mode} cols={p.cols} stages={p.stages}":
            round(1e3 * _time_ms(torch, lambda *a, p=p: EK.launch_plan(*a, plan=p), sets,
                                 reps=reps)[0], 2)
            for p in EK.scan_plans(b, t, d, sets[0][1].dtype)}


def _time_window_sweep(torch, ED, floor_ms):
    """Phase 4: the elevator window in f32 (as the model passes a and x) at
    K in (1, 8, 32, 64) tokens and B in (1, 4): device and per-call µs of
    the planner's choice and of every plan, beside its bytes bound and the
    launch floor plus that bound."""
    out = []
    for b in (1, 4):
        for kw in (1, 8, 32, 64):
            nbytes = 3 * b * kw * RG_D * 4 + 2 * b * RG_D * 4
            sets = _cold_sets(lambda s: _scan_inputs(torch, b, kw, torch.float32, s), nbytes)
            ms, call_ms = _time_ms(torch, ED.elevator_decode_window_cuda, sets, reps=100)
            b_ms = nbytes / HBM_BYTES_PER_S * 1e3
            plan = ED.plan_window(b, kw, RG_D, torch.float32, torch.cuda.get_device_properties(
                0).multi_processor_count)
            plans = {f"{p.mode} vec={p.vec} threads={p.threads}": round(1e3 * _time_ms(
                torch, lambda *a, p=p: ED.launch_plan(*a, plan=p), sets, reps=100)[0], 2)
                for p in ED.window_plans(b, kw, RG_D, torch.float32)}
            row = {"shape": f"B={b} K={kw}", "ms": ms, "call_ms": call_ms, "bound_ms": b_ms,
                   "floor_plus_bound_ms": floor_ms + b_ms,
                   "plan": f"{plan.mode} vec={plan.vec} threads={plan.threads}",
                   "plans": plans}
            out.append(row)
            print(f"[time] elevator window B={b} K={kw:2d} f32: device {ms * 1e3:6.2f} us, "
                  f"per call {call_ms * 1e3:6.2f} us, bound {b_ms * 1e3:.2f} us, floor + "
                  f"bound {(floor_ms + b_ms) * 1e3:.2f} us; plan {row['plan']}; every plan "
                  f"{plans}")
    return out


def _time_rg_kernels(torch, launches, worst, floor_ms, g3_split):
    """Phase 4 rows of RecurrentGemma's kernels at the main path's shapes:
    the scan and the token shift of a 4096-token forward (B=1), the window
    at a generated token (K=1, B=4) and flash attention of a local layer
    of the forward.  The scan also at the generate prefill (B=4, T=256),
    both scan rows with every plan, and the window with a sweep over K and
    B beside the launch floor (``floor_ms``, an empty kernel timed the same
    way).  ``library_ms``: a depthwise ``F.conv1d`` for the token shift
    and ``F.scaled_dot_product_attention`` with the same boolean mask and
    GQA for attention; no single PyTorch call computes a decayed linear
    scan, so the scan rows have none."""
    from repro_torch.kernels import card_checks as CC

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
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            rows[-1]["plan"] = str(EK.plan_scan(b, t, RG_D, torch.float32, sms))
            rows[-1]["plans"] = _scan_plan_times(torch, EK, sets, reps=50 if t < 4096 else 20)
            print(f"[time]   plan {rows[-1]['plan']}; every plan {rows[-1]['plans']}")
        # The window at one generated token: K=1, B=4.
        nbytes = 3 * 4 * RG_D * 4 + 2 * 4 * RG_D * 4
        sets = _cold_sets(lambda s: _scan_inputs(torch, 4, 1, f32, s), nbytes)
        row("elevator_decode_window_cuda", scan_src,
            "src/repro/kernels/elevator_scan/decode.py:64 (elevator_decode_window_pallas)",
            f"B=4 K=1 D={RG_D} f32", sets, ED.elevator_decode_window_cuda,
            ED.elevator_decode_window_plain, nbytes, 2 * 4 * RG_D, peak=PEAK_F32_FLOPS,
            reps=200)
        rows[-1]["launch_floor_ms"] = floor_ms
        rows[-1]["sweep"] = _time_window_sweep(torch, ED, floor_ms)

        # The token shift of the forward (bf16, B=1, T=4096), its library
        # call a depthwise conv1d over the (B, D, T) layout conv1d takes.
        def conv1d(x, w):
            return F.conv1d(x, w, padding=w.shape[-1] - 1, groups=RG_D)

        for b, t in ((1, 4096), (4, 4), (4, 259)):
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
        fa_src = "src/repro_torch/kernels/local_attention/csrc/flash_attention.cu"
        fa_replaces = "src/repro/kernels/local_attention/kernel.py:137 (flash_attention_pallas)"
        row("flash_attention_cuda", fa_src, fa_replaces,
            f"B=1 Hq=10 Hkv=1 T={t} D=256 W={RG_WINDOW} bf16", sets,
            lambda q, k, v: FA.flash_attention_cuda(q, k, v, causal=True, window=RG_WINDOW),
            lambda q, k, v: FA.attention_ref(q, k, v, causal=True, window=RG_WINDOW),
            nbytes, flops, library=sdpa, reps=20)

        # Causal with no window at the same shape (gemma3's global layers):
        # the library call is SDPA with is_causal=True, which may take
        # PyTorch's flash backend, on K/V repeated to the Hq heads before
        # the timed region.
        rep_sets = [(q, k.expand(-1, RG_HQ, -1, -1).contiguous(),
                     v.expand(-1, RG_HQ, -1, -1).contiguous()) for q, k, v in sets]

        def sdpa_causal(q, k, v):
            return F.scaled_dot_product_attention(q, k, v, is_causal=True)

        got = FA.flash_attention_cuda(*sets[0], causal=True)
        ratio = CC.attn_bf16_ratio(sdpa_causal(*rep_sets[0]), got)
        print(f"[time] SDPA is_causal agrees with flash_attention_cuda (no window): "
              f"worst err/tol per element {ratio:.3f}; SDPA backend: "
              f"{_sdpa_backend(torch, sdpa_causal, rep_sets[0])}")
        lib_ms = _time_ms(torch, sdpa_causal, rep_sets, reps=20)[0]
        del rep_sets
        row("flash_attention_cuda", fa_src, fa_replaces,
            f"B=1 Hq=10 Hkv=1 T={t} D=256 causal bf16", sets,
            lambda q, k, v: FA.flash_attention_cuda(q, k, v, causal=True),
            lambda q, k, v: FA.attention_ref(q, k, v, causal=True),
            nbytes, 4 * RG_DH * RG_HQ * _visible_pairs(t, t, True, None), reps=20)
        rows[-1]["library_ms"] = lib_ms
        print(f"[time]   SDPA is_causal library call: {lib_ms * 1e3:.2f} us")
        del sets

        # Gemma3's two shapes at a 4096-token forward (Hq 4 over 1 KV head):
        # its local layers (window 1024) beside SDPA with the same boolean
        # mask and GQA, its global layers (causal, no window) beside SDPA
        # is_causal on K/V repeated to the 4 heads; launches per forward
        # from phase 3h.
        g_nbytes = 2 * (2 * G3_HQ * t * RG_DH + 2 * RG_HKV * t * RG_DH)
        g_sets = _cold_sets(lambda s: _attn_inputs(torch, 1, t, t, bf, s, hq=G3_HQ), g_nbytes)
        for window, n in ((G3_WINDOW, g3_split["window"]), (None, g3_split["causal"])):
            if window:
                g_mask = attention_mask(t, t, causal=True, window=window, device="cuda")
                lib_sets = g_sets

                def lib(q, k, v, g_mask=g_mask):
                    return F.scaled_dot_product_attention(q, k, v, attn_mask=g_mask,
                                                          enable_gqa=True)
            else:
                lib_sets = [(q, k.expand(-1, G3_HQ, -1, -1).contiguous(),
                             v.expand(-1, G3_HQ, -1, -1).contiguous()) for q, k, v in g_sets]
                lib = sdpa_causal
            got = FA.flash_attention_cuda(*g_sets[0], causal=True, window=window)
            ratio = CC.attn_bf16_ratio(lib(*lib_sets[0]), got)
            backend = _sdpa_backend(torch, lib, lib_sets[0])
            print(f"[time] gemma3 W={window}: SDPA agrees with flash_attention_cuda: worst "
                  f"err/tol per element {ratio:.3f}; SDPA backend: {backend}")
            lib_ms = _time_ms(torch, lib, lib_sets, reps=20)[0]
            del lib_sets
            row("flash_attention_cuda", fa_src, fa_replaces,
                f"B=1 Hq={G3_HQ} Hkv=1 T={t} D=256 " + (f"W={window}" if window else "causal")
                + " bf16 (gemma3)", g_sets,
                lambda q, k, v, w=window: FA.flash_attention_cuda(q, k, v, causal=True, window=w),
                lambda q, k, v, w=window: FA.attention_ref(q, k, v, causal=True, window=w),
                g_nbytes, 4 * RG_DH * G3_HQ * _visible_pairs(t, t, True, window), reps=20)
            rows[-1].update(library_ms=lib_ms, launches=n, backend=backend)
            print(f"[time]   SDPA library call: {lib_ms * 1e3:.2f} us; {n} launches a forward")
    # One row per kernel in the result line: the main path's shape (the
    # first row of each name); the other shapes of flash attention, the
    # token shift and the scan ride along under "large", the rest are
    # printed above.
    seen, out = set(), []
    for r in rows:
        if r["name"] not in seen:
            seen.add(r["name"])
            out.append(r)
    names = [r["name"] for r in out]
    for name in ("flash_attention_cuda", "token_shift_cuda", "elevator_scan_cuda"):
        extra = [r for r in rows if r["name"] == name][1:]
        out[names.index(name)]["large"] = [
            {k: r[k] for k in ("shape", "ms", "call_ms", "plain_ms", "bound_ms", "bound_by",
                               "library_ms", "plan", "plans", "backend") if k in r}
            for r in extra]
        for big, r in zip(out[names.index(name)]["large"], extra):
            if r["launches"] != out[names.index(name)]["launches"]:
                big["launches"] = r["launches"]
    return out


def _sdpa_backend(torch, fn, args):
    """Which SDPA backend one call of ``fn`` took, as the profiler sees it:
    the ATen op it dispatched to (``_scaled_dot_product_<backend>_...``)
    and the CUDA kernels it launched, or "not told"."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn(*args)
        torch.cuda.synchronize()
    ops = sorted({e.name for e in prof.events() if e.device_type == DeviceType.CPU
                  and e.name.startswith("aten::_scaled_dot_product_")})
    kernels = sorted({e.name for e in prof.events() if e.device_type == DeviceType.CUDA})
    return "; ".join(ops + [k[:100] for k in kernels]) or "not told"

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
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            for m, k, n, bm, bn, bk in CC.MATMUL_CASES:
                a, b = _matmul_inputs(torch, m, k, n, dtype, seed=m + n)
                got = MM.matmul_fwd_cuda(a, b, block_m=bm, block_n=bn, block_k=bk)
                torch.cuda.synchronize()
                want = MM.matmul_ref(a, b)
                e, f32_tol, ratio = CC.matmul_error(got, want)
                scale = float(want.float().abs().max())
                print(f"[paper-kernels] matmul_fwd_cuda ({m},{k})x({k},{n}) blocks "
                      f"({bm},{bn},{bk}) {str(dtype):15s} plan {MM.plan(m, n, k, dtype, sms)} "
                      f"max_abs_err={e:.3e} "
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
        for dim, dtype, peak in ((256, f32, PEAK_F32_FLOPS), (256, bf, PEAK_BF16_FLOPS),
                                 (4096, bf, PEAK_BF16_FLOPS), (4096, f32, PEAK_F32_FLOPS)):
            item = 4 if dtype == f32 else 2
            nbytes = 3 * dim * dim * item
            sets = _cold_sets(lambda s: _matmul_inputs(torch, dim, dim, dim, dtype, s), nbytes)
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            print(f"[time] matmul_fwd_cuda {dim}^3 {dtype}: plan "
                  f"{MM.plan(dim, dim, dim, dtype, sms)}")
            measure("matmul_fwd_cuda", f"{dim}^3 {'f32' if dtype == f32 else 'bf16'}", sets,
                    lambda a, b: MM.matmul_fwd_cuda(a, b), MM.matmul_ref, torch.matmul,
                    nbytes, 2 * dim ** 3, peak, reps=100 if dim < 4096 else 10)
    # One row per kernel in the result line, at the suite's shape; the other
    # shapes (256^3 bf16 and the large ones) ride along under "large".
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
