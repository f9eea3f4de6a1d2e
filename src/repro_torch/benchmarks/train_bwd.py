"""The training backward kernels at the shapes of PERF.md's rows B1, B2 and
B3, timed on the card as ``chip_smoke.py``'s phase 4 times them.

B1 is flash attention's backward (``flash_attention_bwd_cuda``, bf16) at
Gemma3-1B's training microbatch (B=4, 4 query heads over 1 KV head of 256,
T=2048; causal and window 1024) and RecurrentGemma-2B's (B=2, 10 over 1,
T=1024, window 2048); B2 the RG-LRU scan's backward
(``elevator_scan_bwd_cuda``, f32) at (1, 4096, 2560) and (2, 1024, 2560);
B3 and B3b the token shift's backward (``token_shift_bwd_cuda``, bf16, 4
taps) at the same two shapes.  Each row launches the wrapper on inputs
cycled through more bytes than the L2 and prints one JSON object: the
row, the shape and the device µs per call (the median of 5 rounds of
``--reps`` calls queued behind ``torch.cuda._sleep``).  It uses only the wrappers' public signatures, so
pointing PYTHONPATH at a ``git archive`` of another commit times that
commit's kernels with the same script, and two commits compare in one call:

    PYTHONPATH=<checkout>/src python src/repro_torch/benchmarks/train_bwd.py
        [--reps N] [--sdpa] [--conv] [--profile] [--rows B3 ...]

With ``--sdpa`` each B1 row also times SDPA's backward alone (the grad of a
kept graph on the same inputs and mask: the library yardstick, used nowhere
in the port); with ``--conv`` each B3 row times ``conv1d_input`` plus
``conv1d_weight`` on the same inputs (the depthwise conv's grads on the (B,
D, T) layout).  Where the checkout has the plan API, each row also times
every plan (``flash_bwd_plans``, ``scan_bwd_plans``, ``shift_bwd_plans``).
``--profile`` adds each row's device µs a call by kernel name, from
``torch.profiler`` over ``--reps`` calls (a wrapper of two kernels shows
both).  ``--rows`` keeps the rows whose names start with one of the given
prefixes.  Runs on the card only, and raises without one.
"""

from __future__ import annotations

import argparse
import json
import math

import torch

#: (row, B, Hq, Hkv, T, D, window): the flash rows, all causal.
FLASH_ROWS = (
    ("B1", 4, 4, 1, 2048, 256, None),
    ("B1 W=1024", 4, 4, 1, 2048, 256, 1024),
    ("B1 recurrentgemma", 2, 10, 1, 1024, 256, 2048),
)
#: (row, B, T, D): the scan rows, f32.
SCAN_ROWS = (
    ("B2", 1, 4096, 2560),
    ("B2 B=2", 2, 1024, 2560),
)
#: (row, B, T, D): the token shift rows, bf16, 4 taps.
SHIFT_ROWS = (
    ("B3", 1, 4096, 2560),
    ("B3b", 2, 1024, 2560),
)
SHIFT_TAPS = 4


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


def _kernel_split(fn, arg_sets, reps):
    """Device µs a call of each kernel ``fn`` launches, by name, from the
    profiler over ``reps`` calls."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(reps):
            fn(*arg_sets[i % len(arg_sets)])
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        us = e.cuda_time_total if us is None else us
        if us > 0:
            split[e.key] = round(us / reps, 3)
    return split


def _count(nbytes):
    """Input sets that together exceed the 50 MB L2 cache twice over."""
    return max(2, math.ceil(128 * 2**20 / nbytes))


def _keep(row, prefixes):
    return not prefixes or any(row.startswith(p) for p in prefixes)


def _flash_rows(reps, sdpa, profile, prefixes):
    import torch.nn.functional as F

    from repro_torch.kernels.local_attention import kernel as FA

    bf = torch.bfloat16
    for row, b, hq, hkv, t, d, window in FLASH_ROWS:
        if not _keep(row, prefixes):
            continue
        mask = dict(causal=True, window=window)
        nbytes = 2 * (3 * b * hq * t * d + 2 * b * hkv * t * d) * 2
        g = torch.Generator(device="cuda").manual_seed(0)
        sets = []
        with torch.no_grad():
            for _ in range(_count(nbytes)):
                q = torch.randn((b, hq, t, d), generator=g, device="cuda").to(bf)
                k, v = (torch.randn((b, hkv, t, d), generator=g, device="cuda").to(bf)
                        for _ in range(2))
                do = torch.randn((b, hq, t, d), generator=g, device="cuda").to(bf)
                o, lse = FA.flash_attention_cuda(q, k, v, lse=True, **mask)
                sets.append((q, k, v, o, lse, do))
            rec = {"row": row, "shape": f"B={b} Hq={hq} Hkv={hkv} T={t} D={d} "
                   + (f"W={window}" if window else "causal") + " bf16",
                   "device_us": _time_us(lambda *a: FA.flash_attention_bwd_cuda(*a, **mask),
                                         sets, reps)}
            if hasattr(FA, "flash_bwd_plans"):
                rec["plans"] = {
                    f"cluster={p.cluster} stages={p.kv_stages}/{p.dq_stages}": _time_us(
                        lambda *a, p=p: FA.launch_bwd_plan(*a, plan=p, **mask), sets, reps)
                    for p in FA.flash_bwd_plans(b, hq, hkv, t, t, d)}
            if profile:
                rec["kernels_us"] = _kernel_split(
                    lambda *a: FA.flash_attention_bwd_cuda(*a, **mask), sets, reps)
        if sdpa:
            rec["sdpa_us"] = _time_us(_sdpa_backward, _sdpa_sets(F, sets, hq, window), reps)
        print(json.dumps(rec), flush=True)
        del sets
        torch.cuda.empty_cache()


def _sdpa_sets(F, sets, hq, window):
    """SDPA's graphs on the same inputs: causal on K/V repeated to the query
    heads, or the window's boolean mask with ``enable_gqa``."""
    t = sets[0][0].shape[2]
    i = torch.arange(t, device="cuda")
    am = None
    if window is not None:
        am = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
    out = []
    for q, k, v, _, _, do in sets:
        if window is None:
            k, v = (x.expand(-1, hq, -1, -1).contiguous() for x in (k, v))
        q_, k_, v_ = (x.detach().requires_grad_(True) for x in (q, k, v))
        o = F.scaled_dot_product_attention(q_, k_, v_, attn_mask=am, is_causal=window is None,
                                           enable_gqa=window is not None)
        out.append((o, q_, k_, v_, do))
    return out


def _sdpa_backward(o, q_, k_, v_, do):
    return torch.autograd.grad(o, (q_, k_, v_), do, retain_graph=True)


def _scan_rows(reps, profile, prefixes):
    from repro_torch.kernels.elevator_scan import kernel as EK

    for row, b, t, d in SCAN_ROWS:
        if not _keep(row, prefixes):
            continue
        nbytes = 5 * b * t * d * 4
        g = torch.Generator(device="cuda").manual_seed(0)
        sets = []
        with torch.no_grad():
            for _ in range(_count(nbytes)):
                a = torch.rand((b, t, d), generator=g, device="cuda") * 0.5 + 0.5
                x = torch.randn((b, t, d), generator=g, device="cuda")
                h0 = torch.randn((b, d), generator=g, device="cuda")
                h = EK.elevator_scan_cuda(a, x, h0)
                dh = torch.randn((b, t, d), generator=g, device="cuda")
                sets.append((a, h, dh, h0))
            rec = {"row": row, "shape": f"B={b} T={t} D={d} f32",
                   "device_us": _time_us(EK.elevator_scan_bwd_cuda, sets, reps)}
            if hasattr(EK, "scan_bwd_plans"):
                rec["plans"] = {
                    f"{p.mode} cols={p.cols} stages={p.stages}": _time_us(
                        lambda *a, p=p: EK.launch_bwd_plan(*a, plan=p), sets, reps)
                    for p in EK.scan_bwd_plans(b, t, d)}
            if profile:
                rec["kernels_us"] = _kernel_split(EK.elevator_scan_bwd_cuda, sets, reps)
        print(json.dumps(rec), flush=True)
        del sets
        torch.cuda.empty_cache()


def _shift_rows(reps, conv, profile, prefixes):
    from torch.nn.grad import conv1d_input, conv1d_weight

    from repro_torch.kernels.token_shift import kernel as TS

    bf, taps = torch.bfloat16, SHIFT_TAPS
    for row, b, t, d in SHIFT_ROWS:
        if not _keep(row, prefixes):
            continue
        nbytes = 3 * b * t * d * 2
        g = torch.Generator(device="cuda").manual_seed(0)
        sets = []
        with torch.no_grad():
            for _ in range(_count(nbytes)):
                x = torch.randn((b, t, d), generator=g, device="cuda").to(bf)
                w = (torch.randn((taps, d), generator=g, device="cuda") * 0.1).to(bf)
                dout = torch.randn((b, t, d), generator=g, device="cuda").to(bf)
                sets.append((x, w, dout))
            rec = {"row": row, "shape": f"B={b} T={t} D={d} taps={taps} bf16",
                   "device_us": _time_us(TS.token_shift_bwd_cuda, sets, reps)}
            if hasattr(TS, "shift_bwd_plans"):
                rec["plans"] = {
                    f"groups={p.groups} cluster={p.cluster} rows={p.rows}":
                    _time_us(lambda *a, p=p: TS.launch_bwd_plan(*a, plan=p), sets, reps)
                    for p in TS.shift_bwd_plans(b, t, d, taps, bf)}
            if profile:
                rec["kernels_us"] = _kernel_split(TS.token_shift_bwd_cuda, sets, reps)
            if conv:
                # The depthwise conv on the (B, D, T) layout, padded taps - 1 on
                # the left; its grads from dout padded to the conv's length.
                lib = [(x.transpose(1, 2).contiguous(), w.t().flip(1)[:, None].contiguous(),
                        torch.nn.functional.pad(dout.transpose(1, 2), (0, taps - 1)).contiguous())
                       for x, w, dout in sets]
                rec["conv_us"] = _time_us(
                    lambda xt, wt, gp: (
                        conv1d_input(xt.shape, wt, gp, padding=taps - 1, groups=d),
                        conv1d_weight(xt, wt.shape, gp, padding=taps - 1, groups=d)),
                    lib, reps)
        print(json.dumps(rec), flush=True)
        del sets
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--sdpa", action="store_true",
                    help="also time SDPA's backward beside each flash row")
    ap.add_argument("--conv", action="store_true",
                    help="also time conv1d_input + conv1d_weight beside each token shift row")
    ap.add_argument("--profile", action="store_true",
                    help="also split each row's device time by kernel (torch.profiler)")
    ap.add_argument("--rows", nargs="*", default=(),
                    help="time only the rows whose names start with one of these")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("train_bwd: no card (torch.cuda.is_available() is false)")
    _flash_rows(args.reps, args.sdpa, args.profile, args.rows)
    _scan_rows(args.reps, args.profile, args.rows)
    _shift_rows(args.reps, args.conv, args.profile, args.rows)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
