"""Where the chunked elevator scan's time goes, on the card: ``clock64()``
stamps in instrumented copies of ``kernels/elevator_scan/csrc/elevator_scan.cu``.

The script copies the source, inserts stamps into the chain warp of
``elevator_scan_kernel`` (cycles waiting on a stage's full barrier, running
the stage's rows, releasing the stage; lane 0 of each block, summed over
the sweep) and an ``extern "C"`` function that copies them out, compiles
the copy with the build's flags and launches it through
``kernel._launch`` at RecurrentGemma's forward shape (B=1, T=4096,
D=2560, f32, inputs cold in L2).  A second copy, ``floor``, keeps one
shared load and no global store a row (the x loads read the a registers,
the stores are dropped): its rows time the chain of steps itself, the
floor under any store or load schedule.  For each plan it prints the
device µs per call (timed as ``chip_smoke.py``'s phase 4 does) and the
mean cycles per block and per stage row, one JSON object a line.  The
instrumented copies live under ``build/`` and are never the library the
port loads.

    python -m repro_torch.benchmarks.scan_stamps [--reps N]

runs on the card only, and raises without one.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import torch

from repro_torch.kernels import common
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.elevator_scan import kernel as EK

B, T, D = 1, 4096, 2560
#: The plans stamped: the planner's at this shape and the others of
#: ``kernel.scan_plans``.
PLANS = tuple(EK.scan_plans(B, T, D, torch.float32))

#: (anchor, replacement) edits of the instrumented copy.
STAMPS = (
    ("namespace {\n", "namespace {\n__device__ unsigned long long g_st[65536][4];\n"),
    ("  const size_t stride = (size_t)D / PER;        // words between rows of out\n",
     "  const size_t stride = (size_t)D / PER;        // words between rows of out\n"
     "  long long t_start = clock64(), t_wait = 0, t_rows = 0, t_free = 0, q1 = 0, q2 = 0;\n"),
    ("    sm90::mbar_wait(&full[s], (c / ns) & 1);\n",
     "    const long long q0 = clock64();\n    sm90::mbar_wait(&full[s], (c / ns) & 1);\n"
     "    q1 = clock64();\n    t_wait += q1 - q0;\n"),
    ("    __syncwarp();                               // every lane has read stage s\n",
     "    __syncwarp();                               // every lane has read stage s\n"
     "    q2 = clock64();\n    t_rows += q2 - q1;\n"),
    ("    if (lane == 0) sm90::mbar_arrive(&empty[s]);\n  }\n}\n",
     "    if (lane == 0) sm90::mbar_arrive(&empty[s]);\n    t_free += clock64() - q2;\n  }\n"
     "  if (lane == 0) {\n    unsigned long long* g = g_st[blockIdx.y * gridDim.x + blockIdx.x];\n"
     "    g[0] = clock64() - t_start;\n    g[1] = t_wait;\n    g[2] = t_rows;\n"
     "    g[3] = t_free;\n  }\n}\n"),
)
#: The chain-only copy: one shared load a row, no global store.
FLOOR = (
    ("    auto put = [&](int r, const W& w) { o[r * stride] = w; };\n",
     "    auto put = [&](int r, const W& w) {\n      if (r == 0 && c == nchunks - 1) o[0] = w;\n    };\n"),
    ("    vx[i] = sx[i * stride];\n", "    vx[i] = va[i];\n"),
)
GETTER = ('\nextern "C" int scan_stamps(void* dst, int n) {\n'
          "  return (int)cudaMemcpyFromSymbol(dst, g_st, (size_t)n * 32);\n}\n")


def _edit(src, edits):
    for anchor, repl in edits:
        if src.count(anchor) != 1:
            raise RuntimeError(f"scan_stamps: anchor not found once: {anchor!r}")
        src = src.replace(anchor, repl)
    return src


def build():
    """The two instrumented copies, compiled in parallel; name -> library."""
    src = _edit(common.KERNEL_SOURCES["elevator_scan"].read_text(), STAMPS) + GETTER
    out = common.BUILD_DIR / "scan_stamps"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in (("stamped", src), ("floor", _edit(src, FLOOR))):
        (out / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [common._nvcc(), *common._NVCC_FLAGS, "-o", str(out / f"{name}.so"),
             str(out / f"{name}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    libs = {}
    for name, proc in procs.items():
        report, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{report}")
        libs[name] = common.open_library("elevator_scan", out / f"{name}.so")
        libs[name].scan_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return libs


def _inputs(seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    a = torch.rand((B, T, D), generator=g, device=device) * 0.5 + 0.5
    x = torch.randn((B, T, D), generator=g, device=device)
    return a, x, torch.randn((B, D), generator=g, device=device)


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
        torch.cuda._sleep(100_000_000)
        e0.record()
        for _ in range(reps):
            fn(*arg_sets[n % len(arg_sets)])
            n += 1
        e1.record()
        e1.synchronize()
        out.append(e0.elapsed_time(e1) * 1e3 / reps)
    return sorted(out)[2]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    device = resolve_device(None)
    libs = build()
    common.load_library("elevator_scan")
    sets = [_inputs(s, device) for s in range(2)]        # 252 MB: cold in the 50 MB L2
    want = EK.elevator_scan_ref(*sets[1])
    for name, lib in libs.items():
        common._LIBS["elevator_scan"] = lib
        for plan in PLANS:
            us = _time_us(lambda a, x, h, p=plan: EK._launch(a, x, h, p), sets, args.reps)
            torch.empty(64 << 20, device=device).fill_(1.0)   # flush the L2
            torch.cuda.synchronize()
            got = EK._launch(*sets[1], plan)
            torch.cuda.synchronize()
            blocks = B * -(-D // plan.cols)
            st = torch.zeros((blocks, 4), dtype=torch.int64)
            if lib.scan_stamps(st.data_ptr(), blocks):
                raise RuntimeError("scan_stamps: copying the stamps failed")
            total, wait, rows, free = (float(v) for v in st.double().mean(0))
            print(json.dumps({
                "copy": name, "plan": str(plan), "us": round(us, 2),
                "bit_equal": bool(torch.equal(got, want)) if name == "stamped" else None,
                "cycles": {"total": round(total), "wait": round(wait), "rows": round(rows),
                           "release": round(free)},
                "cycles_a_row": {"wait": round(wait / T, 2), "rows": round(rows / T, 2),
                                 "release": round(free / T, 2)},
            }))
    del common._LIBS["elevator_scan"]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())


if __name__ == "__main__":
    main()
