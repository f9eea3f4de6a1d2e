"""Paper §5 benchmark suite analog (Fig. 11 speedup / Fig. 12 energy), in
PyTorch on the card.

Counterpart of ``benchmarks/rodinia.py``.  Each kernel from the paper's
Table 3 is implemented twice on identical math:

  * ``shared``: the von-Neumann GPGPU pattern, intermediates staged
    through a buffer behind a barrier (``core.scratchpad``), Fig. 1b / 2a;
  * ``direct``: dMT-CGRA inter-thread communication, elevator shifts and
    eLDST forwarding (``core.elevator`` / ``core.eldst``), Fig. 1c / 2b.

The nine cases are the reference's, unchanged: its matrixMul is ``a @ b``
and its stencils are elevator shifts, so the suite launches neither of the
port's paper-demo kernels (``matmul_fwd``, ``stencil2d``); those are
reached through their ops.

Reported per kernel:
  - wall clock of shared and direct on the device the suite ran on.  On
    the card each case runs eagerly (the reference ran each under
    ``jax.jit``; no ``torch.compile`` here) and is timed with CUDA events
    around ``reps`` calls after one warm-up call.  Eager PyTorch already
    materializes every intermediate, so ``barrier`` is a no-op and shared
    against direct is eager against eager (see ``core/scratchpad.py``);
  - memory-traffic / energy reduction from the cost model, and the
    modeled Fig. 11 speedup, equal to the reference's exactly;
  - critical-path depth (the paper's BPNN slowdown).

    python -m repro_torch.benchmarks.rodinia [--smoke] [--device cpu]

runs on the card unless ``--device cpu`` is given, and raises without one.
"""

from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import (
    barrier,
    cost_model,
    from_thread_or_const,
    from_thread_or_const_nd,
    linear_scan,
)
from repro_torch.kernels.common import resolve_device

N = 1 << 16          # default thread-block-scale problem size
MAT = 256            # matmul / lud dimension
GRID = (256, 512)    # stencil grid
BP = (64, 2048)      # bpnn (hidden units, inputs)

#: The reference's smoke shapes (tiny, one rep): they exercise every code
#: path and parity assert, not the timings.
SMOKE = {"n": 1 << 10, "mat": 32, "grid": (16, 32), "bp": (8, 64)}

#: Stencil coefficients (c_center, c_up, c_down, c_left, c_right).  Python
#: floats: PyTorch rounds a scalar operand to the tensor's f32 as
#: ``jnp.asarray`` does, so the products are the same, and a call copies
#: nothing from the host.
HOTSPOT = (0.6, 0.1, 0.1, 0.1, 0.1)
SRAD = (1.0, -0.25, -0.25, -0.25, -0.25)   # simplified diffusion step


def _time(fn, *args, reps=20):
    """Microseconds per call: one warm-up call, then ``reps`` calls between
    two CUDA events (the host clock on the CPU), ending in a synchronize."""
    fn(*args)
    dev = args[0].device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn(*args)
        e1.record()
        e1.synchronize()
        return e0.elapsed_time(e1) / reps * 1e3
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(*args)
    return (time.perf_counter() - t0) / reps * 1e6


# --------------------------------------------------------------------------
# Kernels: (shared_fn, direct_fn, cost_fn, critical_path_{shared,direct})
# --------------------------------------------------------------------------

def scan_shared(x):
    # Hillis-Steele in "shared memory": barrier between every level.
    out = x
    shift = 1
    while shift < x.shape[0]:
        out = barrier(out)                     # __syncthreads
        shifted = F.pad(out, (shift, 0))[: x.shape[0]]
        out = out + shifted
        shift *= 2
    return out


def scan_direct(x):
    # Paper Fig. 6: fromThreadOrConst<sum, 1, 0> folded into the firing rule.
    return linear_scan(torch.ones_like(x), x)


def matmul_shared(a, b):
    a_s = barrier(a)                           # stage A tile + barrier
    b_s = barrier(b)
    return a_s @ b_s


def matmul_direct(a, b):
    # Operand forwarding: a product outside any kernel of the port, as the
    # reference leaves it to XLA.
    return a @ b


def conv_shared(x, k):
    x_s = barrier(F.pad(x, (1, 1)))            # staged padded image
    return x_s[:-2] * k[0] + x_s[1:-1] * k[1] + x_s[2:] * k[2]


def conv_direct(x, k):
    # Fig. 1c: neighbors arrive as elevator shifts, margins as constant C.
    left = from_thread_or_const(x, 1, 0.0)
    right = from_thread_or_const(x, -1, 0.0)
    return left * k[0] + x * k[1] + right * k[2]


def reduce_shared(x):
    out = x
    n = x.shape[0]
    while n > 1:
        out = barrier(out)
        half = n // 2
        out = out[:half] + out[half:n]
        n = half
    return out[0]


def reduce_direct(x):
    # Windowed elevator tree: each level forwards partial sums point-to-point.
    out = x
    n = x.shape[0]
    while n > 1:
        half = n // 2
        partner = from_thread_or_const(out[:n], -half, 0.0)[:half]
        out = out[:half] + partner
        n = half
    return out[0]


def lud_shared(a):
    # One lud_internal step: stage the pivot row/col, barrier, update trail.
    pivot_row = barrier(a[0, 1:])
    pivot_col = barrier(a[1:, 0] / a[0, 0])
    return a[1:, 1:] - torch.outer(pivot_col, pivot_row)


def lud_direct(a):
    pivot_row = a[0, 1:]
    pivot_col = a[1:, 0] / a[0, 0]
    return a[1:, 1:] - torch.outer(pivot_col, pivot_row)


def _stencil_shared(x, c):
    xs = barrier(F.pad(x, (1, 1, 1, 1)))
    return (c[0] * xs[1:-1, 1:-1] + c[1] * xs[:-2, 1:-1] + c[2] * xs[2:, 1:-1]
            + c[3] * xs[1:-1, :-2] + c[4] * xs[1:-1, 2:])


def _stencil_direct(x, c):
    up = from_thread_or_const_nd(x, (1, 0), 0.0)
    down = from_thread_or_const_nd(x, (-1, 0), 0.0)
    left = from_thread_or_const_nd(x, (0, 1), 0.0)
    right = from_thread_or_const_nd(x, (0, -1), 0.0)
    return c[0] * x + c[1] * up + c[2] * down + c[3] * left + c[4] * right


def hotspot_shared(x):
    return _stencil_shared(x, HOTSPOT)


def hotspot_direct(x):
    return _stencil_direct(x, HOTSPOT)


def srad_shared(x):
    return _stencil_shared(x, SRAD)


def srad_direct(x):
    return _stencil_direct(x, SRAD)


def pathfinder_shared(cost, cur):
    cur_s = barrier(cur)
    left = F.pad(cur_s, (1, 0), value=math.inf)[:-1]
    right = F.pad(cur_s, (0, 1), value=math.inf)[1:]
    return cost + torch.minimum(cur_s, torch.minimum(left, right))


def pathfinder_direct(cost, cur):
    left = from_thread_or_const(cur, 1, math.inf)
    right = from_thread_or_const(cur, -1, math.inf)
    return cost + torch.minimum(cur, torch.minimum(left, right))


def bpnn_shared(w, x):
    # layerforward: staged partial products + barriered tree sum.
    prod = barrier(w * x[None, :])
    return torch.sigmoid(prod.sum(dim=1))


def bpnn_direct(w, x):
    # The paper keeps the original adjacent-thread chain: each thread adds
    # its product to the previous thread's partial sum (Δ=1 elevator), a
    # serial chain, which is why the paper reports a ~40% slowdown.
    prod = w * x[None, :]
    sums = linear_scan(torch.ones_like(prod), prod, axis=1)[:, -1]
    return torch.sigmoid(sums)


# --------------------------------------------------------------------------
# Performance model (the Fig. 11 analog): Fermi-class per-SM constants
# against the paper's 140-unit CGRA core (Table 2), as the reference has them.
# --------------------------------------------------------------------------

GPU_LANES = 32                # CUDA cores per SM
CGRA_UNITS = 140              # dMT-CGRA functional units (Table 2)
CLOCK = 1.4e9                 # both cores clock at 1.4 GHz (Table 2)
DRAM_BW = 177e9 / 15          # GTX480 DRAM bandwidth per SM (B/s)
SPAD_BW = GPU_LANES * 4 * CLOCK / 2   # shared-memory B/s per SM (bank-limited)
FABRIC_BW = CGRA_UNITS * 4 * CLOCK    # producer->consumer forwarding B/s
BARRIER_CYCLES = 100          # per __syncthreads (drain + refill)


def modeled_time_shared(cost: "cost_model.KernelCost", n_threads: int,
                        n_barriers: float) -> float:
    t_compute = cost.flops / (GPU_LANES * CLOCK)
    t_mem = (cost.traffic.dram_bytes / DRAM_BW
             + cost.traffic.scratchpad_bytes / SPAD_BW)
    # A barrier stalls the whole block: every warp must arrive.
    t_sync = n_barriers * (BARRIER_CYCLES + n_threads / GPU_LANES) / CLOCK
    return max(t_compute, t_mem) + t_sync


def modeled_time_direct(cost: "cost_model.KernelCost", critical_path: float,
                        width: float = float("inf")) -> float:
    # `width` = available thread-level parallelism; chains narrower than the
    # grid leave units idle (the paper's BPNN pathology).
    t_compute = cost.flops / (min(CGRA_UNITS, width) * CLOCK)
    t_mem = (cost.traffic.dram_bytes / DRAM_BW
             + cost.traffic.fabric_bytes / FABRIC_BW)
    # Dataflow firing: no barriers, but serial producer->consumer chains
    # bound latency by the chain length.
    t_chain = critical_path / CLOCK
    return max(t_compute, t_mem, t_chain)


# --------------------------------------------------------------------------
# Harness
# --------------------------------------------------------------------------

def make_inputs(smoke: bool = False, device=None) -> dict[str, torch.Tensor]:
    """The suite's inputs: the reference's numpy seed-0 draws, in its order,
    moved to ``device`` (the card unless ``"cpu"`` is named)."""
    dev = resolve_device(device)
    n = SMOKE["n"] if smoke else N
    mat = SMOKE["mat"] if smoke else MAT
    grid_hw = SMOKE["grid"] if smoke else GRID
    bp = SMOKE["bp"] if smoke else BP
    rng = np.random.default_rng(0)
    arrays = {
        "x1": rng.standard_normal(n).astype(np.float32),
        "k3": np.asarray([0.25, 0.5, 0.25], np.float32),
        "a_m": rng.standard_normal((mat, mat)).astype(np.float32),
        "b_m": rng.standard_normal((mat, mat)).astype(np.float32),
        "grid": rng.standard_normal(grid_hw).astype(np.float32),
        "w_b": rng.standard_normal(bp).astype(np.float32) * 0.05,
        "x_b": rng.standard_normal(bp[1]).astype(np.float32),
        "pf_cost": rng.random(n).astype(np.float32),
    }
    return {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}


def cases(inp: dict[str, torch.Tensor]) -> list[tuple]:
    """(name, shared_fn, direct_fn, args, costs, n_barriers, n_threads,
    chain_direct, width_direct) for the nine kernels, as the reference
    lists them."""
    n = inp["x1"].shape[0]
    mat = inp["a_m"].shape[0]
    grid_hw = tuple(inp["grid"].shape)
    bp = tuple(inp["w_b"].shape)
    log2n = math.log2(n)
    return [
        ("scan", scan_shared, scan_direct, (inp["x1"],),
         cost_model.scan_traffic(n), log2n, n, n, CGRA_UNITS),
        ("matrixMul", matmul_shared, matmul_direct, (inp["a_m"], inp["b_m"]),
         cost_model.matmul_traffic(mat, mat, mat), 2 * mat / 16, mat * mat,
         mat, CGRA_UNITS),
        ("convolution", conv_shared, conv_direct, (inp["x1"], inp["k3"]),
         cost_model.conv1d_traffic(n), 1, n, 2, CGRA_UNITS),
        ("reduce", reduce_shared, reduce_direct, (inp["x1"],),
         cost_model.reduce_traffic(n), log2n, n, log2n, CGRA_UNITS),
        ("lud", lud_shared, lud_direct, (inp["a_m"],),
         cost_model.matmul_traffic(mat - 1, 1, mat - 1), 2, mat * mat, 2,
         CGRA_UNITS),
        ("srad", srad_shared, srad_direct, (inp["grid"],),
         cost_model.stencil2d_traffic(*grid_hw), 1, grid_hw[0] * grid_hw[1],
         2, CGRA_UNITS),
        ("hotspot", hotspot_shared, hotspot_direct, (inp["grid"],),
         cost_model.stencil2d_traffic(*grid_hw), 1, grid_hw[0] * grid_hw[1],
         2, CGRA_UNITS),
        ("pathfinder", pathfinder_shared, pathfinder_direct,
         (inp["pf_cost"], inp["x1"]),
         cost_model.stencil2d_traffic(1, n, pts=3), 1, n, 2, CGRA_UNITS),
        # BPNN keeps the original adjacent-thread chain (paper §5.2): only
        # bp[0] chains run concurrently -> width-limited + bp[1]-deep chain.
        ("bpnn", bpnn_shared, bpnn_direct, (inp["w_b"], inp["x_b"]),
         cost_model.reduce_traffic(bp[0] * bp[1]), math.log2(bp[1]), bp[1],
         bp[1], bp[0]),
    ]


def run(reps: int = 20, smoke: bool = False, device=None) -> list[dict]:
    """Every case, shared and direct, on ``device`` (the card unless
    ``"cpu"`` is named): the parity assert between the two outputs
    (rtol = atol = 2e-3), their times, and the modeled numbers."""
    inp = make_inputs(smoke, device)
    dev = inp["x1"].device
    rows = []
    for name, f_sh, f_di, args, costs, n_barriers, n_thr, chain, width in cases(inp):
        out_sh = f_sh(*args).float().cpu().numpy()
        out_di = f_di(*args).float().cpu().numpy()
        np.testing.assert_allclose(out_sh, out_di, rtol=2e-3, atol=2e-3)
        t_sh = _time(f_sh, *args, reps=reps)
        t_di = _time(f_di, *args, reps=reps)
        naive, shared, direct = costs
        m_sh = modeled_time_shared(shared, n_thr, n_barriers)
        m_di = modeled_time_direct(direct, chain, width)
        rows.append({
            "name": name,
            "device": dev.type,
            "us_shared": t_sh,
            "us_direct": t_di,
            "speedup_wallclock": t_sh / t_di,
            "modeled_speedup": m_sh / m_di,
            "energy_shared_pj": shared.energy_pj,
            "energy_direct_pj": direct.energy_pj,
            "energy_reduction": shared.energy_pj / max(direct.energy_pj, 1e-9),
            "traffic_reduction": (
                (naive.traffic.dram_bytes + naive.traffic.scratchpad_bytes)
                / max(direct.traffic.dram_bytes, 1)
            ),
            "critical_path_direct": chain,
        })
    return rows


def geomean(vals):
    return math.exp(sum(math.log(v) for v in vals) / len(vals))


def report(rows: list[dict]) -> list[str]:
    """The reference's CSV and geomean lines for ``rows``."""
    lines = ["name,us_shared,us_direct,wallclock_speedup,modeled_speedup,"
             "energy_reduction,traffic_reduction,critical_path_direct"]
    for r in rows:
        lines.append(
            f"{r['name']},{r['us_shared']:.1f},{r['us_direct']:.1f},"
            f"{r['speedup_wallclock']:.2f},{r['modeled_speedup']:.2f},"
            f"{r['energy_reduction']:.2f},{r['traffic_reduction']:.1f},"
            f"{r['critical_path_direct']:.0f}")
    model_all = [r["modeled_speedup"] for r in rows]
    lines.append(f"geomean_modeled_speedup,{geomean(model_all):.2f}")
    lines.append(f"max_modeled_speedup,{max(model_all):.2f}")
    lines.append(f"geomean_energy_reduction,{geomean([r['energy_reduction'] for r in rows]):.2f}")
    lines.append("paper_reference,geomean 4.5x / max 13.5x speedup; 7x energy")
    return lines


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="the reference's tiny shapes and one rep")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run there)")
    args = ap.parse_args(argv)
    rows = run(reps=1 if args.smoke else 20, smoke=args.smoke, device=args.device)
    dev = resolve_device(args.device)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"# device: {where}; wall clock of eager PyTorch calls")
    for line in report(rows):
        print(line)
    return rows


if __name__ == "__main__":
    main()
