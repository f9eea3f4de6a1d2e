"""Memory-traffic and energy cost model (paper Fig. 11/12 analogs).

The port's own copy of ``repro.core.cost_model``, whole: the per-byte
energy table, :class:`Traffic`, :class:`KernelCost` and the traffic of the
matmul, 1-D convolution, prefix scan, 2-D stencil and tree reduction; of
the WKV forward, backward and decode step or window (the variants the
reference's docstrings name: its Pallas kernels' VMEM is the fabric tier
here too) and of the sequence-parallel WKV's summary hops (the budget its
collective check holds the port to); and the serve scheduler's slot-step
accounting (:func:`serve_batch_steps`, :func:`serve_recovery_steps`, the
cost a session reports as its recovery debt, :func:`serve_fleet_drain`,
the router's placement model) and the paged serve's
(:func:`serve_paged_pool`, :func:`serve_prefix_admission`).
It is pure Python; the formulas and their order are the reference's, so
every value equals the reference's exactly.

The paper's wins come from eliminating scratchpad round-trips and redundant
global loads.  They are accounted as *bytes moved per memory tier*, the
hardware-independent quantity, and converted to energy with per-access
costs: DRAM about 160 pJ/B, scratchpad/L1 SRAM about 8 pJ/B, in-fabric
forwarding about 0.4 pJ/B (45 nm class, as the paper's GPUWattch model).
The *ratios* drive the Fig. 12 analog.
"""

from __future__ import annotations

import dataclasses
import math

__all__ = [
    "PJ_PER_BYTE",
    "Traffic",
    "KernelCost",
    "matmul_traffic",
    "conv1d_traffic",
    "scan_traffic",
    "stencil2d_traffic",
    "reduce_traffic",
    "wkv_traffic",
    "wkv_bwd_traffic",
    "wkv_decode_token_io",
    "wkv_decode_traffic",
    "wkv_seqshard_traffic",
    "serve_batch_steps",
    "serve_recovery_steps",
    "serve_fleet_drain",
    "serve_paged_pool",
    "serve_prefix_admission",
]

PJ_PER_BYTE = {
    "dram": 160.0,       # global memory
    "scratchpad": 8.0,   # shared memory / L1 SRAM
    "fabric": 0.4,       # direct producer->consumer forwarding
}


@dataclasses.dataclass
class Traffic:
    """Bytes moved per tier for one kernel execution."""

    dram_bytes: int = 0
    scratchpad_bytes: int = 0
    fabric_bytes: int = 0

    def energy_pj(self) -> float:
        return (
            self.dram_bytes * PJ_PER_BYTE["dram"]
            + self.scratchpad_bytes * PJ_PER_BYTE["scratchpad"]
            + self.fabric_bytes * PJ_PER_BYTE["fabric"]
        )

    def __add__(self, other: "Traffic") -> "Traffic":
        return Traffic(
            self.dram_bytes + other.dram_bytes,
            self.scratchpad_bytes + other.scratchpad_bytes,
            self.fabric_bytes + other.fabric_bytes,
        )


@dataclasses.dataclass(frozen=True)
class KernelCost:
    name: str
    variant: str          # "naive" | "shared" | "direct"
    traffic: Traffic
    flops: int

    @property
    def energy_pj(self) -> float:
        return self.traffic.energy_pj()

    def arithmetic_intensity(self) -> float:
        total = (
            self.traffic.dram_bytes
            + self.traffic.scratchpad_bytes
            + self.traffic.fabric_bytes
        )
        return self.flops / max(total, 1)


def matmul_traffic(n: int, k: int, m: int, itemsize: int = 4):
    """Paper §3.3: loads drop from N·K·M (naive) to N·M + K·(N+M) (direct).

    naive:  every thread loads its full row/column -> N*M*(2K) element loads.
    shared: stage A and B tiles through scratchpad; global loads (N*K + K*M),
            scratchpad write (N*K + K*M) + read 2*K per thread.
    direct: one thread per row/col issues the load (fromThreadOrMem); other
            threads receive forwarded operands through the fabric.
    """
    out_writes = n * m * itemsize
    naive = Traffic(dram_bytes=(n * m * 2 * k) * itemsize + out_writes)
    shared = Traffic(
        dram_bytes=(n * k + k * m) * itemsize + out_writes,
        scratchpad_bytes=((n * k + k * m) + n * m * 2 * k) * itemsize,
    )
    direct = Traffic(
        dram_bytes=(n * k + k * m) * itemsize + out_writes,
        fabric_bytes=(n * m * 2 * k - (n * k + k * m)) * itemsize,
    )
    flops = 2 * n * k * m
    return (
        KernelCost("matmul", "naive", naive, flops),
        KernelCost("matmul", "shared", shared, flops),
        KernelCost("matmul", "direct", direct, flops),
    )


def conv1d_traffic(n: int, taps: int = 3, itemsize: int = 4):
    """Paper Fig. 1: naive reloads each element ``taps`` times; direct loads
    once and forwards the shifted copies through elevator nodes."""
    out_writes = n * itemsize
    naive = Traffic(dram_bytes=(n * taps + taps) * itemsize + out_writes)
    shared = Traffic(
        dram_bytes=(n + taps) * itemsize + out_writes,
        scratchpad_bytes=(n + n * taps) * itemsize,
    )
    direct = Traffic(
        dram_bytes=(n + taps) * itemsize + out_writes,
        fabric_bytes=(n * (taps - 1)) * itemsize,
    )
    flops = 2 * n * taps
    return (
        KernelCost("conv1d", "naive", naive, flops),
        KernelCost("conv1d", "shared", shared, flops),
        KernelCost("conv1d", "direct", direct, flops),
    )


def scan_traffic(n: int, itemsize: int = 4):
    """Prefix sum (paper Fig. 6): the shared version re-stages partial sums
    log2(n) times (Hillis-Steele in scratchpad); direct communicates each
    partial exactly once through the fabric."""
    out_writes = n * itemsize
    steps = max(1, int(math.ceil(math.log2(max(n, 2)))))
    naive = Traffic(dram_bytes=(n + n * steps * 2) * itemsize + out_writes)
    shared = Traffic(
        dram_bytes=n * itemsize + out_writes,
        scratchpad_bytes=(2 * n * steps) * itemsize,
    )
    direct = Traffic(
        dram_bytes=n * itemsize + out_writes,
        fabric_bytes=n * itemsize,
    )
    flops = n
    return (
        KernelCost("scan", "naive", naive, flops),
        KernelCost("scan", "shared", shared, flops),
        KernelCost("scan", "direct", direct, flops),
    )


def stencil2d_traffic(h: int, w: int, pts: int = 5, itemsize: int = 4):
    """hotspot/SRAD-style 2D stencil: naive reloads each neighbor; direct
    forwards row halos through the fabric."""
    n = h * w
    out_writes = n * itemsize
    naive = Traffic(dram_bytes=n * pts * itemsize + out_writes)
    shared = Traffic(
        dram_bytes=n * itemsize + out_writes,
        scratchpad_bytes=(n + n * pts) * itemsize,
    )
    direct = Traffic(
        dram_bytes=n * itemsize + out_writes,
        fabric_bytes=n * (pts - 1) * itemsize,
    )
    flops = n * pts * 2
    return (
        KernelCost("stencil2d", "naive", naive, flops),
        KernelCost("stencil2d", "shared", shared, flops),
        KernelCost("stencil2d", "direct", direct, flops),
    )


def reduce_traffic(n: int, itemsize: int = 4):
    """Tree reduction: shared version stages each level through scratchpad;
    direct uses windowed elevator edges per level."""
    naive = Traffic(dram_bytes=(2 * n) * itemsize)
    shared = Traffic(dram_bytes=n * itemsize, scratchpad_bytes=2 * n * itemsize * 2)
    direct = Traffic(dram_bytes=n * itemsize, fabric_bytes=n * itemsize)
    flops = n
    return (
        KernelCost("reduce", "naive", naive, flops),
        KernelCost("reduce", "shared", shared, flops),
        KernelCost("reduce", "direct", direct, flops),
    )


def wkv_traffic(b: int, h: int, t: int, dh: int, chunk: int = 64,
                itemsize: int = 4):
    """RWKV6 WKV recurrence (decay-ratio chunked form), per forward pass.

    naive:  sequential scan — the (dh, dh) state round-trips through memory
            every token (the decode pattern applied to a full sequence).
    shared: the chunked jnp path — inputs load once, but the per-chunk decay
            tensors (logw, cum_incl, cum_excl, r_dec, k_inv, k_rem), the
            masked score matrix, the intra/inter partial outputs and the
            ``lax.scan`` state carry all stage through HBM (Fig. 1b).
    direct: the fused Pallas kernel — the state lives in a VMEM scratch and
            the decay tensors never leave the fabric (kernels/wkv).
    """
    n = max(1, t // chunk)
    state = dh * dh
    # Unavoidable I/O: r/k/v/w in, out + final state + h0.
    io = b * h * (4 * t * dh + t * dh + 2 * state) * itemsize
    naive = Traffic(dram_bytes=io + b * h * t * 2 * state * itemsize)
    staged = b * h * (
        6 * t * dh            # logw, cum_incl, cum_excl, r_dec, k_inv, k_rem
        + n * chunk * chunk   # masked intra-chunk scores
        + 2 * t * dh          # intra, inter partial outputs
        + 2 * n * state       # scan carry: S written + read per chunk
    ) * itemsize
    shared = Traffic(dram_bytes=io, scratchpad_bytes=2 * staged)
    direct = Traffic(dram_bytes=io, fabric_bytes=staged)
    # Scores + intra matmul + inter read + state update, 2 flops per MAC.
    flops = b * h * (
        2 * 2 * n * chunk * chunk * dh   # scores + scores @ v
        + 2 * 2 * t * dh * dh            # inter read + k^T v update
    )
    return (
        KernelCost("wkv", "naive", naive, flops),
        KernelCost("wkv", "shared", shared, flops),
        KernelCost("wkv", "direct", direct, flops),
    )


def wkv_bwd_traffic(b: int, h: int, t: int, dh: int, chunk: int = 64,
                    itemsize: int = 4):
    """RWKV6 WKV backward pass (reverse chunk sweep), per step.

    naive:  autodiff of the sequential scan — the (dh, dh) state is staged
            per token by the forward and read back, and the adjoint state
            round-trips per token.
    shared: ``jax.grad`` of the chunked jnp path — the forward's residuals
            (six decay tensors, masked scores, per-chunk scan states) are
            staged to HBM and read back, and the backward's own
            intermediates (decay/score adjoints, partial grads, the dS
            scan carry) stage the same way (Fig. 1b, twice).
    direct: the reverse Pallas kernel — decays and scores are *recomputed*
            in-fabric from the primals; the only staged residual is the
            per-chunk entry state ``s_hist`` (written by the training
            forward, read by the reverse sweep), and the adjoint state dS
            rides the VMEM carry.
    """
    n = max(1, t // chunk)
    state = dh * dh
    # Unavoidable grad I/O: primals + do + dS_out in, dr/dk/dv/dw/du/dh0 out.
    io = b * h * (9 * t * dh + dh + 2 * state) * itemsize
    naive = Traffic(dram_bytes=io + b * h * t * 4 * state * itemsize)
    resid = b * h * (
        6 * t * dh            # logw, cum_incl, cum_excl, r_dec, k_inv, k_rem
        + n * chunk * chunk   # masked scores
        + n * state           # per-chunk scan states (saved by lax.scan)
    ) * itemsize
    bwd_stage = b * h * (
        6 * t * dh            # dscores operands + decay adjoints (dcum_*)
        + n * chunk * chunk   # dscores
        + 2 * t * dh          # intra/inter partial grads
        + 2 * n * state       # dS carry: written + read per chunk
    ) * itemsize
    shared = Traffic(dram_bytes=io, scratchpad_bytes=2 * (resid + bwd_stage))
    # s_hist is direct's one staged intermediate (written fwd, read bwd) —
    # same tier as shared's residuals; everything else is recomputed
    # in-fabric.
    s_hist = b * h * 2 * n * state * itemsize
    direct = Traffic(dram_bytes=io, scratchpad_bytes=s_hist,
                     fabric_bytes=resid + bwd_stage)
    # Recomputed scores/decays + 5 chunk-local (L,L) matmuls + 5 (dh, dh)
    # state-sized matmuls per token block — ~2.5x the forward's MXU work.
    flops = b * h * (
        2 * 5 * n * chunk * chunk * dh
        + 2 * 5 * t * dh * dh
    )
    return (
        KernelCost("wkv_bwd", "naive", naive, flops),
        KernelCost("wkv_bwd", "shared", shared, flops),
        KernelCost("wkv_bwd", "direct", direct, flops),
    )


def wkv_decode_token_io(b: int, h: int, dh: int, k: int = 1,
                        itemsize: int = 4) -> int:
    """Unavoidable decode token I/O: r/k/v/w in, o out, + u once per head.
    Shared by every :func:`wkv_decode_traffic` variant — callers subtract
    it to isolate the state bytes the decode window amortizes."""
    return b * h * k * 5 * dh * itemsize + h * dh * itemsize


def wkv_decode_traffic(b: int, h: int, dh: int, k: int = 1,
                       itemsize: int = 4):
    """WKV decode: K generated tokens through one (Dh × Dh)-state layer.

    naive:  per-token dispatch — the state round-trips HBM every token
            (2·Dh² bytes/token), which dominates decode traffic since the
            token I/O is only O(Dh).  This is what the pre-decode-kernel
            serve loop paid: ``wkv_traffic``'s "naive" row restricted to
            one token, K times.
    shared: the state staged through scratchpad within a window — HBM
            sees one round-trip per window, but every intermediate state
            still crosses a memory tier per token (the GPGPU
            shared-memory rendering).
    direct: the decode window kernel (kernels/wkv/decode): one HBM read
            of S at window entry + one write at exit; the K-1
            intermediate states ride the VMEM carry (fabric tier).
            Per-token state bytes drop by ~K×.
    """
    state = dh * dh
    tok_io = wkv_decode_token_io(b, h, dh, k, itemsize)
    naive = Traffic(dram_bytes=tok_io + b * h * k * 2 * state * itemsize)
    shared = Traffic(
        dram_bytes=tok_io + b * h * 2 * state * itemsize,
        scratchpad_bytes=b * h * 2 * k * state * itemsize,
    )
    direct = Traffic(
        dram_bytes=tok_io + b * h * 2 * state * itemsize,
        fabric_bytes=b * h * 2 * max(k - 1, 0) * state * itemsize,
    )
    # Per token: state matvec read (r·S) + rank-1 update (kᵀv, decay), 2
    # flops per MAC.
    flops = b * h * k * 2 * 2 * dh * dh
    return (
        KernelCost("wkv_decode", "naive", naive, flops),
        KernelCost("wkv_decode", "shared", shared, flops),
        KernelCost("wkv_decode", "direct", direct, flops),
    )


def wkv_seqshard_traffic(b: int, h: int, t: int, dh: int, n_dev: int,
                         itemsize: int = 4):
    """Sequence-parallel WKV: bytes crossing the ``seq`` mesh axis per
    layer step (totals over all devices).

    naive:  re-gather the token activations: every device receives the
            other shards' r/k/v/w and runs the full sequence itself; the
            O(T·D) pattern sequence sharding is supposed to remove.
    shared: all-gather the per-shard exit states behind a barrier (every
            device receives all n (Dh × Dh) states, then composes
            locally): the GPGPU shared-buffer pattern across the mesh.
    direct: the segment-summary protocol (kernels/wkv/seqpar):
            ceil(log2 n) + 1 point-to-point hops, each moving the
            (decay, state) summary, dh + dh² per (batch, head), plus
            one masked psum of the final state.  O(Dh²), independent
            of T.
    """
    state = dh * dh
    summary = state + dh
    # ceil(log2 n) doubling rounds plus the final Δ=+1 boundary shift; at
    # n = 1 the scan degenerates to that single shift.
    hops = int(math.ceil(math.log2(max(n_dev, 1)))) + 1
    tokens = 4 * t * dh                               # r, k, v, w
    naive = Traffic(
        dram_bytes=b * h * (n_dev - 1) * tokens * itemsize
    )
    shared = Traffic(
        scratchpad_bytes=b * h * n_dev * (n_dev - 1) * state * itemsize
    )
    direct = Traffic(
        fabric_bytes=b * h * n_dev * (hops * summary + state) * itemsize
    )
    # Same math work on every variant: the local fused sweep dominates;
    # carry composition adds n·hops (Dh²) multiply-adds.
    flops = b * h * (2 * 2 * t * dh * dh + 2 * n_dev * hops * state)
    return (
        KernelCost("wkv_seqshard", "naive", naive, flops),
        KernelCost("wkv_seqshard", "shared", shared, flops),
        KernelCost("wkv_seqshard", "direct", direct, flops),
    )


def serve_batch_steps(new_tokens, slots: int, window: int = 1):
    """Slot-step accounting for a ragged decode workload: lockstep vs
    continuous batching (the scheduler-level rendering of the paper's
    barrier argument — model-independent, so it composes with any
    per-step cost).

    ``new_tokens``: per-request generation budgets, arrival order.
    ``slots``: batch slots.  ``window``: tokens per decode dispatch (K).

    lockstep:   requests run in arrival-order batches of ``slots``; every
                batch is padded to its longest member — a workgroup-global
                barrier: a finished request keeps burning a slot-step per
                step until the slowest one ends, and the next batch waits.
    continuous: finished slots are refilled from the queue at window
                boundaries (each admission emits the request's first
                token from its prefill, the engine contract) — the
                point-to-point hand-off: a slot's next request starts the
                moment the previous one ends.

    Returns ``(useful_tokens, lockstep_steps, continuous_steps)`` where
    the step counts are total slot-steps scanned (useful / steps is the
    utilization; lockstep / continuous is the modeled speedup at equal
    per-step cost).
    """
    new_tokens = [int(n) for n in new_tokens]
    if not new_tokens or slots < 1 or window < 1:
        raise ValueError("need >= 1 request, slots >= 1, window >= 1")
    useful = sum(new_tokens)

    lockstep = 0
    for i in range(0, len(new_tokens), slots):
        batch = new_tokens[i : i + slots]
        # Prefill emits token 1; the remaining max-1 decode in windows of
        # ``window`` steps, every slot of the batch marching together.
        win_steps = -(-(max(batch) - 1) // window) * window if max(batch) > 1 else 0
        lockstep += len(batch) * win_steps

    continuous = 0
    queue = list(new_tokens)[::-1]          # pop() = arrival order
    remaining = [0] * slots
    while queue or any(remaining):
        for s in range(slots):
            if remaining[s] == 0 and queue:
                remaining[s] = queue.pop() - 1   # admission emits token 1
        if not any(remaining):
            # Every live slot finished at admission (budget-1 requests):
            # no window to run — admit again / fall out via the loop test.
            continue
        continuous += slots * window             # one masked window dispatch
        for s in range(slots):
            remaining[s] = max(0, remaining[s] - window)
    return useful, lockstep, continuous


def serve_recovery_steps(prompt_lens, accepted, victim: int,
                         window: int = 1):
    """Positions re-processed to recover ONE faulted slot: isolated
    quarantine+re-prefill vs a batch-global restart (the robustness dual
    of the barrier argument — a fault's blast radius is one slot's
    hand-off, not a workgroup-global rollback).

    ``prompt_lens`` / ``accepted``: per-slot prompt lengths and tokens
    accepted so far; ``victim``: the faulted slot; ``window``: tokens per
    decode dispatch (K).

    isolated: one masked admission prefill replays the victim's prompt +
              accepted prefix — ``prompt_lens[victim] +
              accepted[victim]`` positions, one dispatch, neighbors
              untouched (their cost is zero by the bit-identity
              invariant).
    global:   every slot re-prefills its prompt and the whole batch
              re-decodes to the furthest accepted token in lockstep
              windows — ``sum(prompts) + slots * ceil(max(accepted)/K)*K``
              slot-steps.

    Returns ``(isolated_steps, global_steps)``; global / isolated is the
    modeled recovery-cost ratio of restart-the-world over per-slot
    recovery.
    """
    prompt_lens = [int(p) for p in prompt_lens]
    accepted = [int(a) for a in accepted]
    if len(prompt_lens) != len(accepted) or not prompt_lens:
        raise ValueError("need matching, non-empty prompt/accepted lists")
    if not 0 <= victim < len(prompt_lens) or window < 1:
        raise ValueError("victim out of range or window < 1")
    isolated = prompt_lens[victim] + accepted[victim]
    redecode = -(-max(accepted) // window) * window if max(accepted) else 0
    global_ = sum(prompt_lens) + len(prompt_lens) * redecode
    return isolated, global_


def serve_fleet_drain(work, depths, window: int = 1):
    """Makespan model for routing a burst of requests across a replica
    fleet: recovery-aware least-loaded placement vs depth-blind
    round-robin (the scheduling dual of
    :func:`serve_recovery_steps` — a replica digesting handoff
    re-prefills is *behind*, and a router that ignores that debt piles
    new work onto the busiest replica).

    ``work``: per-request modeled slot-steps (prompt + budget, the same
    unit :func:`serve_batch_steps` counts); ``depths``: per-replica
    pre-existing debt in slot-steps (queued work plus the
    :func:`serve_recovery_steps`-isolated cost of any pending handoff
    re-prefills); ``window``: tokens per decode dispatch — each
    placement is rounded up to whole dispatches.

    Returns ``(aware_steps, blind_steps)``: the drain makespan (max
    per-replica total) under greedy least-loaded placement seeded with
    ``depths``, and under round-robin placement that ignores them.
    ``blind / aware >= 1`` is the modeled win of recovery-aware routing.
    """
    work = [int(w) for w in work]
    depths = [int(d) for d in depths]
    if not depths:
        raise ValueError("need at least one replica depth")
    if window < 1 or any(w < 1 for w in work) or any(d < 0 for d in depths):
        raise ValueError("window < 1, empty work item, or negative depth")
    quant = [-(-w // window) * window for w in work]
    aware = list(depths)
    for w in quant:
        aware[aware.index(min(aware))] += w
    blind = list(depths)
    for i, w in enumerate(quant):
        blind[i % len(blind)] += w
    return max(aware), max(blind)


def serve_paged_pool(prompt_lens, new_tokens, slots: int, page_size: int,
                     window: int = 1):
    """Pages-in-flight accounting for a ragged serve workload: the paged
    pool's high-water mark vs the dense engine's static footprint (the
    statically-partitioned-scratchpad argument applied to KV storage).

    Replays the same admission schedule as :func:`serve_batch_steps`'s
    continuous branch, with the engine's allocate-all-at-admission rule:
    a request entering a slot reserves ``ceil((prompt + budget) /
    page_size)`` pages for its whole lifetime and frees them the step it
    completes.  The dense engine instead provisions every slot for the
    worst request up front — ``slots × ceil(max(prompt + budget) /
    page_size)`` pages live for the whole serve, whatever the actual
    tokens in flight.

    Returns ``(peak_pages, dense_pages)``: the pool high-water mark and
    the dense-equivalent static page count.  ``dense_pages / peak_pages``
    is the modeled capacity win — the pool size at which paged serving
    first matches dense throughput with zero admission waits.
    """
    prompt_lens = [int(p) for p in prompt_lens]
    new_tokens = [int(t) for t in new_tokens]
    if (len(prompt_lens) != len(new_tokens) or not prompt_lens
            or slots < 1 or page_size < 1 or window < 1):
        raise ValueError(
            "need matching non-empty prompts/budgets, slots >= 1, "
            "page_size >= 1, window >= 1")
    need = [-(-(p + t) // page_size) for p, t in zip(prompt_lens, new_tokens)]
    dense_pages = slots * max(need)

    queue = list(range(len(new_tokens)))[::-1]   # pop() = arrival order
    remaining = [0] * slots
    pages = [0] * slots
    peak = 0
    while queue or any(remaining):
        for s in range(slots):
            if remaining[s] == 0:
                pages[s] = 0
                if queue:
                    ri = queue.pop()
                    remaining[s] = max(new_tokens[ri] - 1, 0)
                    pages[s] = need[ri]
                    if remaining[s] == 0:        # done at admission
                        pages[s] = 0
        peak = max(peak, sum(pages))
        if not any(remaining):
            continue
        for s in range(slots):
            if remaining[s] > 0:
                remaining[s] = max(0, remaining[s] - window)
                if remaining[s] == 0:
                    pages[s] = 0
    return peak, dense_pages


def serve_prefix_admission(prefix_len: int, suffix_len: int,
                           n_requests: int, page_size: int):
    """Positions prefilled to admit ``n_requests`` sharing one prefix:
    recurrent-state prefix sharing vs cold re-prefill.

    shared: the prefix's page-aligned head (``floor(prefix_len /
            page_size) × page_size`` positions) is prefilled ONCE — its
            KV pages are shared read-only and its WKV S / RG-LRU h copied
            into each admitted slot — and each admission prefills only
            the leftover prefix tail plus its own suffix.
    cold:   every admission re-prefills prefix + suffix from position 0
            (what the dense engine does for each request).

    Returns ``(shared_positions, cold_positions)``; cold / shared is the
    modeled admission-cost ratio the ``serve_paged`` bench row checks
    against its measured admission times.
    """
    if (prefix_len < 0 or suffix_len < 1 or n_requests < 1
            or page_size < 1):
        raise ValueError(
            "need prefix_len >= 0, suffix_len >= 1, n_requests >= 1, "
            "page_size >= 1")
    aligned = (prefix_len // page_size) * page_size
    shared = aligned + n_requests * (prefix_len - aligned + suffix_len)
    cold = n_requests * (prefix_len + suffix_len)
    return shared, cold
