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
   or found it in ``build/``, and the HGMMA (wgmma), UTMALDG (TMA) and
   UBLKCP (bulk copy) instructions and every kernel's registers and spills
   of flash attention's backward library;
   fail if a count is 0 or a kernel spills (a stack frame or local memory);
1b. every kernel launch that ``repro_torch.analysis.resources`` declares
   for the ten full configs at the card's SM count (the planners' grids,
   blocks, clusters and shared memory at the main paths' shapes): each
   Python byte count (and the token shift's rows a thread) against the
   library's own C answer, and the card's blocks an SM for the
   instantiation each plan launches, from
   ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` with the plan's
   dynamic shared memory, beside the blocks an SM shared memory allows, a
   line per (kernel, arch, shape); then ``python -m repro_torch.analysis
   --strict --sms <the card's>`` over every arch in a process of its own;
   fail on an ERROR, a mismatch or 0 blocks an SM;
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
2c. the backward kernels of training against their plain versions, in f32
   with TF32 off and in bf16, with random cotangents: flash attention's
   (``flash_attention_bwd_cuda``) at (Hq, Hkv, D) = (10, 1, 256) causal
   window 2048 at T=4096, (4, 1, 256) window 1024 and causal at T=2048,
   (14, 2, 64) and (32, 8, 128) causal at T=2048, (16, 16, 64) non-causal
   at T = S = 1024 and cross at T=256 over S=1024, T=1000,
   RecurrentGemma's training microbatch (B=2, (10, 1, 256), T=1024, window
   2048), and f32 at D 96, with the training forward's log-sum-exp against
   the plain version's and its output bit for bit serving's, and in bf16
   every plan of ``flash_bwd_plans`` (each GQA cluster size) through
   ``launch_bwd_plan``, each repeating bit for bit; the
   scan's (B, T) = (4, 1024), (1, 4096) and (2, 1024) at D=2560 bit for bit
   in every plan of ``scan_bwd_plans`` (the TMA ring's two tiles, the
   loader-warp variant); the token shift's at (B, T) = (4, 4), (4, 67),
   (4, 259), (1, 4096) and (2, 1024) (dx bit for bit), in every plan of
   ``shift_bwd_plans`` through ``launch_bwd_plan`` (dw repeating bit for
   bit), and a planted fault (a cluster rank's dw partial dropped, compiled
   into a copy of the library) launched in a process of its own and
   rejected by the same check; each Function (flash attention, the scan chunked and
   as windows of 1, 8, 64, the token shift) on the card against the same
   Function on CPU copies, and the WKV decode window's grads at K in 1, 8,
   37, 64 likewise;
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
   D 128, 64, 32 (T=1000, window 256), at Gemma3's Hq 4 (T=4096, causal
   window 1024 and causal with no window), and at the decoder-only archs'
   GQA shapes over several KV heads, (Hq, Hkv, D) = (14, 2, 64) at T=4096
   and (32, 8, 128), (48, 8, 128), (28, 4, 128), (64, 4, 128) at T=2048,
   each causal with no window, as an offset decode (T=8 against S=300) and
   at T=1000, and at seamless-m4t's MHA heads (16 over 16 of 64),
   non-causal with no window: T = S = 4096 and 1000, cross-attention at
   T=1024 over S=4096, T=1 and 64 over S=1000, and T=600 over S=300;
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
3j. paged KV serving (``ServeEngine(paged=True)``) and recurrent-state
   prefix sharing: full-size gemma3-1b (bf16, max_len 1024, 4 slots, K=8)
   serves phase 3h's requests on a dense engine, a paged one and a paged
   one whose tight pool makes admissions wait, every stream equal to the
   dense one, no port kernel launched, a clean page-table audit and the
   tight pool below the dense footprint; a 512-token shared prefix (16
   pages) with 8 requests of 8-56 more tokens and 32 new, warm through the
   prefix against cold on the dense engine, on gemma3-1b (every request a
   prefix admission, 16 shared pages, admission time, tok/s and each
   request's equal prefix printed) and on full-size rwkv6-1.6b (launch
   counts held: 24 ``wkv_cuda`` for the prefix's one prefill, the decode
   window kernel a layer an admission, the decode step kernel a layer a
   step); the reduced f32 rwkv6, gemma3 and recurrentgemma paged against
   dense, warm against cold and under a NaN on the paged engine, every
   stream equal to the others and to the same run on the CPU;
3k. the replica fleet (``serve/fleet.py``), replica health and the checksum
   chain: full-size rwkv6-1.6b (bf16, phase 3's weights and requests) on
   three engines sharing one params tree, 2 slots each, K=8, a snapshot
   every window and the chain every 2, each run's WKV launch counts derived
   beforehand from the same schedule run on the CPU at reduced size and
   held exactly; (a) fault-free against one recoverable engine on 2 slots:
   0 deaths, 0 handoffs, 6 assignments, every stream admitted at the single
   engine's window length bit-identical to it (the others' equal prefixes
   printed: bf16 GEMMs of another shape), tok/s of both over alternating
   pairs, and the same weights in f32 with every stream equal; (b) the drill on replica 1, a
   bit flip before window 1 and a kill after window 2: the flip detected,
   one death, a handoff, replica 1 dead with its state dropped, clean
   outcomes, every untouched request bit-identical to (a)'s fleet, the time
   from the kill to the last handed-off request's completion; (c) the
   chain's cost: one engine's serve with the chain every 2 windows against
   off in alternating repetitions (quartiles), and a checksum's device and
   host time; then the reduced f32 rwkv6 (fault-free, kill and bit-flip
   fleets) and paged gemma3 (kill) against their single engines and the
   CPU, every stream exact, and ``run_drill`` of the reduced rwkv6 on the
   card under 2 forced schedules;
3l. the decoder-only archs, every earlier phase's weights freed, in bf16
   at full width (random weights from a seed): qwen2-0.5b at full depth
   through ``generate`` (B=4, 256-token prompts, 32 new, K=8), ``serve``
   (6 ragged requests, 4 slots, K=8) and prompt scoring at B=1, T=4096,
   with 0 / 0 / 24 flash launches, and one forward under the profiler;
   minitron-8b, nemotron-4-15b and qwen2-vl-7b at full depth, one at a
   time, scoring at B=1, T=4096 (qwen2-vl with 1024 leading patch
   embeddings and (3, B, T) M-RoPE positions) with exactly 32 / 32 / 28
   flash launches, then ``generate`` (B=4, P=64, +16, K=8) with none;
   dbrx-132b and qwen3-moe at 4 of their 40 and 94 layers, scoring at
   B=8, T=1024 through ``prefill_chunks`` (4 and 8 chunks) with exactly
   16 / 32 flash launches, twice with bit-identical logits, each MoE
   layer's capacity and dropped share printed, then ``generate``; every
   flash launch causal with no window; then the six reduced f32 models on
   the card against the CPU (logits within 1e-4; greedy generate and
   serve streams equal; for the MoE archs a parted stream allowed only at
   a router near-tie below 1e-6, its gap printed), and the serving example
   (``repro_torch.examples.serve_decode``) on the card;
3m. the encoder-decoder arch, every earlier phase's weights freed:
   full-size seamless-m4t-large-v2 in bf16 at full depth (24 encoder and
   24 decoder layers, random weights from seed 0, frames from a seeded
   generator); (a) prompt scoring (``make_prefill_step`` with the frames)
   at B=1, 4096 frames and 1024 tokens with exactly 72 flash launches: 24
   non-causal at T = S = 4096 (the encoder), 24 causal at T = 1024, 24
   cross at T = 1024 over S = 4096; the 50 padded logit columns -1e30;
   one forward under the profiler; (b) ``encode`` at B=4 and 1024 frames
   (24 launches), then greedy decoding through ``make_decode_step``: a
   64-token prompt window at length 0 and 31 single-token steps, exactly
   24 flash launches a call (768), every one cross-attention; tokens/s with
   the encoder and the prefill included, ms a step, one more step under
   the profiler, and where the teacher-forced forward's argmax equals the
   greedy stream; (c) the reduced f32 model on the card against the CPU:
   forward logits within 1e-4 and greedy decode tokens equal;
3n. training every arch, every earlier phase's weights freed: full-size
   gemma3-1b (B=8, T=2048: its 1024-window local layers mask) and
   recurrentgemma-2b (B=8, T=1024) in bf16 with each config's microbatch
   and full remat, random weights from seed 0, 4 steps each: finite losses
   and parameters, the last loss below the first, every kernel's launch
   count (flash attention, the token shift and the scan, forward and
   backward) set to 0 before and held after to the count the step's
   structure gives (the scanned periods' forward twice under full remat,
   the remainder once), peak memory, step time and train tokens/s, one
   step under the profiler; then one step of each of the ten reduced f32
   archs on the card against the CPU (loss, grad norm, updated
   parameters), and ``repro_torch.examples.train_lm`` on the card for 4
   steps at its default width (f32 heads of 96);
3o. the one-card dry run (``repro_torch.launch.dryrun``) held against the
   card: (a) the dry run of every decode_32k and long_500k cell (the train
   and prefill cells fit no card and their traces take minutes: the CLI
   runs them), each cell's row printed; (b) every cell it marks as fitting
   one card (decode_32k of rwkv6-1.6b, recurrentgemma-2b, gemma3-1b and
   qwen2-0.5b, long_500k of the three sub-quadratic archs; any other set
   fails) built on the card at full width through ``dryrun.make_cell``
   from seed 0: the rise of the allocator's requested bytes equal to the
   dry run's state bytes, exactly, and of ``torch.cuda.memory_allocated()``
   at least their sum rounded to the allocator's 512 B a tensor, at most
   0.5% above it (the allocator's unsplit block tails); one
   ``make_decode_step`` call's launch counters equal to the recorded
   launches, exactly; ``FlopCounterMode``'s aten FLOPs equal to the
   traced aten FLOPs, exactly; ``max_memory_allocated()`` over the state
   within 5% or 256 MiB (the larger) of the traced peak of live bytes;
   finite logits; then 5 steps timed with CUDA events after a warm-up,
   printed beside the roofline bound, the memory terms' share of the step
   and ``model_flops`` over the time over 989 TFLOP/s, and one more step
   under the profiler (the card's busy and idle shares, the kernels with
   the most device time, the copies' and fills' share); (c) the meta trace
   of phase 3h's Gemma3-1B scoring (B=1, T=4096) and phase 3b's RWKV6
   train step (B=8, T=256) held to those phases' counts on the card in
   this run: 22 windowed + 4 causal flash launches; 96 ``wkv_train_cuda``
   and 48 ``wkv_bwd_cuda`` a step;
3p. expert parallelism on the one card: full-width dbrx-132b (B=8) and
   qwen3-moe (B=16: two sequences in each of its 8 prefill chunks),
   T=1024, ``MOE_DEPTH`` layers, bf16, scored through
   ``make_prefill_step`` with ``moe_impl="a2a"`` under the ``prefill``
   rules of a (data=2, model=4) mesh of the card and on the gather path:
   at a capacity factor of E / k nothing drops on either path; on the
   a2a's own inputs of each MoE call its expert sets are
   ``_topk_routing``'s (but at f32 router near-ties) and its outputs the
   gather path's within an ulp and 2**-6 of the token's output RMS; every
   token the two scorings route otherwise is a router near-tie within
   twice the drift of its router logits, and the positions before their
   sequence's first such token agree within 2**-3 of their logits' RMS
   (the rest and the argmax agreement printed); at the configs' 1.25 each
   path's dropped share, two a2a runs bit-identical; the exchanges (2 a
   layer and a chunk, each logged once a data row) and the elements
   leaving each shard equal their closed form; flash launches one a layer
   and a chunk on both paths; the wall time of each path and a profiled
   scoring of each (device time, busy share); then the reduced f32 dbrx
   and qwen3-moe through the a2a on a (2, 4) mesh of the card against one
   of "cpu" shards (forward logits, one ``make_train_step`` step under the
   ``train`` rules: loss, grad norm, gradient leaves, parameters, the
   exchanges), and the ``collectives`` pass over a seq mesh of 4 shards of
   the card (the sequence-parallel WKV forward and backward there, clean);
3f. the paper demo: the 5-point stencil against its plain version in f32
   (bit for bit) and bf16 (hotspot and SRAD coefficients on the suite's
   256 x 512 grid, boundary 5.0 at 64 x 128, the odd 257 x 383, and 8192 x
   8192), every rows-a-thread plan bit for bit the planner's, and the
   operand-forwarding matmul (the suite's 256^3, the
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
   stencil in every rows-a-thread plan, the
   matmul at 256^3 bf16 and 4096^3; flash attention also causal with no
   window at T=4096 against SDPA with ``is_causal=True``, whose backend is
   printed, and at Gemma3's two shapes (Hq 4, T=4096: window 1024 beside
   SDPA with the same mask and GQA, causal beside SDPA ``is_causal`` on K/V
   repeated to 4 heads) with their launches a forward, and at the
   decoder-only archs' scoring shapes (causal with no window, B=1:
   qwen2-0.5b, minitron-8b, nemotron-4-15b and qwen2-vl-7b at T=4096,
   qwen3-moe at its chunk's T=1024) beside SDPA is_causal with enable_gqa
   and on K/V repeated, each with its backend, and at seamless-m4t's three
   shapes (rows 11i-11k: the encoder at B=1, T = S = 4096; cross-attention
   at scoring, T=1024 over S=4096; in decoding, B=4, T=1 over S=1024),
   non-causal beside SDPA with no mask, each with its backend and its
   bound printed from its FLOP and byte counts; the WKV rows with
   their time per chunk, every column tile of the chunked forward and every
   cluster size of the backward at the training shape and at a seq shard,
   and a backward row at the seq gradient's shard; the decode rows with
   every column tile, the window at K in 1, 8, 32, 64 and B in 1, 4 with
   every column tile, and an empty kernel's time as the launch floor; the
   token shift at (B, T) = (1, 4096), (4, 4) and (4, 259); the elevator
   scan at (B, T) = (1, 4096) and (4, 256) in every plan; the elevator
   window at K in 1, 8, 32, 64 and B in 1, 4 in every plan, beside the
   launch floor plus its bytes bound; the three backward kernels: flash
   attention's at Gemma3's training shape (B=4, Hq 4 over 1 of 256,
   T=2048; causal with every plan timed, and window 1024 under "large") and
   RecurrentGemma's (B=2, Hq 10 over 1, T=1024, window 2048, under
   "large") beside SDPA's backward alone (the grad of a kept graph, its
   backend printed), the scan's at (1, 4096, 2560) and (2, 1024, 2560)
   (under "large") f32 in every plan, the token shift's at (1, 4096, 2560) and
   (2, 1024, 2560) (under "large") bf16 in every plan beside
   ``conv1d_input`` plus ``conv1d_weight``), printed as one ``{"kernels":
   [...]}`` line after the script's wall time;
   then the card's name and power limit, and the result line.
"""

from __future__ import annotations

import atexit
import dataclasses
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
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

    t_start = time.perf_counter()
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
    shift_fault = _start_shift_fault_build(common)
    for name, (sec, report) in common.BUILD_REPORT.items():
        lines = [ln.strip() for ln in report.splitlines()
                 if "registers" in ln or "spill" in ln or "error" in ln]
        print(f"[build] {name}: {sec:.2f}s " + " | ".join(lines))
    _hopper_report(common)

    # ---- 1b. every launch's geometry and shared memory against the card -----
    _launch_resources(torch, common)

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

    # ---- 2c. the backward kernels against their plain versions -------------
    worst.update(_grad_kernel_checks(torch, common, shift_fault))

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

    # ---- 3j. paged KV serving and prefix sharing ----------------------------
    for name, n in _paged_serving(torch, np, g3_params).items():
        launches[name] = launches.get(name, 0) + n
    del g3_params
    torch.cuda.empty_cache()

    # ---- 3k. the replica fleet, the checksum chain, the interleaving drill --
    for name, n in _fleet_serving(torch, np).items():
        launches[name] = launches.get(name, 0) + n

    # ---- 3l. the decoder-only archs: dense, relu2, M-RoPE and MoE ----------
    _free(torch, "phase 3l")
    arch_flash, arch_per_forward = _decoder_archs(torch, np)
    launches["flash_attention_cuda"] += arch_flash

    # ---- 3m. the encoder-decoder arch: encoder, cross-attention, decoding ---
    _free(torch, "phase 3m")
    t0 = time.perf_counter()
    sm_flash, sm_rows = _seamless_path(torch, np)
    launches["flash_attention_cuda"] += sm_flash
    _seamless_reference_check(torch, np)
    print(f"[time] phase 3m wall: {time.perf_counter() - t0:.1f}s")

    # ---- 3n. training every arch: gemma3-1b and recurrentgemma-2b at full
    # size, every reduced arch card vs CPU, the train_lm example -----------
    for name, n in _train_archs(torch).items():
        launches[name] = launches.get(name, 0) + n

    # ---- 3o. the one-card dry run held against the card ------------------
    _free(torch, "phase 3o")
    _dry_run_holds(torch, g3_split, train_launches, train_steps=6)

    # ---- 3p. expert parallelism on a (data, model) mesh, the collectives pass
    _free(torch, "phase 3p")
    _moe_a2a(torch, np)

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
    flash_row = next(r for r in rows if r["name"] == "flash_attention_cuda")
    flash_row["large"] += [
        {k: r[k] for k in ("shape", "launches", "ms", "call_ms", "plain_ms", "bound_ms",
                           "bound_by", "library_ms", "backend", "library_repeat_ms",
                           "backend_repeat")}
        for r in _time_arch_attention(torch, worst["flash_attention_cuda"], arch_per_forward)]
    flash_row["large"] += _time_seamless_attention(torch, worst["flash_attention_cuda"], sm_rows)
    rows += _time_paper_kernels(torch, launches, worst)
    # At the suite's 256 x 512 the stencil moves 1 MB: the launch floor, not
    # its bytes, is the least time it could take (PERF.md row 13).
    next(r for r in rows if r["name"] == "stencil2d_cuda")["launch_floor_ms"] = floor_ms
    rows += _time_grad_kernels(torch, launches, worst)

    print(f"[time] chip_smoke wall: {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": rows}))
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev_name, "count": torch.cuda.device_count()}}))


def _launch_resources(torch, common):
    """Phase 1b.  The resources pass over all ten full configs at the card's
    SM count; for every launch it declares, each Python byte count (and the
    token shift's rows a thread) against the library's own C answer, and the
    blocks an SM the card reports for the instantiation the plan launches
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` through the library's
    ``<library>_occupancy`` query, with the plan's dynamic shared memory)
    beside the blocks an SM shared memory allows.  One line per (kernel,
    arch, shape).  Then ``python -m repro_torch.analysis --strict`` over
    every arch in a process of its own.  Fails on any ERROR, any mismatch,
    or a launch the card fits no block of."""
    from repro_torch.analysis import resources
    from repro_torch.analysis.findings import Severity, format_table
    from repro_torch.configs.registry import get_config, list_archs

    t0 = time.perf_counter()
    sms = common.sm_count(torch.device("cuda", 0))
    archs = [get_config(a).name for a in list_archs()]
    card = {}
    n = 0
    for arch in archs:
        cfg = get_config(arch)
        findings = resources.run(cfg, sms=sms)
        bad = [f for f in findings if f.severity >= Severity.ERROR]
        if bad:
            raise SystemExit("resources pass failed:\n" + format_table(bad, title=arch))
        for launch in resources.launches(cfg, sms):
            lib = common.load_library(launch.library)
            for entry, args, want in launch.queries:
                got = getattr(lib, entry)(*args)
                if got != want:
                    raise SystemExit(f"{launch.kernel} [{arch} {launch.shape}]: {entry}{args} "
                                     f"= {got}, the Python mirror says {want}")
            key = (launch.library, launch.occupancy)
            if key not in card:
                args = tuple(launch.occupancy) + (0,) * (6 - len(launch.occupancy))
                card[key] = getattr(lib, common.occupancy_entry(launch.library))(*args)
            n += 1
            print(f"[resources] {launch.kernel:26s} {arch:22s} {launch.shape:26s} "
                  f"grid {str(launch.grid):15s} x {launch.threads:3d}"
                  + (f" cluster {launch.cluster_size}" if launch.cluster_size > 1 else "")
                  + f" smem {launch.dynamic_smem:6d} of {common.SMEM_LIMIT} B; blocks/SM: "
                  f"{launch.smem_blocks_per_sm()} by smem, {card[key]} by the card")
            if card[key] < 1:
                raise SystemExit(f"{launch.kernel} [{arch} {launch.shape}]: the card fits "
                                 f"{card[key]} blocks an SM (a negative number is a cudaError)")
    cmd = [sys.executable, "-m", "repro_torch.analysis", "--strict", "--sms", str(sms)]
    for arch in archs:
        cmd += ["--arch", arch]
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    res = subprocess.run(cmd, capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    print(f"[resources] python -m repro_torch.analysis --strict --sms {sms} over "
          f"{len(archs)} archs: exit {res.returncode} ({len(res.stdout.splitlines())} lines)")
    if res.returncode != 0:
        raise SystemExit("the analysis CLI failed:\n" + res.stdout[-4000:] + res.stderr[-4000:])
    print(f"[resources] {n} launches of {len(archs)} archs, {len(card)} instantiations "
          f"queried, in {time.perf_counter() - t0:.1f}s")


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
                               *((n, k, ops) for n, (k, ops) in SCAN_LIBRARIES.items()),
                               *((n, k, ops) for n, (k, ops) in BWD_LIBRARIES.items())):
        path = common._lib_path(name)
        sass = dump("--dump-sass", path)
        counts = {op: sum(op in ln for ln in sass.splitlines())
                  for op in ("HGMMA", "HMMA", "UTMALDG", "UTMASTG", "UBLKCP")}
        kernels = {k: v for k, v in _resource_usage(dump("--dump-resource-usage", path)).items()
                   if marker in k}
        print(f"[build] {name}: SASS HGMMA {counts['HGMMA']}, HMMA {counts['HMMA']}, UTMALDG "
              f"{counts['UTMALDG']}, UTMASTG {counts['UTMASTG']}, UBLKCP {counts['UBLKCP']}")
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
                    "token_shift": ("token_shift_", ())}
#: The RG-LRU scan library redesigned after them: every kernel of it (the
#: marker matches the scan's and the window's), and the TMA loads (UTMALDG)
#: of the scan's ring and the staged window phase 1 must find.
SCAN_LIBRARIES = {"elevator_scan": ("elevator_", ("UTMALDG",))}
#: The backward kernels' library (flash attention's) and what phase 1 must
#: find in it: wgmma products (HGMMA), TMA loads (UTMALDG) and the ring's
#: bulk copies of the lse and delta rows (UBLKCP); the token shift's and
#: the scan's backward kernels are read with their forwards' libraries
#: above (the markers match every kernel there).
BWD_LIBRARIES = {"flash_attention_bwd": ("flash_bwd_", ("HGMMA", "UTMALDG", "UBLKCP"))}
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
           ST.stencil2d_cuda, FA.flash_attention_bwd_cuda, EK.elevator_scan_bwd_cuda,
           TS.token_shift_bwd_cuda)
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


def _attn_inputs(torch, b, t, s, dtype, seed, d=RG_DH, hq=RG_HQ, hkv=RG_HKV):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, hq, t, d), generator=g, device="cuda")
    k = torch.randn((b, hkv, s, d), generator=g, device="cuda")
    v = torch.randn((b, hkv, s, d), generator=g, device="cuda")
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
#: The decoder-only archs' flash shapes (phase 3l): (Hq, Hkv, D, T) of
#: qwen2-0.5b, minitron-8b, nemotron-4-15b (and dbrx-132b), qwen2-vl-7b and
#: qwen3-moe, GQA over several KV heads.
ARCH_HEADS = {
    "qwen2-0.5b": (14, 2, 64, 4096),
    "minitron-8b": (32, 8, 128, 2048),
    "nemotron-4-15b": (48, 8, 128, 2048),
    "qwen2-vl-7b": (28, 4, 128, 2048),
    "qwen3-moe-235b-a22b": (64, 4, 128, 2048),
}
#: Each checked causal with no window over the whole T, as an offset decode
#: window (T=8 against S=300) and at a T that is not a block multiple.
ARCH_ATTN_CASES = tuple(
    (hq, hkv, tt, ss, True, None, d)
    for hq, hkv, d, t in ARCH_HEADS.values()
    for tt, ss in ((t, t), (8, 300), (1000, 1000)))
#: seamless-m4t-large-v2's flash shapes (phase 3m), MHA (16 query heads over
#: 16 KV heads of 64), as (B, T, S, causal): its encoder at 4096 and 1000
#: frames and at phase 3m's decoding batch (B=4, 1024 frames), the
#: decoder's causal self-attention at scoring (1024 tokens), cross-attention
#: at scoring (1024 tokens over 4096 frames), in decoding (1 and 64 tokens
#: over 1000 frames, and at B=4 over 1024) and with more queries than keys
#: (600 over 300).
SM_HQ, SM_DH = 16, 64
SM_ATTN_CASES = tuple(
    (b, SM_HQ, SM_HQ, t, s, causal, None, SM_DH)
    for b, t, s, causal in ((1, 4096, 4096, False), (1, 1000, 1000, False),
                            (4, 1024, 1024, False), (1, 1024, 1024, True),
                            (1, 1024, 4096, False), (1, 1, 1000, False), (1, 64, 1000, False),
                            (4, 1, 1024, False), (4, 64, 1024, False), (1, 600, 300, False)))


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
            cases = ([(1, RG_HQ, RG_HKV) + c for c in ATTN_CASES]
                     + [(1, G3_HQ, RG_HKV) + c for c in G3_ATTN_CASES]
                     + [(1,) + c for c in ARCH_ATTN_CASES] + list(SM_ATTN_CASES))
            for b, hq, hkv, t, s, causal, window, d in cases:
                q, k, v = _attn_inputs(torch, b, t, s, dtype, seed=t + s, d=d, hq=hq, hkv=hkv)
                got = FA.flash_attention_cuda(q, k, v, causal=causal, window=window)
                torch.cuda.synchronize()
                case = (f"B={b} " if b != 1 else "") + (
                    f"T={t} S={s} {'causal' if causal else 'full'} W={window}") + (
                    f" D={d}" if d != RG_DH else "") + (f" Hq={hq}" if hq != RG_HQ else "") + (
                    f" Hkv={hkv}" if hkv != RG_HKV else "")
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


# ---------------------------------------------------------------------------
# Paged KV serving and recurrent-state prefix sharing (phase 3j).
# ---------------------------------------------------------------------------

#: Phase 3j's shared-prefix workload: a 512-token prefix (16 pages of 32),
#: 8 requests extending it by 8-56 tokens, 32 new tokens each.
PREFIX_LEN, PREFIX_REQS, PREFIX_NEW = 512, 8, 32


def _prefix_requests(np, vocab, pid=None, new=PREFIX_NEW):
    """(prefix, requests): the shared-prefix workload, each request carrying
    ``pid`` (None: the same prompts admitted cold) and ``new`` tokens."""
    from repro_torch.serve.engine import Request

    rng = np.random.default_rng(21)
    prefix = rng.integers(0, vocab, PREFIX_LEN)
    sfx = [rng.integers(0, vocab, int(n)) for n in rng.integers(8, 57, PREFIX_REQS)]
    return prefix, [Request(tokens=np.concatenate([prefix, s]), max_new_tokens=new,
                            prefix_id=pid) for s in sfx]


def _timed_serve(torch, counters, engine, reqs, **kw):
    """``engine.serve`` with launch counts (as :func:`_counted`) and the
    wall time of its admission and window dispatches, read by the engine's
    dispatch hook: each dispatch ends in its host copy, so pre to post
    covers its device work.  Returns (results, seconds, launches,
    {"admit": s, "window": s})."""
    from repro_torch.serve import engine as E

    spent = {"admit": 0.0, "window": 0.0}
    began = {}

    def hook(phase, kind):
        if phase == "pre":
            began[kind] = time.perf_counter()
        else:
            spent[kind] += time.perf_counter() - began.pop(kind)

    E.dispatch_hook = hook
    try:
        with torch.inference_mode():
            outs, dt, got = _counted(torch, counters, lambda: engine.serve(reqs, **kw))
    finally:
        E.dispatch_hook = None
    return outs, dt, got, spent


def _hold_streams(np, what, want, got):
    diff = _victims(np, want, got)
    if diff or [r.outcome for r in want] != [r.outcome for r in got]:
        raise SystemExit(f"paged: {what} differs (index, equal prefix): {diff}")


def _paged_serving(torch, np, g3_params, k_w=8, slots=4, max_len=1024):
    """Phase 3j: paged KV serving and recurrent-state prefix sharing.

    (a) Full-size gemma3-1b (bf16) serves phase 3h's 6 ragged requests on
    a dense engine, a paged one with the dense-equivalent pool and a paged
    one with 4 private pages a pool (admissions wait): every stream equal
    to the dense one, no port kernel launched (serving attends in plain
    PyTorch), a clean page-table audit, the tight pool below the dense
    footprint.  (b) The shared-prefix workload on gemma3-1b, warm through
    a registered prefix on the paged engine and cold on the dense one:
    every request a prefix admission, 16 shared pages, a clean audit; the
    admission time and tok/s of both beside the positions
    ``serve_prefix_admission`` models, and each request's equal prefix
    warm against cold (bf16 GEMMs of other shapes: reported, not held).
    (c) The same workload on full-size rwkv6-1.6b, launch counts held to
    the code's structure: warm, 24 ``wkv_cuda`` for the prefix's one
    prefill, the decode window kernel a layer an admission, the decode
    step kernel a layer a step; cold, ``wkv_cuda`` a layer an admission;
    then the same weights' f32 copy warm against cold, its equal prefixes
    printed (the bf16 streams part where the chunked kernel and the window
    kernel sum in other orders).  For both archs the admissions alone (the
    workload with one new token, so no decode window) run under the
    profiler, warm and cold.  (d) The reduced f32 models on the card: paged against dense, warm
    against cold and a NaN quarantine on the paged engine, every stream
    equal to the others and to the same run on the CPU.  Returns the
    launch counts of the counted rwkv6 serves."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core import cost_model
    from repro_torch.model import model as M
    from repro_torch.serve.chaos import ChaosInjector
    from repro_torch.serve.engine import Request, ServeEngine

    counters = _counters()
    none = dict.fromkeys(counters, 0)

    def check_paged(what, eng):
        pg, st = eng.last_paged_stats, eng.last_serve_stats
        print(f"[paged] {what}: {pg}; admissions {st['admissions']}, windows "
              f"{st['decode_dispatches']}, page_waits {st['page_waits']}, "
              f"prefix_admissions {st['prefix_admissions']}")
        if pg["page_table_violations"]:
            raise SystemExit(f"paged: {what}: {pg['page_table_violations']} page-table "
                             "violations")

    # (a) gemma3-1b: dense, paged, tight paged.
    cfg = get_config("gemma3-1b")
    reqs = _g3_requests(np.random.default_rng(0), cfg.vocab_size)
    engines = {
        "dense": ServeEngine(cfg, g3_params, max_len=max_len, decode_window=k_w),
        "paged": ServeEngine(cfg, g3_params, max_len=max_len, decode_window=k_w, paged=True),
        "tight": ServeEngine(cfg, g3_params, max_len=max_len, decode_window=k_w, paged=True,
                             pool_pages=4),
    }
    runs = {}
    for name, eng in engines.items():
        with torch.inference_mode():
            eng.serve(reqs[:1], slots=slots)                  # warm-up
        outs, dt, got, spent = _timed_serve(torch, counters, eng, reqs, slots=slots)
        runs[name] = outs
        emitted = sum(r.size for r in outs)
        print(f"[paged] gemma3 {name} serve 6 requests, {slots} slots, K={k_w}, max_len "
              f"{max_len}: {emitted} tokens in {dt:.3f}s, {emitted / dt:.1f} tok/s "
              f"(admissions {spent['admit']:.3f}s, windows {spent['window']:.3f}s); "
              f"{sum(got.values())} port launches")
        if got != none:
            raise SystemExit(f"paged: gemma3 {name} serve launched {got}")
        if name != "dense":
            check_paged(f"gemma3 {name}", eng)
            _hold_streams(np, f"gemma3 {name} against dense", runs["dense"], outs)
    tight = engines["tight"]
    if tight.last_serve_stats["page_waits"] < 1:
        raise SystemExit("paged: the tight pool never made an admission wait")
    pg = tight.last_paged_stats
    if pg["pool_bytes"] >= pg["dense_bytes"]:
        raise SystemExit(f"paged: tight pool {pg['pool_bytes']} B >= dense {pg['dense_bytes']} B")
    print(f"[paged] gemma3 every stream of paged and tight equals dense; tight pool "
          f"{pg['pool_bytes']} B against {pg['dense_bytes']} B dense "
          f"({pg['pool_bytes'] / pg['dense_bytes']:.4f}), peak mapped "
          f"{pg['peak_mapped_bytes']} B")
    del engines["tight"]

    def prefix_runs(arch, warm_eng, cold_eng, derive):
        """Warm and cold serves of the prefix workload: held counts and
        equal prefixes; returns the warm and cold launch counts."""
        vocab = warm_eng.cfg.vocab_size
        prefix, cold = _prefix_requests(np, vocab)
        pid = warm_eng.register_prefix(prefix)
        _, warm = _prefix_requests(np, vocab, pid)
        sfx = [r.tokens.size - PREFIX_LEN for r in warm]
        shared_pos, cold_pos = cost_model.serve_prefix_admission(
            PREFIX_LEN, round(sum(sfx) / len(sfx)), PREFIX_REQS, 32)
        res = {}
        for name, eng, rs in (("warm", warm_eng, warm), ("cold", cold_eng, cold)):
            outs, dt, got, spent = _timed_serve(torch, counters, eng, rs, slots=slots)
            st = eng.last_serve_stats
            want = {**none, **derive(name, st)}
            emitted = sum(r.size for r in outs)
            print(f"[paged] {arch} {name} prefix serve ({PREFIX_REQS} requests, prefix "
                  f"{PREFIX_LEN}, suffixes {sfx}, +{PREFIX_NEW}): {emitted} tokens in "
                  f"{dt:.3f}s, {emitted / dt:.1f} tok/s; admissions {st['admissions']} in "
                  f"{spent['admit']:.3f}s, windows {st['decode_dispatches']} in "
                  f"{spent['window']:.3f}s, the rest (the prefix's prefill, set-up) "
                  f"{dt - spent['admit'] - spent['window']:.3f}s; launches "
                  f"{ {n: c for n, c in got.items() if c} }, derived "
                  f"{ {n: c for n, c in want.items() if c} }")
            if got != want:
                raise SystemExit(f"paged: {arch} {name} launches {got} != derived {want}")
            if any(r.outcome != "ok" or r.size != PREFIX_NEW for r in outs):
                raise SystemExit(f"paged: {arch} {name}: {[r.outcome for r in outs]}")
            res[name] = (outs, got, spent["admit"], dt)
        check_paged(f"{arch} warm", warm_eng)
        st, pg = warm_eng.last_serve_stats, warm_eng.last_paged_stats
        if st["prefix_admissions"] != PREFIX_REQS or pg["shared_pages"] < PREFIX_LEN // 32:
            raise SystemExit(f"paged: {arch} warm: {st['prefix_admissions']} prefix "
                             f"admissions, {pg['shared_pages']} shared pages")
        eq = [_shared_prefix(np, a, b) for a, b in zip(res["warm"][0], res["cold"][0])]
        print(f"[paged] {arch} admission time warm {res['warm'][2]:.3f}s against cold "
              f"{res['cold'][2]:.3f}s (x{res['cold'][2] / res['warm'][2]:.2f}); modeled "
              f"prefilled positions (serve_prefix_admission, mean suffix) shared "
              f"{shared_pos} against cold {cold_pos} (x{cold_pos / shared_pos:.2f}); equal "
              f"prefix warm against cold, per request (of {PREFIX_NEW}): {eq}")
        # The admissions alone: one new token each, so no decode window (the
        # prefix's entry is cached from the warm run above).
        for name, eng, p in (("warm", warm_eng, pid), ("cold", cold_eng, None)):
            rs = _prefix_requests(np, vocab, p, new=1)[1]
            with torch.inference_mode():
                _profile(torch, lambda: eng.serve(rs, slots=slots),
                         f"{arch} {name} admissions only ({PREFIX_REQS} requests, +1)", top=5)
        return res["warm"][1], res["cold"][1]

    # (b) gemma3-1b shared prefix: no port kernel either way.
    prefix_runs("gemma3", engines["paged"], engines["dense"], lambda name, st: {})
    del engines
    torch.cuda.empty_cache()

    # (c) rwkv6-1.6b shared prefix.
    cfg = get_config("rwkv6-1.6b")
    layers = cfg.num_layers
    params = M.init_params(cfg, seed=0, device="cuda")
    warm_eng = ServeEngine(cfg, params, max_len=max_len, decode_window=k_w, paged=True)
    cold_eng = ServeEngine(cfg, params, max_len=max_len, decode_window=k_w)
    with torch.inference_mode():
        for eng in (warm_eng, cold_eng):
            eng.serve(_g3_requests(np.random.default_rng(0), cfg.vocab_size)[:1], slots=slots)

    def rwkv_derived(name, st):
        steps = layers * k_w * st["decode_dispatches"]
        if name == "warm":        # one 512-token prefill; suffix windows <= 64 tokens
            return {"wkv_cuda": layers, "wkv_decode_window_cuda": layers * st["admissions"],
                    "wkv_decode_cuda": steps}
        return {"wkv_cuda": layers * st["admissions"], "wkv_decode_cuda": steps}

    warm_got, cold_got = prefix_runs("rwkv6", warm_eng, cold_eng, rwkv_derived)
    total = {n: warm_got[n] + cold_got[n] for n in counters}
    del warm_eng, cold_eng, params
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = M.init_params(cfg32, seed=0, device="cuda")
    warm_eng = ServeEngine(cfg32, params, max_len=max_len, decode_window=k_w, paged=True)
    prefix, cold = _prefix_requests(np, cfg32.vocab_size)
    _, warm = _prefix_requests(np, cfg32.vocab_size, warm_eng.register_prefix(prefix))
    with torch.inference_mode():
        outs = warm_eng.serve(warm, slots=slots)
        ref = ServeEngine(cfg32, params, max_len=max_len, decode_window=k_w).serve(
            cold, slots=slots)
    print(f"[paged] rwkv6 f32 (the same weights, TF32 off): equal prefix warm against "
          f"cold, per request (of {PREFIX_NEW}): "
          f"{[_shared_prefix(np, a, b) for a, b in zip(outs, ref)]}")
    del warm_eng, params
    torch.cuda.empty_cache()

    # (d) the reduced f32 models: card against CPU.
    spec = [(5, 9), (12, 3), (7, 14), (3, 6), (9, 11)]
    for arch in ("rwkv6-1.6b", "gemma3-1b", "recurrentgemma-2b"):
        cfg = get_config(arch).reduced()
        p_cpu = M.init_params(cfg, seed=0, device="cpu")
        rng = np.random.default_rng(0)
        reqs = [Request(tokens=rng.integers(0, cfg.vocab_size, (pl,)), max_new_tokens=nn)
                for pl, nn in spec]
        rng = np.random.default_rng(1)
        prefix = rng.integers(0, cfg.vocab_size, 40)
        prompts = [np.concatenate([prefix, rng.integers(0, cfg.vocab_size, k)])
                   for k in (5, 9, 3, 7)]
        streams = {}
        for dev, params in (("cuda", _to(p_cpu, "cuda")), ("cpu", p_cpu)):
            dense = ServeEngine(cfg, params, max_len=96, decode_window=4, device=dev)
            paged = ServeEngine(cfg, params, max_len=96, decode_window=4, device=dev,
                                paged=True)
            pid = paged.register_prefix(prefix)
            out = {"dense": dense.serve(reqs, slots=2), "paged": paged.serve(reqs, slots=2),
                   "cold": dense.serve([Request(tokens=p, max_new_tokens=8)
                                        for p in prompts], slots=2),
                   "warm": paged.serve([Request(tokens=p, max_new_tokens=8, prefix_id=pid)
                                        for p in prompts], slots=2)}
            if paged.last_serve_stats["prefix_admissions"] != len(prompts):
                raise SystemExit(f"paged: reduced {arch} on {dev}: prefix admissions "
                                 f"{paged.last_serve_stats['prefix_admissions']}")
            out["chaos"] = paged.serve(reqs, slots=2,
                                       chaos=ChaosInjector(seed=1, nan_at=(1,)))
            if paged.last_serve_stats["quarantines"] < 1:
                raise SystemExit(f"paged: reduced {arch} on {dev}: no quarantine")
            check_paged(f"reduced {arch} on {dev} (NaN drill)", paged)
            streams[dev] = out
        card = streams["cuda"]
        _hold_streams(np, f"reduced {arch} paged against dense", card["dense"], card["paged"])
        _hold_streams(np, f"reduced {arch} warm against cold", card["cold"], card["warm"])
        for a, b in zip(card["paged"], card["chaos"]):
            if not np.array_equal(np.asarray(a), np.asarray(b)):
                raise SystemExit(f"paged: reduced {arch} NaN drill diverged")
        for name in card:
            if any(not np.array_equal(np.asarray(a), np.asarray(b))
                   for a, b in zip(card[name], streams["cpu"][name])):
                raise SystemExit(f"paged: reduced {arch} {name}: card and CPU differ")
        print(f"[paged] reduced f32 {arch} on the card: paged = dense, warm = cold, the "
              f"NaN drill's streams = fault-free, each equal to the CPU's run: True")
    return total


# ---------------------------------------------------------------------------
# The replica fleet, the checksum chain and the interleaving drill (phase 3k).
# ---------------------------------------------------------------------------

#: Phase 3k's drill on replica 1: a bit flip before window 1, a kill after
#: window 2 (at K=8 replica 1 has finished its two requests by window 3).
FLEET_FLIP_AT, FLEET_KILL_AT = 1, 2


def _fleet_drill_chaos(replicas):
    from repro_torch.serve.chaos import ChaosInjector

    chaos = [None] * replicas
    chaos[1] = ChaosInjector(seed=0, bitflip_at=(FLEET_FLIP_AT,),
                             replica_kill_at=(FLEET_KILL_AT,))
    return chaos


def _fleet_run(torch, engines, reqs, root, *, chaos=None, slots=2, **kw):
    """A ``FleetRouter`` over ``engines`` driven round by round (its
    ``run``, with each request's completion time recorded), snapshots every
    window under ``root``, the chain every 2 windows.  Returns (router,
    results, seconds, {request: completion time}, [(kill time, handed-off
    requests)])."""
    from repro_torch.serve.fleet import FleetRouter

    fl = FleetRouter(engines, reqs, slots=slots, snapshot_every=1, snapshot_root=root,
                     checksum_every=2, chaos=chaos, **kw)
    deaths, done_at = [], {}
    real = fl._handoff

    def handoff(victim, reason):
        t = time.perf_counter()
        mine = [ri for ri in range(fl.n) if fl.assigned[ri] == victim]
        real(victim, reason)
        deaths.append((t, [ri for ri in mine if fl.assigned[ri] == -1]))

    fl._handoff = handoff
    t0 = time.perf_counter()
    try:
        while not fl.done:
            fl.step_round()
            now = time.perf_counter()
            for ri, r in enumerate(fl.record):
                if r is not None and ri not in done_at:
                    done_at[ri] = now
            if fl.stats["rounds"] > 64:
                raise SystemExit("fleet: no end after 64 rounds")
    finally:
        fl.close()
    torch.cuda.synchronize()
    return fl, fl.results(), time.perf_counter() - t0, done_at, deaths


def _admission_windows(fn):
    """``fn()`` with the padded length of every admission window recorded
    per request: (result, {request: [window length, ...]}).  In bf16 on the
    card a request's tokens depend on that length (the prefill's GEMMs run
    at M = slots x length, and cuBLAS picks its kernel, and with it the
    summation order, by shape), so streams compare bit for bit only between
    runs that admitted the request at the same shape."""
    from collections import defaultdict

    from repro_torch.serve import engine as E

    seen = defaultdict(list)
    real = E.ServeSession._take

    def take(self, free):
        out = real(self, free)
        if out[0]:
            p_b = E._bucket32(max(self.prompts[ri].size + len(self.outputs[ri])
                                  - self.start_of[ri] for ri in out[0]))
            for ri in out[0]:
                seen[ri].append(p_b)
        return out

    E.ServeSession._take = take
    try:
        return fn(), dict(seen)
    finally:
        E.ServeSession._take = real


def _gemm_rows(torch, params, pairs=((24, 32), (32, 64), (1, 8))):
    """Which of the model's GEMMs give a row bits that depend on the other
    rows: for each distinct weight shape (one layer's and the unembedding),
    x[:, :a] @ w against the first a rows of x @ w for x of (2, b, K), per
    (a, b) in ``pairs`` (the admission windows 32 and 64, a decode step).
    Returns {(K, N): (weight name, [(a, b) pairs whose rows differ])}."""
    def walk(tree, path=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from walk(v, f"{path}/{k}")
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                yield from walk(v, f"{path}/{i}")
        elif tree is not None:
            yield path, tree

    found = {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.inference_mode():
        for path, w in walk(params):
            name = path.rsplit("/", 1)[-1]
            w = w[0] if w.dim() == 3 else w
            matrix = name == "unembed" or (name.startswith("w_") and not name.endswith("_base"))
            if not matrix or tuple(w.shape) in found:
                continue
            bad = []
            for a, b in pairs:
                x = torch.randn(2, b, w.shape[0], device="cuda", generator=gen).to(w.dtype)
                if not torch.equal(x[:, :a].contiguous() @ w, (x @ w)[:, :a]):
                    bad.append((a, b))
            found[tuple(w.shape)] = (name, bad)
    return found


def _fleet_schedule(np, reqs, chaos, k_w, slots=2, replicas=3):
    """The schedule of a fleet run, taken from the same run on the CPU at
    reduced size: requests of the same lengths and budgets (no EOS) give
    the same admissions, windows, corruptions and handoffs whatever the
    weights.  Returns the per-replica (admissions, windows)."""
    import tempfile

    from repro_torch.configs.registry import get_config
    from repro_torch.model import model as M
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.fleet import FleetRouter

    cfg = get_config("rwkv6-1.6b").reduced()
    params = M.init_params(cfg, seed=0, device="cpu")
    small = [Request(tokens=np.asarray(r.tokens) % cfg.vocab_size,
                     max_new_tokens=r.max_new_tokens) for r in reqs]
    engines = [ServeEngine(cfg, params, max_len=512, decode_window=k_w, device="cpu")
               for _ in range(replicas)]
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as root:
        fl = FleetRouter(engines, small, slots=slots, snapshot_every=1, snapshot_root=root,
                         checksum_every=2, chaos=chaos)
        fl.run()
    return [(s["admissions"], s["decode_dispatches"]) for s in fl.stats_by_replica()]


def _fleet_serving(torch, np, k_w=8, slots=2, replicas=3, chain_reps=8, fleet_reps=6):
    """Phase 3k: the replica fleet, the checksum chain and the interleaving
    drill on the card.

    Full-size rwkv6-1.6b (bf16, phase 3's weights and 6 ragged requests):
    three engines sharing one params tree, 2 slots each, K=8, a snapshot
    every window (``snapshot_every`` 1), the chain every 2 windows.  The
    WKV launch counts of each fleet run are derived before it from the same
    schedule run on the CPU at reduced size (24 window launches an
    admission, 24 x 8 decode-step launches a window, no chunked launch) and
    held exactly.  (a) Fault-free, against one recoverable engine on 2
    slots: 0 deaths, 0 handoffs, 6 assignments; every stream admitted at
    the single engine's window length bit-identical to it (in bf16 a
    request's tokens depend on that length, see
    :func:`_admission_windows`; the others' equal prefixes printed), and
    the same weights in f32 with every stream equal; tok/s of both over
    alternating pairs.  (b) The drill on replica 1 (a bit flip before window 1, a
    kill after window 2): the chain detects the flip, one death, a
    handoff, replica 1 dead, clean outcomes, every request neither handed
    off nor recovered bit-identical to (a)'s fleet (admitted as there),
    the others' equal prefixes printed; the time from the kill to the last handed-off
    request's completion.  (c) The chain's cost: the single engine's serve
    with ``checksum_every`` 2 against 0, alternating, medians and
    quartiles.  Then the reduced f32 rwkv6 (fault-free fleet, kill drill,
    bit-flip drill) and paged gemma3 (kill drill) on the card against the
    CPU, every stream exact; and ``run_drill`` of the reduced rwkv6 on the
    card, 2 forced schedules bit-identical to its baseline.  Returns the
    launch counts of the two full-size fleet runs."""
    import tempfile

    from repro_torch.configs.registry import get_config
    from repro_torch.model import model as M
    from repro_torch.serve import health as H
    from repro_torch.serve import interleave as I
    from repro_torch.serve.chaos import ChaosInjector
    from repro_torch.serve.engine import Request, ServeEngine

    counters = _counters()
    none = dict.fromkeys(counters, 0)
    total = dict(none)
    cfg = get_config("rwkv6-1.6b")
    layers = cfg.num_layers
    params = M.init_params(cfg, seed=0, device="cuda")
    reqs = _g3_requests(np.random.default_rng(0), cfg.vocab_size)
    single = ServeEngine(cfg, params, max_len=512, decode_window=k_w)
    engines = [ServeEngine(cfg, params, max_len=512, decode_window=k_w)
               for _ in range(replicas)]
    with torch.inference_mode():
        single.serve(reqs[:1], slots=slots)                   # warm-up

    def derived(schedule):
        adm = sum(a for a, _ in schedule)
        win = sum(w for _, w in schedule)
        return {**none, "wkv_decode_window_cuda": layers * adm,
                "wkv_decode_cuda": layers * k_w * win}

    def held(what, got, want):
        print(f"[fleet] {what} launches {_nonzero(got)}, derived {_nonzero(want)}")
        if got != want:
            raise SystemExit(f"fleet: {what} launches {got} != derived {want}")
        for n, c in got.items():
            total[n] += c

    # (a) fault-free fleet against one recoverable engine.
    want_a = derived(_fleet_schedule(np, reqs, None, k_w, slots, replicas))
    (base, dt_single, _), win_single = _admission_windows(lambda: _counted(
        torch, counters, lambda: single.serve(reqs, slots=slots, recoverable=True)))
    st_single = dict(single.last_serve_stats)
    build = ROOT / "build"
    with tempfile.TemporaryDirectory(dir=build) as root:
        for c in counters.values():
            c.launches = 0
        (fl, outs, dt_fleet, _, _), win_fleet = _admission_windows(
            lambda: _fleet_run(torch, engines, reqs, root, slots=slots))
        got = {n: c.launches for n, c in counters.items()}
    fleet_a = outs
    emitted = sum(r.size for r in outs)
    per = fl.stats_by_replica()
    print(f"[fleet] rwkv6 fault-free fleet ({replicas} replicas x {slots} slots, K={k_w}, "
          f"snapshot every window, chain every 2): {emitted} tokens in {dt_fleet:.3f}s, "
          f"{emitted / dt_fleet:.1f} tok/s; {fl.stats}; per replica (admissions, windows, "
          f"snapshots, spot checks) {[(s['admissions'], s['decode_dispatches'], s['snapshots'], s['checksum_spot_checks']) for s in per]}")
    print(f"[fleet] rwkv6 single recoverable engine ({slots} slots): "
          f"{sum(r.size for r in base)} tokens in {dt_single:.3f}s, "
          f"{sum(r.size for r in base) / dt_single:.1f} tok/s; admissions "
          f"{st_single['admissions']}, windows {st_single['decode_dispatches']}")
    held("fault-free fleet", got, want_a)
    diff = _victims(np, base, outs)
    same_shape = [i for i in range(len(reqs)) if win_single[i] == win_fleet[i]]
    print(f"[fleet] rwkv6 admission windows per request, single engine {win_single}, fleet "
          f"{win_fleet}; requests differing from the single engine (index, equal prefix): "
          f"{diff}")
    if any(i in same_shape for i, _ in diff) or any(r.outcome != "ok" for r in outs):
        raise SystemExit(f"fleet: a fault-free stream admitted at the single engine's shape "
                         f"differs (index, equal prefix): {diff}; {[r.outcome for r in outs]}")
    if (fl.stats["replica_deaths"], fl.stats["handoffs"], fl.stats["assignments"]) != (0, 0, 6):
        raise SystemExit(f"fleet: fault-free stats {fl.stats}")
    print(f"[fleet] rwkv6 fault-free fleet: every stream admitted at the single engine's "
          f"shape ({same_shape}) equal to it")
    print(f"[fleet] bf16 GEMMs whose rows depend on M ((K, N): name, (a, b) pairs where a "
          f"(2, a) batch's rows differ from those of (2, b)): {_gemm_rows(torch, params)}")
    # tok/s of the fleet against the single engine, in alternating turns.
    rates = {"single": [], "fleet": []}
    for rep in range(fleet_reps):
        for side in (("single", "fleet") if rep % 2 == 0 else ("fleet", "single")):
            if side == "single":
                res, dt, _ = _counted(torch, counters, lambda: single.serve(
                    reqs, slots=slots, recoverable=True))
            else:
                with tempfile.TemporaryDirectory(dir=build) as root:
                    _, res, dt, _, _ = _fleet_run(torch, engines, reqs, root, slots=slots)
            rates[side].append(sum(r.size for r in res) / dt)
    qs = {k: np.percentile(v, [25, 50, 75]).round(2).tolist() for k, v in rates.items()}
    print(f"[fleet] rwkv6 tok/s over {fleet_reps} alternating pairs: fleet quartiles "
          f"{qs['fleet']}, single engine {qs['single']}; median ratio "
          f"{qs['fleet'][1] / qs['single'][1]:.3f}; fleet faster in "
          f"{sum(f > g for f, g in zip(rates['fleet'], rates['single']))} of {fleet_reps}")

    # (a') the same weights in f32 (TF32 off): every stream equal.
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = M.init_params(cfg32, seed=0, device="cuda")
    e32 = [ServeEngine(cfg32, p32, max_len=512, decode_window=k_w) for _ in range(replicas + 1)]
    with torch.inference_mode():
        base32 = e32[0].serve(reqs, slots=slots, recoverable=True)
    with tempfile.TemporaryDirectory(dir=build) as root:
        _, outs32, dt32, _, _ = _fleet_run(torch, e32[1:], reqs, root, slots=slots)
    diff32 = _victims(np, base32, outs32)
    print(f"[fleet] rwkv6 f32 (the same weights, TF32 off) fault-free fleet in {dt32:.3f}s: "
          f"requests differing from the f32 single engine (index, equal prefix): {diff32}; "
          f"bf16 against f32 equal prefixes, single engine "
          f"{[_shared_prefix(np, a, b) for a, b in zip(base, base32)]}")
    if diff32:
        raise SystemExit("fleet: f32 fleet streams differ from the f32 single engine")
    del e32, p32
    torch.cuda.empty_cache()

    # (b) the drill: a bit flip and a kill on replica 1.
    want_b = derived(_fleet_schedule(np, reqs, _fleet_drill_chaos(replicas), k_w, slots,
                                     replicas))
    chaos = _fleet_drill_chaos(replicas)
    with tempfile.TemporaryDirectory(dir=build) as root:
        for c in counters.values():
            c.launches = 0
        fl, outs, dt, done_at, deaths = _fleet_run(torch, engines, reqs, root, chaos=chaos,
                                                   slots=slots)
        got = {n: c.launches for n, c in counters.items()}
    per = fl.stats_by_replica()
    handed = sorted({ri for _, h in deaths for ri in h})
    touched = [i for i, r in enumerate(outs) if i in handed or r.recoveries]
    print(f"[fleet] rwkv6 drill (flip before window {FLEET_FLIP_AT}, kill after window "
          f"{FLEET_KILL_AT}, replica 1): {dt:.3f}s; events {chaos[1].events}; {fl.stats}; "
          f"corruptions per replica {[s['corruptions'] for s in per]}; monitors "
          f"{[m.state for m in fl.monitors]}; outcomes {[r.outcome for r in outs]}; handed "
          f"off {handed}")
    held("drill fleet", got, want_b)
    if per[1]["corruptions"] < 1 or fl.stats["replica_deaths"] != 1 or (
            fl.stats["handoffs"] + fl.stats["handoff_requeued_fresh"]) < 1:
        raise SystemExit(f"fleet: drill counts {fl.stats}, corruptions "
                         f"{[s['corruptions'] for s in per]}")
    if fl.monitors[1].state != H.DEAD or fl.sessions[1].state is not None:
        raise SystemExit("fleet: replica 1 not dead or its state not dropped")
    if any(r.outcome not in ("ok", "eos", "recovered") for r in outs):
        raise SystemExit(f"fleet: unclean outcomes {[r.outcome for r in outs]}")
    # The untouched requests were admitted as in (a)'s fleet: held to it.
    diff = _victims(np, fleet_a, outs)
    if any(i not in touched for i, _ in diff):
        raise SystemExit(f"fleet: an untouched request diverged (index, equal prefix): {diff}")
    t_kill = deaths[0][0]
    print(f"[fleet] rwkv6 drill: untouched requests bit-identical to the fault-free fleet; "
          f"handed-off or recovered (index, equal prefix with the fault-free fleet, with the "
          f"single engine, tokens): "
          f"{[(i, _shared_prefix(np, fleet_a[i], outs[i]), _shared_prefix(np, base[i], outs[i]), base[i].size) for i in touched]}"
          f"; against the single engine (index, equal prefix): {_victims(np, base, outs)}; "
          f"kill to the last handed-off request's completion "
          f"{max(done_at[i] for i in handed) - t_kill:.3f}s")

    # (c) the chain's cost: one engine, checksum_every 2 against 0.
    times = {0: [], 2: []}
    windows = {0: [], 2: []}
    streams, st = {}, {}
    for rep in range(chain_reps):
        for every in ((0, 2) if rep % 2 == 0 else (2, 0)):
            res, dt, _, spent = _timed_serve(torch, counters, single, reqs, slots=slots,
                                             recoverable=True, checksum_every=every)
            times[every].append(dt)
            windows[every].append(spent["window"])
            streams.setdefault(every, res)
            st[every] = dict(single.last_serve_stats)
    st = st[2]
    q = lambda xs: np.percentile(xs, [25, 50, 75])              # noqa: E731
    n_win = st["decode_dispatches"]
    print(f"[fleet] chain cost, single engine serve ({chain_reps} alternating pairs, "
          f"{n_win} windows, {st['checksum_spot_checks']} spot checks a serve): serve "
          f"quartiles off {q(times[0]).round(4).tolist()} s, on {q(times[2]).round(4).tolist()} s; "
          f"window dispatches off {q(windows[0]).round(4).tolist()} s, on "
          f"{q(windows[2]).round(4).tolist()} s; median difference a window "
          f"{(np.median(windows[2]) - np.median(windows[0])) / n_win * 1e3:.3f} ms "
          f"(serve {(np.median(times[2]) - np.median(times[0])) / n_win * 1e3:.3f} ms)")
    if _victims(np, streams[0], streams[2]) or _victims(np, base, streams[0]):
        raise SystemExit("fleet: the chain changed a stream")
    # The chain's own work at this state (B=2, full size): a checksum on the
    # card, and the spot check's checksum with its host copy.
    with torch.inference_mode():
        state = single.last_state
        ck_dev, ck_call = _time_ms(torch, lambda: M.decode_state_checksum(state), [()], 50)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            M.decode_state_checksum(state).cpu()
        spot_ms = (time.perf_counter() - t0) / 50 * 1e3
    print(f"[fleet] chain work at B={slots}: a checksum {ck_dev * 1e3:.1f} us of device time, "
          f"{ck_call * 1e3:.1f} us a call (host incl.); a spot check with its copy "
          f"{spot_ms * 1e3:.1f} us; two checksums a window and a spot check every two: "
          f"{(2 * ck_call + spot_ms / 2) * 1e3:.1f} us a window against a window's "
          f"{np.median(windows[2]) / n_win * 1e3:.1f} ms")
    del single, engines, params, fl
    torch.cuda.empty_cache()

    # The reduced f32 models on the card against the CPU.
    spec = [(5, 9), (12, 3), (7, 14), (3, 6), (9, 11)]
    drills = (
        ("rwkv6-1.6b", False, "fault-free", lambda: None),
        ("rwkv6-1.6b", False, "kill", lambda: [None, ChaosInjector(seed=7, replica_kill_at=(1,)),
                                               None]),
        ("rwkv6-1.6b", False, "bit flip", lambda: [ChaosInjector(seed=7, bitflip_at=(1,)),
                                                   None, None]),
        ("gemma3-1b", True, "kill", lambda: [None, ChaosInjector(seed=7, replica_kill_at=(1,)),
                                             None]),
    )
    for arch, paged, what, make_chaos in drills:
        cfg = get_config(arch).reduced()
        p_cpu = M.init_params(cfg, seed=0, device="cpu")
        rng = np.random.default_rng(0)
        small = [Request(tokens=rng.integers(0, cfg.vocab_size, (pl,)), max_new_tokens=nn)
                 for pl, nn in spec]
        runs = {}
        for dev, prm in (("cuda", _to(p_cpu, "cuda")), ("cpu", p_cpu)):
            engs = [ServeEngine(cfg, prm, max_len=96, decode_window=4, device=dev, paged=paged)
                    for _ in range(replicas)]
            single_outs = engs[0].serve(small, slots=2, recoverable=True)
            with tempfile.TemporaryDirectory(dir=build) as root:
                fl, outs, _, _, _ = _fleet_run(torch, engs, small, root, chaos=make_chaos())
            runs[dev] = (single_outs, outs, {
                **fl.stats, "corruptions": [s["corruptions"] for s in fl.stats_by_replica()]})
        (s_gpu, f_gpu, st_gpu), (s_cpu, f_cpu, st_cpu) = runs["cuda"], runs["cpu"]
        same = not (_victims(np, s_gpu, f_gpu) or _victims(np, f_gpu, f_cpu)
                    or _victims(np, s_gpu, s_cpu))
        print(f"[fleet] reduced f32 {arch}{' paged' if paged else ''} {what} fleet on the "
              f"card: {st_gpu}; every stream equal to the single engine's and to the CPU's "
              f"(whose stats are the same: {st_gpu == st_cpu}): {same}")
        if not same or st_gpu != st_cpu or (what == "kill" and st_gpu["replica_deaths"] != 1) or (
                what == "bit flip" and sum(st_gpu["corruptions"]) < 1):
            raise SystemExit(f"fleet: reduced {arch} {what} drill")

    stats = I.run_drill("rwkv6-1.6b", seeds=range(2), device="cuda")
    print(f"[fleet] interleave drill, reduced rwkv6 on the card, 2 forced schedules: "
          f"bit-identical; {stats}")
    if stats["schedules"] != 2 or stats["preemptions"] < 1:
        raise SystemExit(f"fleet: interleave drill {stats}")
    return total


def _nonzero(counts):
    return {n: c for n, c in counts.items() if c}


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
# The decoder-only archs (phase 3l and its rows of phase 4): qwen2-0.5b,
# minitron-8b, nemotron-4-15b, qwen2-vl-7b, dbrx-132b and qwen3-moe through
# the same engine and the same flash kernel.
# ---------------------------------------------------------------------------

#: Depth of the two MoE archs on one card: full width, 4 of their 40 (dbrx)
#: and 94 (qwen3-moe) layers.  The full depth holds 263 and 470 GB of bf16
#: weights; four layers and the embeddings about 29 and 22 GB.
MOE_DEPTH = 4
#: qwen2-vl's scoring: 1024 leading patch embeddings (a 32 x 32 grid).
VL_PATCHES = 1024


def _vision_extras(torch, b, t, d, s_f, seed, device="cuda", dtype=None):
    """qwen2-vl inputs: ``s_f`` leading patch embeddings (N(0, 1) from a
    seed) on a square grid, and (3, B, T) M-RoPE positions: each patch at
    temporal position 0 with its row and column on the height and width
    streams, the text after them continuing from the grid's side on all
    three streams."""
    g = torch.Generator(device=device).manual_seed(seed)
    fe = torch.randn((b, s_f, d), generator=g, device=device)
    side = math.isqrt(s_f)
    i = torch.arange(s_f, device=device)
    pos = torch.empty((3, b, t), dtype=torch.int64, device=device)
    pos[0, :, :s_f] = 0
    pos[1, :, :s_f] = i // side
    pos[2, :, :s_f] = i % side
    pos[:, :, s_f:] = side + torch.arange(t - s_f, device=device)
    return {"frontend_embeds": fe if dtype is None else fe.to(dtype), "positions": pos}


def _flash_recorder(torch, FOPS, calls, keep=None):
    """A pass-through for ``ops.flash_attention_cuda`` that counts each
    call by (causal, window, T, S); the launch counts are the wrapper's
    own.  With ``keep``, a copy of the first call's inputs of each key is
    kept there, to hold against the plain version after the run."""
    real = FOPS.flash_attention_cuda

    def recording(q, k, v, **kw):
        key = (kw.get("causal", True), kw.get("window"), q.shape[2], k.shape[2])
        calls[key] += 1
        if keep is not None and key not in keep:
            keep[key] = (q.clone(), k.clone(), v.clone(), dict(kw))
        return real(q, k, v, **kw)

    return real, recording


def _arch_path(torch, np, name, *, layers=None, gen=(4, 64, 16), serve=False,
               score=(1, 4096), frontend=0, k_w=8, profile=False):
    """One decoder-only arch at full width in bf16 (random weights from a
    seed; ``layers`` cuts the depth) through ``generate`` (B, P, +new) and,
    with ``serve``, phase 3's 6 ragged requests on 4 slots, each with every
    launch count set to 0 just before and held at 0 just after (serving
    attends in plain PyTorch), then prompt scoring through
    ``make_prefill_step`` at ``score`` (B, T) (qwen2-vl with ``frontend``
    leading patch embeddings and (3, B, T) positions), its flash launches
    held to one causal launch with no window a layer and a chunk.  The MoE
    archs score twice: the logits must be bit-identical (the combine has no
    atomics), and the second run prints each layer's capacity and dropped
    share of (token, k) assignments.  Returns the flash launches of the
    scoring."""
    from collections import Counter

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.local_attention import ops as FOPS
    from repro_torch.model import model as M
    from repro_torch.model import moe as MOE
    from repro_torch.serve.engine import ServeEngine, make_prefill_step

    cfg = get_config(name)
    full_layers = cfg.num_layers
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    tag = f"[{cfg.name}]"
    counters = _counters()
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in _leaves(params))
    print(f"{tag} {n_params / 1e9:.3f}B params in {cfg.dtype} ({cfg.num_layers} of "
          f"{full_layers} layers; Hq {cfg.num_heads} over Hkv {cfg.num_kv_heads}, head "
          f"{cfg.head_dim}; mlp {cfg.mlp_type}"
          + (f", {cfg.num_experts} experts top-{cfg.num_experts_per_tok}" if cfg.num_experts
             else "") + f"), {torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card, "
          f"initialized in {time.perf_counter() - t0:.1f}s")
    gb, gp, gnew = gen
    engine = ServeEngine(cfg, params, max_len=512 if serve else 128, decode_window=k_w)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (gb, gp))
    reqs = _g3_requests(np.random.default_rng(0), cfg.vocab_size) if serve else []
    sb, st = score
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (sb, st))).cuda()
    extras = (_vision_extras(torch, sb, st, cfg.d_model, frontend, seed=3, dtype=torch.bfloat16)
              if frontend else {})
    scoring = make_prefill_step(cfg)
    n = cfg.prefill_chunks
    chunks = n if n > 1 and sb % n == 0 else 1
    with torch.inference_mode():                              # warm-up
        engine.generate(prompts[:, :16], 2)
        if serve:
            engine.serve(reqs[:1], slots=4)
        scoring(params, tokens[:chunks, :256], **{
            k: (v[:, :chunks, :256] if k == "positions" else v[:chunks, :min(256, frontend)])
            for k, v in extras.items()})

    def hold(what, got, want):
        want = {**dict.fromkeys(counters, 0), **want}
        print(f"{tag} launches during {what}: {got['flash_attention_cuda']} flash, "
              f"{sum(got.values())} in all; derived {sum(want.values())}")
        if got != want:
            raise SystemExit(f"{cfg.name} {what}: launch counts {got} != derived {want}")

    out, dt, got = _counted(torch, counters, lambda: engine.generate(prompts, gnew))
    hold("generate", got, {})
    toks = out[:, gp:].cpu().numpy()
    gen_ok = bool(M.decode_state_finite(engine.last_state).all())
    print(f"{tag} generate B={gb} P={gp} +{gnew} K={k_w}: {dt:.3f}s, {gb * gnew / dt:.1f} tok/s "
          f"incl. prefill; state finite: {gen_ok}")
    if toks.shape != (gb, gnew) or toks.min() < 0 or toks.max() >= cfg.vocab_size or not gen_ok:
        raise SystemExit(f"{cfg.name} generate: bad tokens or state, shape {toks.shape}")
    if serve:
        results, dt, got = _counted(torch, counters, lambda: engine.serve(reqs, slots=4))
        hold("serve", got, {})
        emitted = sum(r.size for r in results)
        serve_ok = bool(M.decode_state_finite(engine.last_state).all())
        print(f"{tag} serve 6 requests, 4 slots, K={k_w}: {emitted} tokens in {dt:.3f}s, "
              f"{emitted / dt:.1f} tok/s; outcomes {[r.outcome for r in results]}; "
              f"state finite: {serve_ok}")
        for req, res in zip(reqs, results):
            if res.outcome != "ok" or res.size != req.max_new_tokens:
                raise SystemExit(f"{cfg.name} serve: {res.outcome} with {res.size} tokens")
            if res.tokens.min() < 0 or res.tokens.max() >= cfg.vocab_size:
                raise SystemExit(f"{cfg.name} serve: token outside the vocabulary")
        if not serve_ok:
            raise SystemExit(f"{cfg.name} serve: decode state not finite")
    del engine

    calls = Counter()
    real, recording = _flash_recorder(torch, FOPS, calls)
    FOPS.flash_attention_cuda = recording
    try:
        with torch.inference_mode():
            logits, dt, got = _counted(torch, counters,
                                       lambda: scoring(params, tokens, **extras))
    finally:
        FOPS.flash_attention_cuda = real
    want = cfg.num_layers * chunks
    hold(f"scoring B={sb} T={st} ({chunks} chunk{'s' * (chunks > 1)})", got,
         {"flash_attention_cuda": want})
    if dict(calls) != {(True, None, st, st): want}:
        raise SystemExit(f"{cfg.name} scoring: flash calls {dict(calls)}, want {want} causal "
                         f"with no window at T = S = {st}")
    fin = bool(torch.isfinite(logits[..., :cfg.vocab_size]).all())
    nll = float(torch.nn.functional.cross_entropy(
        logits[:, :-1, :cfg.vocab_size].reshape(-1, cfg.vocab_size).float(),
        tokens[:, 1:].reshape(-1)))
    print(f"{tag} scoring (make_prefill_step) B={sb} T={st}"
          + (f" with {frontend} patch embeddings and (3, B, T) positions" if frontend else "")
          + f": {dt:.3f}s, {sb * st / dt:,.0f} tok/s; logits {tuple(logits.shape)} finite: "
          f"{fin}; mean NLL {nll:.3f} (random weights; ln V = {math.log(cfg.vocab_size):.3f})")
    if logits.shape != (sb, st, cfg.padded_vocab) or not fin:
        raise SystemExit(f"{cfg.name} scoring: bad logits")
    if cfg.num_experts:
        routes = []
        real_dispatch = MOE.dispatch

        def recording_dispatch(*a, **kw):
            r = real_dispatch(*a, **kw)
            routes.append((r.cap, (r.slot == cfg.num_experts * r.cap).sum(), r.slot.numel()))
            return r

        MOE.dispatch = recording_dispatch
        try:
            with torch.inference_mode():
                again = scoring(params, tokens, **extras)
        finally:
            MOE.dispatch = real_dispatch
        same = torch.equal(logits, again)
        del again
        dropped = [int(d) for _, d, _ in routes]
        cap, per_call = routes[0][0], routes[0][2]
        print(f"{tag} MoE of one scoring: {len(routes)} calls ({cfg.num_layers} layers x "
              f"{chunks} chunks) of {per_call} (token, k) assignments, capacity {cap} rows "
              f"an expert; dropped {sum(dropped)} of {per_call * len(routes)} "
              f"({100 * sum(dropped) / (per_call * len(routes)):.3f}%; per call "
              f"{min(dropped)}-{max(dropped)}); a second scoring bit-identical: {same}")
        if not same:
            raise SystemExit(f"{cfg.name}: two scorings of the same tokens differ")
    del logits
    if profile:
        with torch.inference_mode():
            _profile(torch, lambda: scoring(params, tokens, **extras),
                     f"{cfg.name} scoring B={sb} T={st}", top=10)
    del params
    torch.cuda.empty_cache()
    return want


def _router_gap(torch, cfg, params, prefix):
    """(gap at the last token, smallest gap over every token) between the
    k-th and (k+1)-th router probability of ``prefix`` (T,), over the MoE
    layers of a CPU forward."""
    from repro_torch.model import model as M
    from repro_torch.model import moe as MOE

    gaps = []
    real = MOE._topk_routing

    def recording(logits, k):
        top = torch.sort(torch.softmax(logits.float(), -1), dim=-1, descending=True).values
        gaps.append(top[:, k - 1] - top[:, k])
        return real(logits, k)

    MOE._topk_routing = recording
    try:
        with torch.inference_mode():
            M.forward(params, cfg, prefix[None].cpu())
    finally:
        MOE._topk_routing = real
    g = torch.stack(gaps)                              # (layers, T)
    return float(g[:, -1].min()), float(g.min())


def _arch_reference_check(torch, np, name):
    """The reduced f32 arch with flash on the card against the same weights
    with the plain versions on the CPU: forward logits at T=200 within 1e-4
    (qwen2-vl with 48 patch embeddings and (3, B, T) positions), greedy
    ``generate`` tokens (a 40-token prompt, +12) and ``serve`` streams (5
    ragged requests, 2 slots, K=4) equal.  For the MoE archs the only
    allowed cause of a parted stream is a router near-tie: where one
    parts, the gap between the k-th and (k+1)-th router probability over
    its context must be below 1e-6."""
    from repro_torch.configs.registry import get_config
    from repro_torch.model import model as M
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = get_config(name).reduced()
    p_cpu = M.init_params(cfg, seed=1, device="cpu")
    p_gpu = _to(p_cpu, "cuda")
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 200)))
    kw_cpu = (_vision_extras(torch, 2, 200, cfg.d_model, 49, seed=1, device="cpu")
              if cfg.frontend == "vision" else {})
    kw_gpu = {k: v.cuda() for k, v in kw_cpu.items()}
    with torch.inference_mode():
        l_cpu = M.forward(p_cpu, cfg, toks, **kw_cpu)
        l_gpu = M.forward(p_gpu, cfg, toks.cuda(), **kw_gpu).cpu()
    err = float((l_cpu - l_gpu).abs().max())
    reqs = [Request(tokens=rng.integers(0, cfg.vocab_size, int(rng.integers(4, 30))),
                    max_new_tokens=int(rng.integers(2, 10))) for _ in range(5)]
    runs = {}
    for dev, p in (("cpu", p_cpu), ("cuda", p_gpu)):
        eng = ServeEngine(cfg, p, max_len=128, decode_window=4, device=dev)
        g = eng.generate(toks[:, :40].to(dev), 12).cpu()
        runs[dev] = [g[i, 40:].numpy() for i in range(2)] + [
            np.asarray(r.tokens) for r in eng.serve(reqs, slots=2)]
    contexts = [toks[i, :40].numpy() for i in range(2)] + [r.tokens for r in reqs]
    parted = []
    for i, (a, b, ctx) in enumerate(zip(runs["cpu"], runs["cuda"], contexts)):
        if np.array_equal(a, b):
            continue
        j = int(np.argmax(a[:len(b)] != b[:len(a)])) if len(a) == len(b) else min(len(a), len(b))
        prefix = torch.from_numpy(np.concatenate([ctx, a[:j]]).astype(np.int64))
        gap = _router_gap(torch, cfg, p_cpu, prefix) if cfg.num_experts else (None, None)
        parted.append((i, j, gap))
        print(f"[reference] reduced f32 {cfg.name}: stream {i} parts at token {j}; router "
              f"gap at that token {gap[0]}, smallest over its context {gap[1]}")
    print(f"[reference] reduced f32 {cfg.name}, card vs CPU: forward T=200 max_abs_err="
          f"{err:.2e} (tol 1e-4), {len(contexts) - len(parted)} of {len(contexts)} greedy "
          f"streams (2 generate, 5 serve) equal")
    if err > 1e-4:
        raise SystemExit(f"card and CPU disagree on the reduced {cfg.name}'s logits")
    for i, j, (_, low) in parted:
        if low is None or low >= 1e-6:
            raise SystemExit(f"reduced {cfg.name}: stream {i} parts at token {j} without a "
                             f"router near-tie (smallest gap {low})")


def _decoder_archs(torch, np):
    """Phase 3l.  Returns (flash launches of the phase, the flash launches
    a forward of each arch)."""
    plan = (
        ("qwen2-0.5b", dict(gen=(4, 256, 32), serve=True, profile=True)),
        ("minitron-8b", {}),
        ("nemotron-4-15b", {}),
        ("qwen2-vl-7b", dict(frontend=VL_PATCHES)),
        ("dbrx-132b", dict(layers=MOE_DEPTH, score=(8, 1024))),
        ("qwen3-moe-235b-a22b", dict(layers=MOE_DEPTH, score=(8, 1024))),
    )
    t0 = time.perf_counter()
    total, per_forward = 0, {}
    for name, kw in plan:
        per_forward[name] = _arch_path(torch, np, name, **kw)
        total += per_forward[name]
    t1 = time.perf_counter()
    for name, _ in plan:
        _arch_reference_check(torch, np, name)
    t2 = time.perf_counter()
    # The serving example on the card: the reduced gemma3, recurrentgemma
    # and rwkv6 through generate, serve, a pinned NaN recovered with every
    # stream bit-identical, and the deadline and shed outcomes.
    from repro_torch.examples import serve_decode

    for arch, r in serve_decode.main([]).items():
        if (r["chaos"].count("recovered") != 1 or r["recoveries"] != 1 or not r["identical"]
                or r["lifecycle"] != ["deadline", "ok", "ok", "shed", "shed", "shed"]):
            raise SystemExit(f"examples/serve_decode on the card: {arch} {r}")
    print(f"[time] phase 3l wall: {t1 - t0:.1f}s full-size paths, {t2 - t1:.1f}s reduced "
          f"f32 card vs CPU, {time.perf_counter() - t2:.1f}s the serving example")
    return total, per_forward


def _time_arch_attention(torch, worst, per_forward):
    """Phase 4 rows of flash attention at the decoder-only archs' scoring
    shapes, bf16, causal with no window: qwen2-0.5b, minitron-8b,
    nemotron-4-15b (dbrx-132b shares its heads and width) and qwen2-vl-7b at
    B=1, T=4096, qwen3-moe at one chunk of its scoring (B=1, T=1024), each
    beside its plain version, its bound and SDPA ``is_causal`` on the same
    inputs with ``enable_gqa`` (the library call) and on K/V repeated to
    the Hq heads before the timed region, with the backend each took."""
    from repro_torch.kernels import card_checks as CC

    F = torch.nn.functional
    FA = _rg_modules()[3]
    fa_src = "src/repro_torch/kernels/local_attention/csrc/flash_attention.cu"
    fa_replaces = "src/repro/kernels/local_attention/kernel.py:137 (flash_attention_pallas)"
    shapes = (("qwen2-0.5b", 4096), ("minitron-8b", 4096), ("nemotron-4-15b", 4096),
              ("qwen2-vl-7b", 4096), ("qwen3-moe-235b-a22b", 1024))
    rows = []

    def gqa(q, k, v):
        return F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)

    def causal(q, k, v):
        return F.scaled_dot_product_attention(q, k, v, is_causal=True)

    with torch.inference_mode():
        for arch, t in shapes:
            hq, hkv, d, _ = ARCH_HEADS[arch]
            nbytes = 2 * (2 * hq * t * d + 2 * hkv * t * d)
            flops = 4 * d * hq * _visible_pairs(t, t, True, None)
            sets = _cold_sets(lambda s: _attn_inputs(torch, 1, t, t, torch.bfloat16, s, d=d,
                                                     hq=hq, hkv=hkv), nbytes)
            kern = lambda q, k, v: FA.flash_attention_cuda(q, k, v, causal=True)  # noqa: E731
            ms, call_ms = _time_ms(torch, kern, sets, reps=20)
            plain_ms, _ = _time_ms(torch, lambda q, k, v: FA.attention_ref(q, k, v, causal=True),
                                   sets[:2], reps=3)
            got = kern(*sets[0])
            ratio = CC.attn_bf16_ratio(gqa(*sets[0]), got)
            backend = _sdpa_backend(torch, gqa, sets[0])
            lib_ms = _time_ms(torch, gqa, sets, reps=20)[0]
            rep = [(q, k.repeat_interleave(hq // hkv, 1), v.repeat_interleave(hq // hkv, 1))
                   for q, k, v in sets]
            rep_backend = _sdpa_backend(torch, causal, rep[0])
            rep_ms = _time_ms(torch, causal, rep, reps=20)[0]
            del rep, sets
            b_ms = nbytes / HBM_BYTES_PER_S * 1e3
            f_ms = flops / PEAK_BF16_FLOPS * 1e3
            rows.append({
                "name": "flash_attention_cuda", "route": "cuda", "source": fa_src,
                "replaces": fa_replaces, "launches": per_forward[arch],
                "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": max(b_ms, f_ms), "bound_by": "bytes" if b_ms >= f_ms else "operations",
                "library_ms": lib_ms, "call_ms": call_ms,
                "shape": f"B=1 Hq={hq} Hkv={hkv} T={t} D={d} causal bf16 ({arch})",
                "backend": backend, "library_repeat_ms": rep_ms, "backend_repeat": rep_backend,
            })
            print(f"[time] flash_attention_cuda {rows[-1]['shape']:52s} device {ms * 1e3:9.2f} us, "
                  f"per call {call_ms * 1e3:9.2f} us (plain {plain_ms * 1e3:10.1f} us, bound "
                  f"{rows[-1]['bound_ms'] * 1e3:.2f} us by {rows[-1]['bound_by']}; SDPA "
                  f"enable_gqa {lib_ms * 1e3:.2f} us [{backend[:60]}], on repeated K/V "
                  f"{rep_ms * 1e3:.2f} us [{rep_backend[:60]}]; SDPA agrees: worst err/tol "
                  f"per element {ratio:.3f}); {per_forward[arch]} launches a forward")
    return rows


# ---------------------------------------------------------------------------
# The encoder-decoder arch (phase 3m and its rows of phase 4):
# seamless-m4t-large-v2's encoder, cross-attention, prompt scoring and
# decoding against encoder frames, through the same flash kernel.
# ---------------------------------------------------------------------------

SEAMLESS = "seamless-m4t-large-v2"
#: Phase 3m's scoring: (B, frames, decoder tokens).
SM_SCORE = (1, 4096, 1024)
#: Phase 3m's decoding: (B, frames, prompt window, new tokens).
SM_DECODE = (4, 1024, 64, 32)


def _frames(torch, b, s, d, seed, device="cuda"):
    """The stub audio frontend's output: N(0, 1) frame embeddings (B, S, D)
    from a seed."""
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((b, s, d), generator=g, device=device)


def _greedy_decode(torch, M, step, params, cfg, prompts, enc_out, new, max_len):
    """A prompt window at length 0 through ``step`` (``make_decode_step``),
    then ``new - 1`` single-token greedy steps against ``enc_out``.
    Returns (tokens (B, new), the last logits, seconds of the single steps,
    the decode state)."""
    b, p = prompts.shape
    state = M.init_decode_state(cfg, b, max_len, p, device=prompts.device)
    logits, state = step(params, state, prompts, 0, enc_out=enc_out)
    nxt = logits[:, -1].argmax(-1)
    out = [nxt]
    if prompts.is_cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(p, p + new - 1):
        logits, state = step(params, state, nxt[:, None], i, enc_out=enc_out)
        nxt = logits[:, -1].argmax(-1)
        out.append(nxt)
    if prompts.is_cuda:
        torch.cuda.synchronize()
    return torch.stack(out, 1), logits, time.perf_counter() - t0, state


def _seamless_path(torch, np):
    """Phase 3m (a) and (b): full-size seamless-m4t-large-v2 in bf16 at full
    depth (random weights from seed 0, frames from a seeded generator).

    (a) Scoring through ``make_prefill_step`` at B=1, 4096 frames and 1024
    decoder tokens: exactly one flash launch a layer of each kind, 24
    non-causal at T = S = 4096 (the encoder), 24 causal at T = 1024 (the
    decoder's self-attention) and 24 non-causal at T = 1024, S = 4096
    (cross-attention); one forward under the profiler.  (b) ``encode`` at
    B=4 and 1024 frames (24 non-causal launches at 1024), then greedy
    decoding through ``make_decode_step``: a 64-token prompt window at
    length 0 and 31 single-token steps, 32 new tokens, exactly 24 flash
    launches a call, every one cross-attention (self-attention reads the
    KV caches in plain PyTorch), then one more step under the profiler.
    Launch counts are set to 0 just before each part and held exactly; the
    first flash call of each shape in each part is then held against the
    plain version on its own inputs.
    Returns (flash launches of the phase,
    {row: launches a run at its shape})."""
    from collections import Counter

    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import card_checks as CC
    from repro_torch.kernels.local_attention import ops as FOPS
    from repro_torch.model import model as M
    from repro_torch.serve.engine import make_decode_step, make_prefill_step

    cfg = get_config(SEAMLESS)
    tag = f"[{cfg.name}]"
    counters = _counters()
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in _leaves(params))
    print(f"{tag} {n_params / 1e9:.3f}B params in {cfg.dtype} ({cfg.encoder_layers} encoder "
          f"and {cfg.num_layers} decoder layers, depth not cut; Hq {cfg.num_heads} over Hkv "
          f"{cfg.num_kv_heads}, head {cfg.head_dim}; vocab {cfg.vocab_size} padded to "
          f"{cfg.padded_vocab}), {torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card, "
          f"initialized in {time.perf_counter() - t0:.1f}s")
    sb, ss, st = SM_SCORE
    db, ds, dp, dnew = SM_DECODE
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (sb, st))).cuda()
    frames = _frames(torch, sb, ss, cfg.d_model, seed=4)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (db, dp))).cuda()
    dframes = _frames(torch, db, ds, cfg.d_model, seed=5)
    scoring = make_prefill_step(cfg)
    step = make_decode_step(cfg)
    n_enc, n_dec = cfg.encoder_layers, cfg.num_layers
    with torch.inference_mode():                              # warm-up
        scoring(params, tokens[:, :128], enc_tokens_embeds=frames[:, :256])
        enc = M.encode(params, cfg, dframes[:1, :128])
        _greedy_decode(torch, M, step, params, cfg, prompts[:1], enc, 2, dp + 2)

    def run(what, fn, want_calls):
        calls, kept = Counter(), {}
        real, recording = _flash_recorder(torch, FOPS, calls, keep=kept)
        FOPS.flash_attention_cuda = recording
        try:
            with torch.inference_mode():
                out, dt, got = _counted(torch, counters, fn)
        finally:
            FOPS.flash_attention_cuda = real
        want = {**dict.fromkeys(counters, 0),
                "flash_attention_cuda": sum(want_calls.values())}
        print(f"{tag} launches during {what}: {got['flash_attention_cuda']} flash, "
              f"{sum(got.values())} in all; derived {sum(want.values())}; flash calls by "
              f"(causal, window, T, S): {dict(calls)}")
        if got != want or dict(calls) != want_calls:
            raise SystemExit(f"{cfg.name} {what}: launches {got}, flash calls {dict(calls)}; "
                             f"derived {want_calls}")
        # The first call of each shape, on the main path's own activations,
        # against the plain version (after the counts were read).
        with torch.inference_mode():
            for key, (q, k, v, kw) in kept.items():
                r = CC.attn_bf16_ratio(real(q, k, v, **kw), FOPS.attention_ref(q, k, v, **kw))
                print(f"{tag} {what}: flash at B={q.shape[0]} (causal, window, T, S)={key} on "
                      f"the path's inputs against the plain version: worst err/tol per element "
                      f"{r:.3f}")
                if not r <= 1.0:
                    raise SystemExit(f"{cfg.name} {what} {key}: flash disagrees with the plain "
                                     f"version ({r} x tolerance)")
        del kept
        return out, dt

    # (a) prompt scoring with the frames.
    score_calls = {(False, None, ss, ss): n_enc, (True, None, st, st): n_dec,
                   (False, None, st, ss): n_dec}
    logits, dt = run(f"scoring B={sb} S={ss} T={st}",
                     lambda: scoring(params, tokens, enc_tokens_embeds=frames), score_calls)
    v = cfg.vocab_size
    fin = bool(torch.isfinite(logits[..., :v]).all())
    pad_ok = bool((logits[..., v:] == -1e30).all())
    nll = float(torch.nn.functional.cross_entropy(
        logits[:, :-1, :v].reshape(-1, v).float(), tokens[:, 1:].reshape(-1)))
    print(f"{tag} scoring (make_prefill_step) B={sb}, {ss} frames, {st} tokens: {dt:.3f}s, "
          f"{sb * st / dt:,.0f} tok/s; logits {tuple(logits.shape)} finite: {fin}; the "
          f"{cfg.padded_vocab - v} padded columns -1e30: {pad_ok}; mean NLL {nll:.3f} (random "
          f"weights; ln V = {math.log(v):.3f})")
    if logits.shape != (sb, st, cfg.padded_vocab) or not fin or not pad_ok:
        raise SystemExit(f"{cfg.name} scoring: bad logits")
    del logits
    with torch.inference_mode():
        _profile(torch, lambda: scoring(params, tokens, enc_tokens_embeds=frames),
                 f"{cfg.name} scoring B={sb} S={ss} T={st}", top=10)

    # (b) decoding against the encoder's output.
    enc, dt_enc = run(f"encode B={db} S={ds}", lambda: M.encode(params, cfg, dframes),
                      {(False, None, ds, ds): n_enc})
    decode_calls = {(False, None, dp, ds): n_dec, (False, None, 1, ds): n_dec * (dnew - 1)}
    (toks, last, dt_steps, state), dt = run(
        f"greedy decode B={db} P={dp} +{dnew} ({dnew} make_decode_step calls)",
        lambda: _greedy_decode(torch, M, step, params, cfg, prompts, enc, dnew, dp + 1 + dnew),
        decode_calls)
    ok = (toks.shape == (db, dnew) and int(toks.min()) >= 0 and int(toks.max()) < v
          and bool(torch.isfinite(last[..., :v]).all()))
    total = dt_enc + dt
    print(f"{tag} decode B={db}, {ds} frames: encode {dt_enc * 1e3:.1f} ms, a {dp}-token prompt "
          f"window and {dnew - 1} single-token steps {dt:.3f}s; {db * dnew / total:.1f} tok/s "
          f"incl. encode and prefill; {dt_steps / (dnew - 1) * 1e3:.2f} ms a step; tokens in "
          f"the vocabulary, logits finite: {ok}")
    if not ok:
        raise SystemExit(f"{cfg.name} decode: bad tokens or logits")
    with torch.inference_mode():
        _profile(torch, lambda: step(params, state, toks[:, -1:], dp + dnew - 1, enc_out=enc),
                 f"{cfg.name} one decode step B={db} S={ds}", top=10)
    del state
    # The same tokens teacher-forced through the forward: where its argmax
    # agrees with the greedy stream.  Both run the kernel, so this is printed
    # and not gated (bf16: a near-tie may part them); the kernel is held to
    # the plain version on the path's own inputs in ``run`` above and at
    # these shapes in phase 3d.
    with torch.inference_mode():
        seq = torch.cat([prompts, toks[:, :-1]], 1)
        forced = scoring(params, seq, enc_tokens_embeds=dframes)[:, dp - 1:].argmax(-1)
    agree = int((forced == toks).sum())
    print(f"{tag} the teacher-forced forward's argmax equals the greedy stream at {agree} of "
          f"{toks.numel()} positions")
    del params, enc, forced
    torch.cuda.empty_cache()
    return (sum(score_calls.values()) + n_enc + sum(decode_calls.values()),
            {"11i": n_enc, "11j": n_dec, "11k": n_dec * (dnew - 1)})


def _seamless_reference_check(torch, np):
    """Phase 3m (c): the reduced f32 seamless with flash on the card against
    the same weights with the plain versions on the CPU: forward logits
    (48 frames, 40 tokens) within 1e-4, and greedy decoding (a 24-token
    prompt window, then 12 steps through ``make_decode_step`` against
    ``encode``'s output) with equal tokens."""
    from repro_torch.configs.registry import get_config
    from repro_torch.model import model as M
    from repro_torch.serve.engine import make_decode_step

    cfg = get_config(SEAMLESS).reduced()
    p_cpu = M.init_params(cfg, seed=1, device="cpu")
    p_gpu = _to(p_cpu, "cuda")
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 40)))
    fr = torch.from_numpy(rng.standard_normal((2, 48, cfg.d_model)).astype(np.float32))
    step = make_decode_step(cfg)
    runs = {}
    with torch.inference_mode():
        for dev, p in (("cpu", p_cpu), ("cuda", p_gpu)):
            logits = M.forward(p, cfg, toks.to(dev), enc_tokens_embeds=fr.to(dev)).cpu()
            enc = M.encode(p, cfg, fr.to(dev))
            out = _greedy_decode(torch, M, step, p, cfg, toks[:, :24].to(dev), enc, 13, 64)[0]
            runs[dev] = (logits, out.cpu())
    err = float((runs["cpu"][0] - runs["cuda"][0]).abs().max())
    same = torch.equal(runs["cpu"][1], runs["cuda"][1])
    print(f"[reference] reduced f32 {cfg.name}, card vs CPU: forward max_abs_err={err:.2e} "
          f"(tol 1e-4), greedy decode tokens (24-token window + 12 steps) equal: {same}")
    if err > 1e-4 or not same:
        raise SystemExit(f"card and CPU disagree on the reduced {cfg.name}")


def _time_seamless_attention(torch, worst, launches):
    """Phase 4 rows of flash attention at seamless's shapes, bf16, MHA (16
    query and KV heads of 64), non-causal with no window: 11i the encoder
    (B=1, T = S = 4096), 11j cross-attention at scoring (B=1, T=1024,
    S=4096), 11k cross-attention in decoding (B=4, T=1, S=1024); each beside
    its plain version, its bound and SDPA on the same inputs with no mask
    (the library call), with the backend SDPA took."""
    from repro_torch.kernels import card_checks as CC

    F = torch.nn.functional
    FA = _rg_modules()[3]
    shapes = (("11i", "encoder", 1, 4096, 4096), ("11j", "cross, scoring", 1, 1024, 4096),
              ("11k", "cross, decode", 4, 1, 1024))
    rows = []

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(q, k, v)

    def kern(q, k, v):
        return FA.flash_attention_cuda(q, k, v, causal=False)

    with torch.inference_mode():
        for row, what, b, t, s in shapes:
            nbytes = 2 * b * SM_HQ * SM_DH * (2 * t + 2 * s)
            flops = 4 * SM_DH * SM_HQ * b * _visible_pairs(t, s, False, None)
            sets = _cold_sets(lambda seed: _attn_inputs(torch, b, t, s, torch.bfloat16, seed,
                                                        d=SM_DH, hq=SM_HQ, hkv=SM_HQ), nbytes)
            ms, call_ms = _time_ms(torch, kern, sets, reps=20)
            plain_ms, _ = _time_ms(torch, lambda q, k, v: FA.attention_ref(q, k, v, causal=False),
                                   sets[:2], reps=3)
            ratio = CC.attn_bf16_ratio(sdpa(*sets[0]), kern(*sets[0]))
            if not ratio <= 1.0:
                raise SystemExit(f"row {row}: SDPA and flash_attention_cuda disagree "
                                 f"({ratio} x tolerance)")
            backend = _sdpa_backend(torch, sdpa, sets[0])
            lib_ms = _time_ms(torch, sdpa, sets, reps=20)[0]
            del sets
            b_ms = nbytes / HBM_BYTES_PER_S * 1e3
            f_ms = flops / PEAK_BF16_FLOPS * 1e3
            rows.append({
                "row": row, "shape": f"B={b} Hq={SM_HQ} Hkv={SM_HQ} T={t} S={s} D={SM_DH} "
                f"non-causal bf16 ({SEAMLESS} {what})", "launches": launches[row],
                "max_abs_err": worst, "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
                "bound_ms": max(b_ms, f_ms), "bound_by": "bytes" if b_ms >= f_ms else "operations",
                "library_ms": lib_ms, "backend": backend,
            })
            print(f"[time] flash_attention_cuda row {row} {rows[-1]['shape']:70s} device "
                  f"{ms * 1e3:9.2f} us, per call {call_ms * 1e3:9.2f} us (plain "
                  f"{plain_ms * 1e3:10.1f} us; bound {rows[-1]['bound_ms'] * 1e3:.2f} us by "
                  f"{rows[-1]['bound_by']}: {flops / 1e9:.2f} GFLOP at "
                  f"{PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s = {f_ms * 1e3:.2f} us, "
                  f"{nbytes / 1e6:.2f} MB at {HBM_BYTES_PER_S / 1e12:.2f} TB/s = "
                  f"{b_ms * 1e3:.2f} us; SDPA {lib_ms * 1e3:.2f} us [{backend[:80]}]; SDPA "
                  f"agrees: worst err/tol per element {ratio:.3f}); {launches[row]} launches "
                  f"at this shape in phase 3m")
    return rows


# ---------------------------------------------------------------------------
# Training every arch (phases 2c and 3n and their rows of phase 4): the
# backward kernels of flash attention, the RG-LRU scan and the token shift,
# the WKV decode window under grad, full-size gemma3-1b and
# recurrentgemma-2b training, every reduced f32 arch's step card vs CPU,
# and the train_lm example.
# ---------------------------------------------------------------------------

#: The backward kernels, per output: (max error) <= ATOL + RTOL * max|plain|
#: of that output.  f32: the same f32 math in another order (dK and dV sum
#: over every query of a KV head's group).  bf16: flash attention rounds P
#: and dS to bf16 as the mma operands (2**-9 relative each) besides its
#: outputs, so 2e-2 of the largest value.  The scan's three outputs and the
#: token shift's dx are held bit for bit (the plain versions' order); the
#: token shift's dw sums its partials in another order.
GRAD_TOLERANCE = {"float32": (1e-5, 1e-4), "bfloat16": (1e-3, 2e-2)}
GRAD_KERNELS = ("flash_attention_bwd_cuda", "elevator_scan_bwd_cuda", "token_shift_bwd_cuda")
#: (B, Hq, Hkv, T, S, D, causal, window) of phase 2c's flash checks:
#: RecurrentGemma's local layers, Gemma3's two, qwen2-0.5b's and
#: minitron-8b's GQA, seamless's MHA non-causal and cross, T off a tile.
FLASH_GRAD_CASES = (
    (1, 10, 1, 4096, 4096, 256, True, 2048),
    (1, 4, 1, 2048, 2048, 256, True, 1024),
    (1, 4, 1, 2048, 2048, 256, True, None),
    (1, 14, 2, 2048, 2048, 64, True, None),
    (1, 32, 8, 2048, 2048, 128, True, None),
    (1, 16, 16, 1024, 1024, 64, False, None),
    (1, 16, 16, 256, 1024, 64, False, None),
    (2, 14, 2, 1000, 1000, 64, True, None),
    (2, 10, 1, 1024, 1024, 256, True, 2048),
)
#: f32 only: the train_lm example's head width.
FLASH_GRAD_F32_CASES = ((1, 8, 2, 256, 256, 96, True, None),)
#: Phase 3n: (arch, B, T) trained at full size, 4 steps.
TRAIN_ARCHS = (("gemma3-1b", 8, 2048), ("recurrentgemma-2b", 8, 1024))


def _grad_check(torch, worst, kname, case, dtype, got, want, exact=()):
    """Each output within GRAD_TOLERANCE of the plain version's, finite;
    those at ``exact`` bit for bit."""
    atol, rtol = GRAD_TOLERANCE[str(dtype).split(".")[-1]]
    errs = [float((a.float() - b.float()).abs().max()) for a, b in zip(got, want)]
    tols = [0.0 if i in exact else atol + rtol * float(b.float().abs().max())
            for i, b in enumerate(want)]
    ok = (all(e <= t for e, t in zip(errs, tols))
          and all(bool(torch.isfinite(a).all()) for a in got))
    print(f"[grad-kernels] {kname:24s} {case:34s} {str(dtype):15s} max_abs_err per output "
          f"{['%.2e' % e for e in errs]} tol {['%.2e' % t for t in tols]} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"{kname} {case} {dtype}: errors {errs} > {tols}")
    if kname in worst:
        worst[kname] = max(worst[kname], max(errs))


def _function_card_vs_cpu(torch, fn, args, cots):
    """The grads of sum(fn(*args) * cots) on the card and on CPU copies,
    both returned on the CPU."""
    grads = {}
    for dev in ("cuda", "cpu"):
        xs = [a.detach().to(dev).requires_grad_(True) for a in args]
        out = fn(*xs)
        outs = out if isinstance(out, tuple) else (out,)
        loss = sum((o.float() * c.to(dev).float()).sum() for o, c in zip(outs, cots))
        grads[dev] = [g.cpu() for g in torch.autograd.grad(loss, xs)]
    return grads["cuda"], grads["cpu"]


#: The token shift backward's planted fault: the cluster's sum of dw leaves
#: out rank 0's partial.  Compiled into a copy of the library at phase 1,
#: launched in phase 2c in a process of its own, so a fault that poisoned
#: the CUDA context could not end this run.
SHIFT_FAULT = ("    float acc = sm90::ld_cluster_f32(sm90::mapa(at + 4 * e, 0));\n",
               "    float acc = 0.f;\n")
#: The check the faulty and the good library both face: the backward at
#: B=2, T=300, D=2560 in f32 (a cluster of 4 blocks), dx bit for bit and dw
#: within GRAD_TOLERANCE of the plain version.  Prints one JSON line.
SHIFT_FAULT_CHECK = r"""
import json, sys
sys.path.insert(0, sys.argv[2])
import torch
from repro_torch.kernels import common
from repro_torch.kernels.token_shift import kernel as TS

g = torch.Generator(device="cuda").manual_seed(5)
x, dout = (torch.randn((2, 300, 2560), generator=g, device="cuda") for _ in range(2))
w = torch.randn((4, 2560), generator=g, device="cuda") * 0.1
want = TS.token_shift_bwd_ref(x, w, dout)
common._LIBS["token_shift"] = common.open_library("token_shift", sys.argv[1])
dx, dw = TS.token_shift_bwd_cuda(x, w, dout)
torch.cuda.synchronize()
tol = float(sys.argv[3]) + float(sys.argv[4]) * float(want[1].abs().max())
print(json.dumps({"dx_equal": torch.equal(dx, want[0]), "dw_err": float((dw - want[1]).abs().max()),
                  "tol": tol}))
"""


def _start_shift_fault_build(common):
    """Phase 1: starts nvcc on a copy of token_shift.cu with SHIFT_FAULT
    planted, in ``build/chip_smoke_fault/``; returns (process, library)."""
    src = common.KERNEL_SOURCES["token_shift"]
    text = src.read_text()
    if text.count(SHIFT_FAULT[0]) != 1:
        raise SystemExit("the token shift's planted fault no longer matches its source")
    out = common.BUILD_DIR / "chip_smoke_fault"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / "token_shift_fault.cu", out / "libtoken_shift_fault.so"
    cu.write_text(text.replace(*SHIFT_FAULT))
    so.unlink(missing_ok=True)
    proc = subprocess.Popen([common._nvcc(), *common._NVCC_FLAGS, "-o", str(so), str(cu)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    atexit.register(lambda: proc.poll() is None and proc.kill())   # a run that stops early
    return proc, so


def _shift_fault_check(torch, common, fault):
    """Phase 2c: the planted fault's launch, in a process of its own, must
    fail the check that the good library, in another, passes."""
    proc, so = fault
    report, _ = proc.communicate()
    if proc.returncode != 0:
        raise SystemExit(f"the token shift's planted fault did not build:\n{report}")
    atol, rtol = GRAD_TOLERANCE["float32"]
    outcome = {}
    for name, lib in (("fault", so), ("good", common.build_libraries()["token_shift"])):
        run = subprocess.run([sys.executable, "-c", SHIFT_FAULT_CHECK, str(lib),
                              str(ROOT / "src"), str(atol), str(rtol)],
                             capture_output=True, text=True, timeout=300)
        if run.returncode != 0:
            lines = run.stderr.strip().splitlines() or ["?"]
            outcome[name] = (False, f"launch failed: {lines[-1][:160]}")
            continue
        got = json.loads(run.stdout.strip().splitlines()[-1])
        outcome[name] = (got["dx_equal"] and got["dw_err"] <= got["tol"],
                         f"dx equal {got['dx_equal']}, dw err {got['dw_err']:.3e} "
                         f"tol {got['tol']:.3e}")
    print(f"[grad-kernels] token shift planted fault (rank 0's dw partial dropped), each in a "
          f"process of its own: faulty library {outcome['fault'][1]}; good library "
          f"{outcome['good'][1]}")
    if outcome["fault"][0] or not outcome["good"][0]:
        raise SystemExit("the token shift's check did not tell the planted fault from the "
                         "good kernel")


def _grad_kernel_checks(torch, common, shift_fault):
    """Phase 2c.  Returns the worst max abs error of each backward kernel."""
    from repro_torch.kernels.elevator_scan.vjp import ElevatorScanFunction
    from repro_torch.kernels.local_attention.vjp import FlashAttentionFunction
    from repro_torch.kernels.token_shift.vjp import TokenShiftFunction
    from repro_torch.kernels.wkv import ops as WO

    EK, _, TS, FA = _rg_modules()
    worst = dict.fromkeys(GRAD_KERNELS, 0.0)
    t0 = time.perf_counter()

    def randn(shape, dtype, seed):
        g = torch.Generator(device="cuda").manual_seed(seed)
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    for dtype in (torch.float32, torch.bfloat16):
        cases = FLASH_GRAD_CASES + (FLASH_GRAD_F32_CASES if dtype == torch.float32 else ())
        for i, (b, hq, hkv, t, s, d, causal, window) in enumerate(cases):
            mask = dict(causal=causal, window=window)
            case = f"B={b} {hq}/{hkv} T={t} S={s} D={d} " + (
                f"W={window}" if window else "causal" if causal else "full")
            with torch.no_grad():
                q, k, v = _attn_inputs(torch, b, t, s, dtype, 700 + i, d=d, hq=hq, hkv=hkv)
                do = randn(q.shape, dtype, 800 + i)
                o, lse = FA.flash_attention_cuda(q, k, v, lse=True, **mask)
                same = torch.equal(o, FA.flash_attention_cuda(q, k, v, **mask))
                _, lse_ref = FA.attention_ref_lse(q, k, v, **mask)
                seen = torch.isfinite(lse_ref)
                lse_err = float((lse[seen] - lse_ref[seen]).abs().max())
                if not same or not torch.equal(torch.isfinite(lse), seen) or lse_err > 1e-4:
                    raise SystemExit(f"flash lse {case} {dtype}: output equal {same}, "
                                     f"lse err {lse_err}")
                got = FA.flash_attention_bwd_cuda(q, k, v, o, lse, do, **mask)
                torch.cuda.synchronize()
                want = FA.attention_bwd_ref(q, k, v, o, lse, do, **mask)
                _grad_check(torch, worst, "flash_attention_bwd_cuda", case, dtype, got, want)
                again = FA.flash_attention_bwd_cuda(q, k, v, o, lse, do, **mask)
                if not all(torch.equal(x, y) for x, y in zip(got, again)):
                    raise SystemExit("flash_attention_bwd_cuda does not repeat bit for bit")
                # Every plan of the bf16 kernels (counts no launch).
                for plan in (FA.flash_bwd_plans(b, hq, hkv, t, s, d)
                             if dtype == torch.bfloat16 else ()):
                    got = FA.launch_bwd_plan(q, k, v, o, lse, do, plan=plan, **mask)
                    _grad_check(torch, worst, "flash_attention_bwd_cuda",
                                f"{case} c={plan.cluster} st={plan.kv_stages}/{plan.dq_stages}",
                                dtype, got, want)
                    again = FA.launch_bwd_plan(q, k, v, o, lse, do, plan=plan, **mask)
                    if not all(torch.equal(x, y) for x, y in zip(got, again)):
                        raise SystemExit(f"flash_attention_bwd_cuda {plan} does not repeat "
                                         "bit for bit")
                del q, k, v, do, o, lse, lse_ref, got, want, again
            torch.cuda.empty_cache()
        print(f"[grad-kernels] flash lse {dtype}: the training forward's output equals "
              "serving's bit for bit, its lse within 1e-4 of the plain version's")

        # The scan's backward and its Function take f32 only: the model scans
        # f32 inputs.
        scan_f32 = dtype == torch.float32
        with torch.no_grad():
            for b, t in ((4, 1024), (1, 4096), (2, 1024)) if scan_f32 else ():
                a, x, h0 = _scan_inputs(torch, b, t, dtype, 900 + t)
                h = EK.elevator_scan_cuda(a, x, h0)
                dh = randn(x.shape, dtype, 901 + t)
                got = EK.elevator_scan_bwd_cuda(a, h, dh, h0)
                torch.cuda.synchronize()
                want = EK.elevator_scan_bwd_ref(a, h, dh, h0)
                _grad_check(torch, worst, "elevator_scan_bwd_cuda", f"B={b} T={t} D={RG_D}",
                            dtype, got, want, exact=(0, 1, 2))
                for plan in EK.scan_bwd_plans(b, t, RG_D):
                    _grad_check(torch, worst, "elevator_scan_bwd_cuda",
                                f"B={b} T={t} {plan.mode} cols={plan.cols}", dtype,
                                EK.launch_bwd_plan(a, h, dh, h0, plan=plan), want,
                                exact=(0, 1, 2))
            for b, t in ((4, 4), (4, 67), (4, 259), (1, 4096), (2, 1024)):
                x, w = _shift_inputs(torch, b, t, dtype, 950 + t)
                dout = randn(x.shape, dtype, 951 + t)
                got = TS.token_shift_bwd_cuda(x, w, dout)
                torch.cuda.synchronize()
                want = TS.token_shift_bwd_ref(x, w, dout)
                _grad_check(torch, worst, "token_shift_bwd_cuda", f"B={b} T={t} D={RG_D} taps=4",
                            dtype, got, want, exact=(0,))
                again = TS.token_shift_bwd_cuda(x, w, dout)
                if not all(torch.equal(p, q) for p, q in zip(got, again)):
                    raise SystemExit("token_shift_bwd_cuda does not repeat bit for bit")
                # Every plan (counts no launch): dx bit for bit, dw repeating.
                for plan in TS.shift_bwd_plans(b, t, RG_D, 4, dtype):
                    got = TS.launch_bwd_plan(x, w, dout, plan=plan)
                    _grad_check(torch, worst, "token_shift_bwd_cuda",
                                f"B={b} T={t} c={plan.cluster} g={plan.groups} r={plan.rows}",
                                dtype, got, want, exact=(0,))
                    if not torch.equal(got[1], TS.launch_bwd_plan(x, w, dout, plan=plan)[1]):
                        raise SystemExit(f"token_shift_bwd_cuda {plan} does not repeat bit for bit")
        if scan_f32:
            _shift_fault_check(torch, common, shift_fault)

        # Each Function on the card against the same Function on CPU copies.
        q, k, v = _attn_inputs(torch, 1, 512, 512, dtype, 990, hq=G3_HQ)
        got, want = _function_card_vs_cpu(
            torch, lambda *a: FlashAttentionFunction.apply(*a, True, 128, None), (q, k, v),
            (randn(q.shape, dtype, 991),))
        _grad_check(torch, {}, "FlashAttentionFunction", "B=1 4/1 T=512 D=256 W=128", dtype,
                    got, want)
        for kw, decode in ((256, False), (1, True), (8, True), (64, True)) if scan_f32 else ():
            a, x, h0 = _scan_inputs(torch, 4, kw, dtype, 992 + kw)
            got, want = _function_card_vs_cpu(
                torch, lambda a_, x_, h_, d=decode: ElevatorScanFunction.apply(a_, x_, h_, d),
                (a, x, h0), (randn(x.shape, dtype, 993 + kw),))
            _grad_check(torch, {}, "ElevatorScanFunction",
                        f"B=4 T={kw} " + ("window" if decode else "chunked"), dtype, got, want,
                        exact=(0, 1, 2))
        x, w = _shift_inputs(torch, 2, 259, dtype, 994)
        got, want = _function_card_vs_cpu(torch, TokenShiftFunction.apply, (x, w),
                                          (randn(x.shape, dtype, 995),))
        _grad_check(torch, {}, "TokenShiftFunction", "B=2 T=259", dtype, got, want, exact=(0,))
        # The WKV decode window under grad (the decode kernels forward, the
        # training forward and the reverse sweep at chunk 1 backward).
        for kw in (1, 8, 37, 64):
            a = _inputs(torch, 4, kw, dtype, seed=996 + kw)
            d_out, d_s = _cotangents(torch, 4, kw, dtype, seed=997 + kw)
            got, want = _function_card_vs_cpu(
                torch, lambda *x_: WO.wkv_fused(*x_, decode=True), a, (d_out, d_s))
            atol, rtol = TRAIN_TOLERANCE[str(dtype).split(".")[-1]]
            errs = [float((p.float().cpu() - q_.float()).abs().max()) for p, q_ in zip(got, want)]
            tols = [atol + rtol * float(q_.float().abs().max()) for q_ in want]
            ok = all(e <= t_ for e, t_ in zip(errs, tols))
            print(f"[grad-kernels] WKVDecodeFunction      B=4 K={kw:<2d} card/cpu "
                  f"{str(dtype):15s} max_abs_err {['%.2e' % e for e in errs]} tol "
                  f"{['%.2e' % t_ for t_ in tols]} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"WKV decode grads K={kw} {dtype}: {errs} > {tols}")
    torch.cuda.empty_cache()
    print(f"[time] phase 2c wall: {time.perf_counter() - t0:.1f}s")
    return worst


def _train_launch_counts(cfg, n_micro, steps):
    """The kernel launches ``steps`` train steps of ``cfg`` make, from the
    code's structure: under remat the scanned periods run their forward
    twice (the first pass and the recompute), the remainder once; every
    layer's backward once; ``n_micro`` microbatches a step."""
    from repro_torch.model.transformer import ATTN_KINDS, plan_groups

    pattern, n_periods, remainder = plan_groups(cfg)
    runs = 1 if cfg.remat == "none" else 2
    fwd = [k for k in pattern for _ in range(n_periods * runs)] + list(remainder)
    bwd = [k for k in pattern for _ in range(n_periods)] + list(remainder)
    per = {}
    for kinds, names in ((fwd, ("flash_attention_cuda", "token_shift_cuda",
                                "elevator_scan_cuda")),
                         (bwd, ("flash_attention_bwd_cuda", "token_shift_bwd_cuda",
                                "elevator_scan_bwd_cuda"))):
        per[names[0]] = sum(k in ATTN_KINDS for k in kinds)
        per[names[1]] = per[names[2]] = sum(k == "rec" for k in kinds)
    return {k: n * n_micro * steps for k, n in per.items()}


def _train_arch(torch, name, batch, seq, steps=4):
    """Phase 3n for one arch: full-size bf16 training through the port's
    entry points.  Returns the launch counts of the ``steps`` steps."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import step as TS_
    from repro_torch.tree import tree_leaves

    cfg = get_config(name)
    counters = _counters()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = TS_.init_train_state(cfg, 0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in tree_leaves(state.params))
    print(f"[train-archs] {name}: {n_params / 1e9:.3f}B params in {cfg.dtype}, state "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB, initialized in "
          f"{time.perf_counter() - t0:.1f}s; microbatch {cfg.microbatch}, remat {cfg.remat}")
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch, seed=0)
    step_fn = TS_.make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=steps))
    batches = [make_batch(dcfg, i) for i in range(steps)]
    want = _train_launch_counts(cfg, max(1, cfg.microbatch), steps)
    for fn in counters.values():
        fn.launches = 0
    losses, times = [], []
    for i in range(steps):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, m = step_fn(state, batches[i])
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
        losses.append(loss)
        print(f"[train-archs] {name} step {i}  loss {loss:.4f}  grad_norm {gnorm:.3f}  "
              f"{times[-1] * 1e3:.1f} ms  {batch * seq / times[-1]:,.0f} tok/s")
        if not math.isfinite(loss) or not math.isfinite(gnorm):
            raise SystemExit(f"{name}: non-finite loss {loss} / grad norm {gnorm}")
    launches = _nonzero({n: fn.launches for n, fn in counters.items()})
    peak = torch.cuda.max_memory_allocated()
    steady = sorted(times[1:])[len(times[1:]) // 2]
    print(f"[train-archs] {name} launches during {steps} steps: {launches}; derived "
          f"{_nonzero(want)}")
    print(f"[train-archs] {name} B={batch} T={seq}: median step (steps 1-{steps - 1}) "
          f"{steady * 1e3:.1f} ms, {batch * seq / steady:,.0f} train tok/s; first step "
          f"{times[0] * 1e3:.1f} ms; peak memory {peak / 2**30:.2f} GiB; loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}")
    if not all(bool(torch.isfinite(p).all()) for p in tree_leaves(state.params)):
        raise SystemExit(f"{name}: a parameter is not finite")
    if not losses[-1] < losses[0]:
        raise SystemExit(f"{name}: loss did not fall: {losses}")
    if launches != _nonzero(want):
        raise SystemExit(f"{name}: launch counts {launches} != derived {_nonzero(want)}")
    _profile(torch, lambda: step_fn(state, batches[0]), f"{name} train step B={batch} T={seq}",
             top=10)
    del state, batches, step_fn
    return launches


def _reduced_train_batch(cfg, dev, seed=3):
    """Two rows a microbatch of 32 tokens from the data stream, with the
    arch's extra inputs (patch embeddings and M-RoPE positions, encoder
    frames) from a seeded generator."""
    import torch

    from repro_torch.data.pipeline import DataConfig, make_batch

    b, t = 2 * max(1, cfg.microbatch), 32
    batch = make_batch(DataConfig(vocab_size=cfg.vocab_size, seq_len=t, global_batch=b,
                                  seed=seed), 0, device=dev)
    g = torch.Generator().manual_seed(seed)
    if cfg.frontend == "vision":
        batch["frontend_embeds"] = torch.randn((b, t // 4, cfg.d_model), generator=g).to(dev)
        batch["positions"] = torch.arange(t, device=dev)[None, None].expand(3, b, t)
    if cfg.is_enc_dec:
        batch["enc_embeds"] = torch.randn((b, t, cfg.d_model), generator=g).to(dev)
    return batch


def _first_moment_ratio(got, want, tol=1e-4):
    """Worst |got - want| / (tol |want| + tol max(1e-3, max|want|)) over the
    leaves: the CPU tests' GRAD_TOL check, which passes at <= 1.  After one
    step a first moment is (1 - b1) times the clipped gradient, so this holds
    each gradient leaf, sign and size, to a tolerance scaled to the leaf."""
    worst = 0.0
    for g, w in zip(got, want):
        lim = tol * w.abs() + tol * max(1e-3, float(w.abs().max()))
        worst = max(worst, float(((g - w).abs() / lim).max()))
    return worst


def _train_archs_reference_check(torch):
    """One train step of every reduced f32 arch on the card against the
    CPU, from the same weights and batch: loss and grad norm within 1e-5 /
    1e-4 relative, each gradient leaf (read from AdamW's first moment)
    within 1e-4 of the leaf's scale, parameters within 1e-5 (a first AdamW
    step moves each by at most 2 lr, so this check alone sees few faults)."""
    from repro_torch.configs.registry import get_config, list_archs
    from repro_torch.optim import adamw
    from repro_torch.train import step as TS_
    from repro_torch.tree import tree_leaves, tree_map

    for name in list_archs():
        cfg = get_config(name).reduced()
        params = TS_.init_train_state(cfg, 1, device="cpu").params
        out = {}
        for dev in ("cpu", "cuda"):
            moved = tree_map(lambda p: p.detach().to(dev, copy=True).requires_grad_(True),
                             params)
            state = TS_.TrainState(moved, adamw.init_state(moved), None)
            state, m = TS_.make_train_step(cfg)(state, _reduced_train_batch(cfg, dev))
            out[dev] = (float(m["loss"]), float(m["grad_norm"]),
                        [p.detach().cpu() for p in tree_leaves(state.params)],
                        [mu.cpu() for mu in tree_leaves(state.opt.mu)])
        (l_c, g_c, p_c, m_c), (l_g, g_g, p_g, m_g) = out["cpu"], out["cuda"]
        perr = max(float((a - b).abs().max()) for a, b in zip(p_g, p_c))
        mratio = _first_moment_ratio(m_g, m_c)
        ok = (abs(l_g - l_c) <= 1e-5 * abs(l_c) and abs(g_g - g_c) <= 1e-4 * abs(g_c)
              and mratio <= 1.0 and perr <= 1e-5)
        print(f"[reference] reduced f32 {name} train step, card vs CPU: loss {l_g:.6f} vs "
              f"{l_c:.6f}, grad norm {g_g:.6f} vs {g_c:.6f}, gradient leaves (first "
              f"moments) at {mratio:.3f} of their tolerance, params max_abs_err {perr:.2e} "
              f"(tol 1e-5) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"card and CPU disagree on the reduced {name} train step")


def _train_lm_on_card(torch):
    """``repro_torch.examples.train_lm`` on the card, 4 steps at its default
    width (d_model 768: 8 query heads over 2 KV heads of 96, f32, remat
    none): exactly 8 flash forward and 8 backward launches a step."""
    from repro_torch.examples import train_lm

    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    # A new checkpoint directory each run: one that held the last run's step
    # 4 would be restored and no step would run.
    (ROOT / "build").mkdir(exist_ok=True)
    ckpt_dir = tempfile.mkdtemp(prefix="train_lm_ckpt_", dir=ROOT / "build")
    try:
        rc = train_lm.main(["--steps", "4", "--ckpt-dir", ckpt_dir])
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    launches = _nonzero({n: fn.launches for n, fn in counters.items()})
    want = {"flash_attention_cuda": 32, "flash_attention_bwd_cuda": 32}
    print(f"[train-archs] train_lm on the card: rc {rc}, {time.perf_counter() - t0:.1f}s, "
          f"launches {launches} (derived {want})")
    if rc != 0 or launches != want:
        raise SystemExit("train_lm on the card failed or launched other kernels")
    return launches


def _train_archs(torch):
    """Phase 3n.  Returns the launch counts of the full-size steps."""
    t0 = time.perf_counter()
    total = {}
    for name, batch, seq in TRAIN_ARCHS:
        _free(torch, f"phase 3n {name}")
        for k, n in _train_arch(torch, name, batch, seq).items():
            total[k] = total.get(k, 0) + n
    _free(torch, "phase 3n reduced checks")
    _train_archs_reference_check(torch)
    _train_lm_on_card(torch)
    print(f"[time] phase 3n wall: {time.perf_counter() - t0:.1f}s")
    return total


def _time_grad_kernels(torch, launches, worst):
    """Phase 4 rows of the three backward kernels: flash attention's at
    Gemma3's training shape (a microbatch of 4 rows, Hq 4 over 1 KV head of
    256, T=2048; causal, every plan timed, and window 1024) and
    RecurrentGemma's (a microbatch of 2, Hq 10 over 1, T=1024, window 2048)
    beside SDPA's backward alone (the grad of a kept graph), the scan's at
    (1, 4096, 2560) and (2, 1024, 2560) f32 in every plan, and the token
    shift's at the same two shapes in bf16, in every plan, beside
    ``conv1d_input`` plus ``conv1d_weight``."""
    import torch.nn.functional as F
    from torch.nn.grad import conv1d_input, conv1d_weight

    from repro_torch.kernels.local_attention.ref import attention_mask

    EK, _, TS, FA = _rg_modules()
    bf = torch.bfloat16
    rows = []

    def row(name, source, replaces, shape, sets, kern, plain, nbytes, flops, peak, reps,
            library=None, lib_sets=None):
        ms, call_ms = _time_ms(torch, kern, sets, reps=reps)
        plain_ms = _time_ms(torch, plain, sets[:2], reps=2)[0]
        lib_ms = _time_ms(torch, library, lib_sets, reps=reps)[0] if library else None
        b_ms, f_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
        rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches.get(name, 0), "max_abs_err": worst[name], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(b_ms, f_ms),
            "bound_by": "bytes" if b_ms >= f_ms else "operations", "library_ms": lib_ms,
            "call_ms": call_ms, "shape": shape})
        print(f"[time] {name:24s} {shape:40s} device {ms * 1e3:9.2f} us, per call "
              f"{call_ms * 1e3:9.2f} us (plain {plain_ms * 1e3:10.1f} us, bound "
              f"{rows[-1]['bound_ms'] * 1e3:.2f} us by {rows[-1]['bound_by']}"
              + (f", library {lib_ms * 1e3:.2f} us" if lib_ms else "") + ")")

    with torch.no_grad():
        d = RG_DH
        for b, t, hq, window, arch in ((4, 2048, G3_HQ, None, "gemma3"),
                                       (4, 2048, G3_HQ, G3_WINDOW, "gemma3"),
                                       (2, 1024, RG_HQ, RG_WINDOW, "recurrentgemma")):
            mask = dict(causal=True, window=window)

            def make(seed, mask=mask, b=b, t=t, hq=hq):
                q, k, v = _attn_inputs(torch, b, t, t, bf, 1100 + seed, hq=hq)
                g = torch.Generator(device="cuda").manual_seed(1200 + seed)
                do = torch.randn(q.shape, generator=g, device="cuda").to(bf)
                o, lse = FA.flash_attention_cuda(q, k, v, lse=True, **mask)
                return q, k, v, o, lse, do

            one = make(0)
            nbytes = _nbytes(one) + _nbytes(one[:3])          # inputs, then dq, dk, dv
            sets = _cold_sets(make, nbytes)
            pairs = _visible_pairs(t, t, True, window)
            flops = 10 * d * hq * b * pairs                    # S, dP, dV, dK, dQ
            # The library: SDPA's backward alone, the grad of a kept graph
            # (the same mask; causal on K/V repeated to the 4 heads).
            am = None if window is None else attention_mask(t, t, causal=True, window=window,
                                                            device="cuda")
            lib_sets = []
            with torch.enable_grad():
                for q, k, v, _, _, do in sets:
                    if window is None:
                        k, v = (x.expand(-1, hq, -1, -1).contiguous() for x in (k, v))
                    q_, k_, v_ = (x.detach().requires_grad_(True) for x in (q, k, v))
                    out = F.scaled_dot_product_attention(q_, k_, v_, attn_mask=am,
                                                         is_causal=window is None,
                                                         enable_gqa=window is not None)
                    lib_sets.append((out, q_, k_, v_, do))

            def sdpa_bwd(out, q_, k_, v_, do):
                return torch.autograd.grad(out, (q_, k_, v_), do, retain_graph=True)

            kern = FA.flash_attention_bwd_cuda
            got = kern(*sets[0], **mask)
            ref = sdpa_bwd(*lib_sets[0])
            if window is None:
                ref = (ref[0], ref[1].sum(1, keepdim=True), ref[2].sum(1, keepdim=True))
            agree = [float((a.float() - r.float()).abs().max()) / float(r.float().abs().max())
                     for a, r in zip(got, ref)]
            print(f"[time] SDPA backward agrees with flash_attention_bwd_cuda W={window}: "
                  f"max err / max|SDPA| per output {['%.2e' % a for a in agree]}; backend: "
                  f"{_sdpa_backend(torch, sdpa_bwd, lib_sets[0])}")
            row("flash_attention_bwd_cuda",
                "src/repro_torch/kernels/local_attention/csrc/flash_attention_bwd.cu",
                "src/repro/kernels/local_attention/kernel.py:137 (flash_attention_pallas: "
                "its backward, which has no Pallas counterpart)",
                f"B={b} Hq={hq} Hkv=1 T={t} D={d} " + (f"W={window}" if window else "causal")
                + f" bf16 ({arch} training)", sets,
                lambda *a, m=mask: kern(*a, **m),
                lambda *a, m=mask: FA.attention_bwd_ref(*a, **m),
                nbytes, flops, PEAK_BF16_FLOPS, reps=10, library=sdpa_bwd, lib_sets=lib_sets)
            if window is None:
                rows[-1]["plans"] = {
                    f"cluster={p.cluster} stages={p.kv_stages}/{p.dq_stages}": round(1e3 * _time_ms(
                        torch, lambda *a, p=p, m=mask: FA.launch_bwd_plan(*a, plan=p, **m), sets,
                        reps=10)[0], 2)
                    for p in FA.flash_bwd_plans(b, hq, 1, t, t, d)}
                print(f"[time] flash_attention_bwd_cuda plans (device us): {rows[-1]['plans']}")
            del sets, lib_sets, one
            torch.cuda.empty_cache()

        for b, t in ((1, 4096), (2, 1024)):

            def make_scan(seed, b=b, t=t):
                a, x, h0 = _scan_inputs(torch, b, t, torch.float32, 1300 + seed)
                h = EK.elevator_scan_cuda(a, x, h0)
                dh = torch.randn(x.shape, device="cuda")
                return a, h, dh, h0

            one = make_scan(0)
            nbytes = _nbytes(one) + _nbytes(one[:2]) + _nbytes(one[3:])   # da, dx, dh0 out
            sets = _cold_sets(make_scan, nbytes)
            row("elevator_scan_bwd_cuda",
                "src/repro_torch/kernels/elevator_scan/csrc/elevator_scan.cu",
                "src/repro/kernels/elevator_scan/kernel.py:78 (elevator_scan_pallas: its "
                "backward, which has no Pallas counterpart)", f"B={b} T={t} D={RG_D} f32",
                sets, EK.elevator_scan_bwd_cuda, EK.elevator_scan_bwd_ref,
                nbytes, 3 * b * t * RG_D, PEAK_F32_FLOPS, reps=20)
            rows[-1]["plans"] = {
                f"{p.mode} cols={p.cols} stages={p.stages}": round(1e3 * _time_ms(
                    torch, lambda *a, p=p: EK.launch_bwd_plan(*a, plan=p), sets, reps=20)[0], 2)
                for p in EK.scan_bwd_plans(b, t, RG_D)}
            print(f"[time] elevator_scan_bwd_cuda plans (device us): {rows[-1]['plans']}")
            del sets, one
        for b, t in ((1, 4096), (2, 1024)):

            def make_shift(seed, b=b, t=t):
                x, w = _shift_inputs(torch, b, t, bf, 1400 + seed)
                return x, w, torch.randn(x.shape, device="cuda").to(bf)

            one = make_shift(0)
            nbytes = _nbytes(one) + _nbytes(one[:2])                    # dx, dw out
            sets = _cold_sets(make_shift, nbytes)
            taps = one[1].shape[0]
            # The library: the input and weight grads of the depthwise conv1d
            # on the (B, D, T) layout, padded taps - 1 on the left (phase 4's
            # forward yardstick), from dout padded to the conv's full length.
            lib_sets = [(x.transpose(1, 2).contiguous(), w.t().flip(1)[:, None].contiguous(),
                         F.pad(dout.transpose(1, 2), (0, taps - 1)).contiguous())
                        for x, w, dout in sets]

            def conv_bwd(xt, wt, gpad, taps=taps):
                return (conv1d_input(xt.shape, wt, gpad, padding=taps - 1, groups=RG_D),
                        conv1d_weight(xt, wt.shape, gpad, padding=taps - 1, groups=RG_D))

            dx, dw = TS.token_shift_bwd_cuda(*sets[0])
            ldx, ldw = conv_bwd(*lib_sets[0])
            agree = (float((ldx.transpose(1, 2).float() - dx.float()).abs().max()),
                     float((ldw[:, 0].flip(1).t().float() - dw.float()).abs().max()))
            print(f"[time] conv1d_input + conv1d_weight agree with token_shift_bwd_cuda at "
                  f"B={b} T={t}: max_abs_err dx {agree[0]:.3e}, dw {agree[1]:.3e}")
            row("token_shift_bwd_cuda", "src/repro_torch/kernels/token_shift/csrc/token_shift.cu",
                "src/repro/kernels/token_shift/kernel.py:55 (token_shift_pallas: its backward, "
                "which has no Pallas counterpart)", f"B={b} T={t} D={RG_D} taps={taps} bf16",
                sets, TS.token_shift_bwd_cuda, TS.token_shift_bwd_ref, nbytes,
                4 * taps * b * t * RG_D, PEAK_F32_FLOPS, reps=50, library=conv_bwd,
                lib_sets=lib_sets)
            rows[-1]["plans"] = {
                f"cluster={p.cluster} groups={p.groups} rows={p.rows}": round(1e3 * _time_ms(
                    torch, lambda *a, p=p: TS.launch_bwd_plan(*a, plan=p), sets, reps=50)[0], 2)
                for p in TS.shift_bwd_plans(b, t, RG_D, taps, bf)}
            print(f"[time] token_shift_bwd_cuda plans (device us): {rows[-1]['plans']}")
            del sets, lib_sets, one
    # The result line's row of flash attention's backward is Gemma3's causal
    # one, the scan's and the token shift's the (1, 4096) ones; the other
    # shapes ride along under "large".
    extra = []
    for name in ("flash_attention_bwd_cuda", "elevator_scan_bwd_cuda", "token_shift_bwd_cuda"):
        mine = [r for r in rows if r["name"] == name]
        mine[0]["large"] = [{k: r[k] for k in ("shape", "ms", "call_ms", "plain_ms", "bound_ms",
                                               "bound_by", "library_ms", "plans") if k in r}
                            for r in mine[1:]]
        extra += mine[1:]
    return [r for r in rows if r not in extra]


# ---------------------------------------------------------------------------
# The one-card dry run held against the card (phase 3o).
# ---------------------------------------------------------------------------

#: The cells the dry run must mark as fitting one card, and only these.
FITTING_CELLS = (("rwkv6-1.6b", "decode_32k"), ("recurrentgemma-2b", "decode_32k"),
                 ("gemma3-1b", "decode_32k"), ("qwen2-0.5b", "decode_32k"),
                 ("rwkv6-1.6b", "long_500k"), ("recurrentgemma-2b", "long_500k"),
                 ("gemma3-1b", "long_500k"))
#: The peak's tolerance: 5% of the traced peak or 256 MiB, the larger.
PEAK_REL, PEAK_ABS = 0.05, 256 * 2**20
#: What the caching allocator may add to the rounded bytes of the state: it
#: hands out a whole cached block where the tail a split would leave is
#: under 1 MiB, so ``memory_allocated()`` can exceed the rounded sum by the
#: unsplit tails (its ``requested_bytes`` counter is exact).
TAIL_SHARE = 0.005


def _requested(torch):
    """The bytes the live allocations asked the caching allocator for."""
    n = torch.cuda.memory_stats().get("requested_bytes.all.current")
    if n is None:
        raise SystemExit("this PyTorch's allocator reports no requested_bytes")
    return n


def _hold_cell(torch, DR, arch, shape, row, counters, steps=5):
    """Phase 3o (b) for one cell: build it on the card, hold its state
    bytes, one step's launches, aten FLOPs and peak to the dry run's row,
    then time ``steps`` steps after a warm-up."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs.registry import get_config

    mem = row["memory"]
    torch.cuda.synchronize()
    base, base_req = torch.cuda.memory_allocated(), _requested(torch)
    cell = DR.make_cell(get_config(arch), shape, device="cuda", seed=0)
    torch.cuda.synchronize()
    state = torch.cuda.memory_allocated() - base
    state_req = _requested(torch) - base_req
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    with FlopCounterMode(display=False) as fc:
        logits, _ = cell.run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    launches = {n: fn.launches for n, fn in counters.items() if fn.launches}
    aten = sum(row["cost"]["aten_flops"].values())
    traced_peak = mem["peak_live_bytes"]
    tol = max(PEAK_REL * traced_peak, PEAK_ABS)
    finite = bool(torch.isfinite(logits).all())
    print(f"[dry] {arch} {shape} on the card: state requested {state_req} B (dry run "
          f"{mem['state_bytes']} B), allocated {state} B (dry run "
          f"{mem['state_bytes_allocated']} B rounded to 512; the allocator's unsplit "
          f"block tails {state - mem['state_bytes_allocated']} B); "
          f"launches {launches} (dry run {row['launches']}); aten FLOPs {fc.get_total_flops()} "
          f"(dry run {aten}); peak over the state {peak / 2**30:.3f} GiB (dry run "
          f"{traced_peak / 2**30:.3f} GiB, tolerance {tol / 2**30:.3f}); logits "
          f"{tuple(logits.shape)} finite: {finite}")
    if state_req != mem["state_bytes"]:
        raise SystemExit(f"dry run {arch} {shape}: state requested {state_req} != "
                         f"{mem['state_bytes']}")
    if not 0 <= state - mem["state_bytes_allocated"] <= TAIL_SHARE * mem["state_bytes"]:
        raise SystemExit(f"dry run {arch} {shape}: state allocated {state} against "
                         f"{mem['state_bytes_allocated']} rounded")
    if launches != row["launches"]:
        raise SystemExit(f"dry run {arch} {shape}: launches {launches} != {row['launches']}")
    if fc.get_total_flops() != aten:
        raise SystemExit(f"dry run {arch} {shape}: aten FLOPs {fc.get_total_flops()} != {aten}")
    if abs(peak - traced_peak) > tol:
        raise SystemExit(f"dry run {arch} {shape}: peak {peak} vs traced {traced_peak}")
    if not finite or tuple(logits.shape) != (cell.shape.global_batch, 1, cell.cfg.padded_vocab):
        raise SystemExit(f"dry run {arch} {shape}: logits {tuple(logits.shape)} finite {finite}")
    del logits
    cell.run()                                        # warm-up
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(steps):
        cell.run()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / steps
    r = row["roofline"]
    bound_ms = max(r["compute_s"], r["memory_s"], r["collective_s"]) * 1e3
    fused_ms = max(r["compute_s"], r["memory_analytic_s"]) * 1e3
    mfu = row["model_flops"] / (ms * 1e-3) / 989e12
    print(f"[dry] {arch} {shape}: {ms:.3f} ms a step (B={cell.shape.global_batch}, "
          f"S={cell.shape.seq_len}); roofline bound {bound_ms:.3f} ms by traced bytes "
          f"({r['dominant']}), {fused_ms:.3f} ms fused ({r['dominant_fused']}); memory term "
          f"{r['memory_s'] * 1e3 / ms:.3f} of the step traced, "
          f"{r['memory_analytic_s'] * 1e3 / ms:.4f} fused; model_flops / time / 989e12 = "
          f"{mfu:.2e}")
    _profile(torch, cell.run, f"{arch} {shape} decode step", top=6)
    del cell
    gc.collect()
    torch.cuda.empty_cache()
    return {"ms": ms, "bound_ms": bound_ms, "fused_ms": fused_ms, "mfu": mfu}


def _dry_run_holds(torch, g3_split, train_launches, train_steps):
    """Phase 3o."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_config, list_archs
    from repro_torch.core.lowering import cost_counting
    from repro_torch.launch import dryrun as DR

    t0 = time.perf_counter()
    # (a) the dry run of the decode cells.
    rows = {}
    for shape in ("decode_32k", "long_500k"):
        for arch in list_archs():
            name = get_config(arch).name
            rows[(name, shape)] = DR.run_cell(name, shape)
    failed = [k for k, r in rows.items() if not r["ok"]]
    if failed:
        raise SystemExit(f"dry run: cells failed: {failed}")
    fits = tuple(k for k, r in rows.items() if r.get("memory", {}).get("fits_one_card"))
    print(f"[dry] cells that fit one card: {fits}; dry run {time.perf_counter() - t0:.1f}s")
    if sorted(fits) != sorted(FITTING_CELLS):
        raise SystemExit(f"dry run: fitting cells {fits} != {FITTING_CELLS}")
    # (b) each fitting cell on the card.
    counters = _counters()
    for arch, shape in FITTING_CELLS:
        _hold_cell(torch, DR, arch, shape, rows[(arch, shape)], counters)
    # (c) the Functions' and the forward's meta branches against phases 3h and 3b.
    cfg = get_config("gemma3-1b")
    with cost_counting() as c:
        DR.make_cell(cfg, ShapeConfig("phase 3h scoring", 4096, 1, "prefill")).run()
    plans = c.kernels["flash_attention_cuda"].plans
    split = {"window": plans.get(repr((("causal", True), ("window", cfg.attn_window))), 0),
             "causal": plans.get(repr((("causal", True), ("window", None))), 0)}
    print(f"[dry] meta trace of phase 3h's scoring B=1 T=4096: {c.launches()}, by mask "
          f"{split}; the card's {g3_split}")
    if split != g3_split or c.launches() != {"flash_attention_cuda": sum(g3_split.values())}:
        raise SystemExit(f"dry run: gemma3 scoring flash {plans} != the card's {g3_split}")
    cfg = get_config("rwkv6-1.6b")
    with cost_counting() as c:
        DR.make_cell(cfg, ShapeConfig("phase 3b train", 256, 8, "train")).run()
    per_step = {k: n // train_steps for k, n in train_launches.items()}
    print(f"[dry] meta trace of phase 3b's train step B=8 T=256: {c.launches()}; the card's "
          f"{per_step} a step ({train_launches} over {train_steps} steps)")
    if c.launches() != per_step or any(n % train_steps for n in train_launches.values()):
        raise SystemExit(f"dry run: rwkv6 train step {c.launches()} != the card's {per_step}")
    print(f"[time] phase 3o wall: {time.perf_counter() - t0:.1f}s")


# ---------------------------------------------------------------------------
# Expert parallelism on a (data, model) mesh of the one card and the
# collectives pass on the card (phase 3p).
# ---------------------------------------------------------------------------

#: (B, T) of phase 3p's scoring: dbrx-132b's 4 prefill chunks of 2
#: sequences; qwen3-moe's 8 chunks take B=16, so that each chunk holds the
#: 2 sequences a data extent of 2 splits (at phase 3l's B=8 a chunk is one
#: sequence and the exchange would fall back to the gather path).
A2A_SCORE = {"dbrx-132b": (8, 1024), "qwen3-moe-235b-a22b": (16, 1024)}
#: The a2a against the gather path, both bf16 at a capacity of E / k
#: (nothing drops on either path), on the a2a's own inputs of every MoE
#: call: its routing is ``_topk_routing``'s of those inputs but where the
#: k-th and (k+1)-th router logits lie within the most two f32 summation
#: orders can part them (2 D 2**-24 sum_d |h_d w_de|: the a2a routes a
#: shard's rows, a matmul of another shape), and at every token routed
#: alike |a2a - gather| <= A2A_RTOL |gather| + A2A_ATOL rms(token's
#: gather row): the same products on buffers of other shapes (cuBLAS
#: picks its kernel by shape) round to bf16 an ulp (2**-8..2**-7 of the
#: element) apart, and a sum over F or k that cancels keeps an error of
#: its terms' size, about 2**-8 of the row's RMS.
A2A_RTOL = 2 ** -7
A2A_ATOL = 2 ** -6
#: End to end those ulps drift each layer's inputs, and a router whose
#: k-th and (k+1)-th logits lie closer than twice the drift routes a token
#: otherwise (O(1) on its logits and, through attention, on later
#: positions of its sequence).  Every token routed otherwise must be such
#: a near-tie (its gather logit gap <= 2 x the drift of its logits + the
#: f32 term above), and the positions before the first token routed
#: otherwise in their sequence, whose whole causal history is ulp drift,
#: agree within A2A_CLEAN_TOL x rms(their gather logits): a few 2**-8 a
#: layer over 4 layers, the tail of 100k-150k logits a position.
A2A_CLEAN_TOL = 2 ** -3
A2A_MESH = (2, 4)


def _a2a_scoring(torch, np, name):
    """One MoE arch at full width and MOE_DEPTH layers (bf16, seed 0):
    scoring through ``make_prefill_step`` on the gather path and with
    ``moe_impl="a2a"`` under the ``prefill`` rules of a (data=2, model=4)
    mesh of the one card.  At a capacity factor of E / k nothing drops and,
    on each MoE call's own inputs and end to end, the a2a agrees with the
    gather path as A2A_RTOL, A2A_ATOL and A2A_CLEAN_TOL say; at the config's own factor each
    path's dropped share is printed, two a2a runs are bit-identical, and
    the exchanges equal their closed form: 2 a layer and a chunk, each
    logged once a data row, (tp - 1) / tp of a shard's (E, cap, D) buffer
    leaving each shard.  Flash launches are held to one a layer and a chunk
    on both paths.  Wall time of each, and the profiler's device time."""
    import contextlib

    from repro_torch.configs.registry import get_config
    from repro_torch.core.device_comm import record_hops
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.model import model as M
    from repro_torch.model import moe as MOE
    from repro_torch.model import moe_a2a as A2A
    from repro_torch.model.moe_a2a import a2a_capacity
    from repro_torch.model.sharding import make_rules, sharding_context
    from repro_torch.serve.engine import make_prefill_step

    cfg = dataclasses.replace(get_config(name), num_layers=MOE_DEPTH)
    tag = f"[a2a {cfg.name}]"
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    dp, tp = A2A_MESH
    mesh = make_debug_mesh(dp, tp)
    rules = make_rules(mesh, "prefill")
    sb, st = A2A_SCORE[name]
    chunks = cfg.prefill_chunks
    n_loc = sb // chunks // dp * (st // tp)
    params = M.init_params(cfg, seed=0, device="cuda")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                                (sb, st))).cuda()
    counters = _counters()
    routes = []
    real_dispatch = MOE.dispatch

    def recording_dispatch(*a, **kw):
        r = real_dispatch(*a, **kw)
        routes.append(((r.slot == e * r.cap).sum(), r.expert))
        return r

    def step_of(impl, cf):
        c = dataclasses.replace(cfg, moe_impl=impl, moe_capacity_factor=cf)
        ctx = sharding_context(mesh, rules) if impl == "a2a" else contextlib.nullcontext()
        return make_prefill_step(c), ctx

    def score(impl, cf):
        step, ctx = step_of(impl, cf)
        routes.clear()
        MOE.dispatch = recording_dispatch
        try:
            with torch.inference_mode(), ctx, record_hops() as hops:
                out, dt, got = _counted(torch, counters, lambda: step(params, tokens))
        finally:
            MOE.dispatch = real_dispatch
        want = {**dict.fromkeys(counters, 0), "flash_attention_cuda": cfg.num_layers * chunks}
        if got != want:
            raise SystemExit(f"{tag} {impl} cf {cf}: launches {got} != {want}")
        fin = bool(torch.isfinite(out[..., :cfg.vocab_size]).all())
        if out.shape != (sb, st, cfg.padded_vocab) or not fin:
            raise SystemExit(f"{tag} {impl} cf {cf}: bad logits {tuple(out.shape)}")
        dropped = int(sum(int(d) for d, _ in routes))
        return out, dt, list(hops), dropped, sb * st * k

    def hold_hops(hops, cf):
        cap = a2a_capacity(n_loc, dataclasses.replace(cfg, moe_capacity_factor=cf))
        each = (tp - 1) * (e * cap * cfg.d_model) // tp
        want = [("all_to_all", each)] * (2 * dp * cfg.num_layers * chunks)
        got = [(h.kind, h.elements) for h in hops]
        print(f"{tag} cf {cf:g}: {len(hops)} exchanges logged (2 a layer and a chunk x {dp} "
              f"data rows x {cfg.num_layers} layers x {chunks} chunks), {each} elements "
              f"leaving each of the {tp} shards in each (E={e} x cap {cap} x D={cfg.d_model} "
              f"x {tp - 1}/{tp}); closed form held: {got == want}")
        if got != want:
            raise SystemExit(f"{tag} cf {cf}: exchanges {got[:4]}... != closed form")

    # 1. No drop on either path: a capacity factor of E / k.  Each scoring
    # keeps every MoE call's input, output and expert sets (at the tokens'
    # places: the a2a's routes come a shard at a time, data row major).
    cf_all = e / k
    c_all = dataclasses.replace(cfg, moe_impl="a2a", moe_capacity_factor=cf_all)
    kept = {"gather": [], "a2a": []}
    real_apply, real_sharded = MOE.apply_moe, A2A.apply_moe_sharded

    def keeping(impl, real):
        def run(p, h, c, **kw):
            start = len(routes)
            out = real(p, h, c, **kw)
            ex = [r for _, r in routes[start:]]
            b, t = h.shape[:2]
            if len(ex) == 1:
                placed = ex[0].reshape(b, t, k)
            else:
                placed = torch.stack([r.reshape(b // dp, t // tp, k) for r in ex])
                placed = placed.reshape(dp, tp, b // dp, t // tp, k).permute(
                    0, 2, 1, 3, 4).reshape(b, t, k)
            kept[impl].append((p, h.clone(), out.clone(), placed.sort(-1).values))
            return out
        return run

    MOE.apply_moe = keeping("gather", real_apply)
    try:
        ref, _, hops, dr_g, tot = score("gather", cf_all)
    finally:
        MOE.apply_moe = real_apply
    if hops:
        raise SystemExit(f"{tag}: the gather path made {len(hops)} hops")
    A2A.apply_moe_sharded = keeping("a2a", real_sharded)
    try:
        got, _, hops, dr_a, _ = score("a2a", cf_all)
    finally:
        A2A.apply_moe_sharded = real_sharded
    hold_hops(hops, cf_all)
    w = _a2a_witness(torch, kept, ref, got, cfg, c_all, real_apply)
    del kept
    print(f"{tag} scoring B={sb} T={st} in {chunks} chunks at cf E/k = {cf_all:g}: dropped "
          f"{dr_g} (gather) and {dr_a} (a2a) of {tot} assignments")
    print(f"{tag} on the a2a's own inputs of its {w['calls']} MoE calls: {w['own_off']} "
          f"tokens routed otherwise than _topk_routing routes them ({w['own_ties']} at an f32 "
          f"near-tie); outputs at tokens routed alike at {w['own_ratio']:.4f} of the "
          f"tolerance {A2A_RTOL:g} |gather| + {A2A_ATOL:g} rms(row) (max_abs_err "
          f"{w['own_err']:.4f}, row rms median {w['rms_med']:.4f}, largest output "
          f"{w['own_scale']:.2f})")
    print(f"{tag} the two scorings routed {w['moved']} (token, layer) pairs otherwise "
          f"({w['by_layer']} a layer), {w['explained']} of them near-ties "
          f"(the gather's k-th to (k+1)-th logit gap <= 2 x the drift of the token's router "
          f"logits + the f32 term; largest gap / that bound {w['gap_ratio']:.3f}, median drift "
          f"{w['drift_med']:.2e}); {w['positions']} of {sb * st} positions routed otherwise "
          f"in some layer")
    print(f"{tag} logits end to end: {w['clean']} positions before their sequence's first "
          f"token routed otherwise agree at {w['clean_ratio']:.4f} of {A2A_CLEAN_TOL:g} x "
          f"rms(their logits) (max_abs_err {w['clean_err']:.4f}); after it: max_abs_err "
          f"{w['after_err']:.4f}, mean {w['after_mean']:.5f}; argmax equal at "
          f"{100 * w['agree']:.3f}% of positions, {w['x_clean']} of the {w['x']} that differ "
          f"before a first token routed otherwise")
    if (dr_g or dr_a or w["own_off"] != w["own_ties"] or w["own_ratio"] > 1
            or w["moved"] != w["explained"] or w["clean"] == 0 or w["clean_ratio"] > 1):
        raise SystemExit(f"{tag}: a2a and gather disagree without drops")
    del ref, got

    # 2. The config's own capacity factor: drops, repeats, times.
    cf = cfg.moe_capacity_factor
    g1, dt_g, _, dr_g, _ = score("gather", cf)
    a1, dt_a, hops, dr_a, _ = score("a2a", cf)
    hold_hops(hops, cf)
    a2, dt_a2, _, _, _ = score("a2a", cf)
    same = torch.equal(a1, a2)
    print(f"{tag} cf {cf:g}: dropped share gather {100 * dr_g / tot:.3f}% ({dr_g} of {tot}, "
          f"the capacity counts a chunk's tokens), a2a {100 * dr_a / tot:.3f}% ({dr_a}, "
          f"a shard's {n_loc} tokens: {a2a_capacity(n_loc, dataclasses.replace(cfg, moe_capacity_factor=cf))} rows an expert); two "
          f"a2a runs bit-identical: {same}")
    print(f"{tag} wall: gather {dt_g * 1e3:.1f} ms, a2a {dt_a * 1e3:.1f} / {dt_a2 * 1e3:.1f} ms "
          f"(the {dp * tp} shards of one card take turns: a baseline)")
    del g1, a1, a2
    if not same:
        raise SystemExit(f"{tag}: two a2a scorings of the same tokens differ")
    for impl in ("gather", "a2a"):
        step, ctx = step_of(impl, cf)
        with torch.inference_mode(), ctx:
            _profile(torch, lambda: step(params, tokens),
                     f"{cfg.name} {impl} scoring B={sb} T={st} cf {cf:g}", top=6)
    del params
    torch.cuda.empty_cache()


def _a2a_witness(torch, kept, ref, got, cfg, c_all, apply_moe):
    """Phase 3p's a2a against the gather path at a capacity of E / k, from
    each scoring's kept MoE calls ((params, input, output, sorted expert
    sets (b, t, k)), chunk major) and its logits: (1) on the a2a's own
    inputs, its routing against ``_topk_routing``'s and its outputs
    against the gather path's (``apply_moe``); (2) each (token, layer) the
    two scorings route otherwise against its router's near-tie bound; (3)
    the logits of the positions before their sequence's first token routed
    otherwise, and of those after."""
    from repro_torch.model import moe as MOE

    k, layers = cfg.num_experts_per_tok, cfg.num_layers
    sb, st = ref.shape[:2]
    n_calls = len(kept["a2a"])
    if n_calls != len(kept["gather"]) or n_calls != layers * cfg.prefill_chunks:
        raise SystemExit(f"[a2a {cfg.name}] kept {len(kept['gather'])} / {n_calls} MoE calls, "
                         f"want {layers * cfg.prefill_chunks}")
    w = dict(calls=n_calls, own_off=0, own_ties=0, own_ratio=0.0, own_err=0.0,
             own_scale=0.0, moved=0, explained=0, gap_ratio=0.0, by_layer=[0] * layers)
    rms_all, drifts = [], []
    rerouted = torch.zeros(sb, st, dtype=torch.bool, device=ref.device)
    tiny = torch.finfo(torch.float32).tiny
    with torch.inference_mode():
        for i, ((p, h_g, _, ex_g), (_, h_a, y_a, ex_a)) in enumerate(
                zip(kept["gather"], kept["a2a"])):
            b, t, d = h_a.shape
            w_r = p["router"].float()
            ha = h_a.reshape(b * t, d).float()
            s_a = ha @ w_r
            # The most two f32 summation orders of one router logit part.
            eps = 2 * d * 2 ** -24 * (ha.abs() @ w_r.abs()).amax(-1)
            top_a = s_a.sort(-1, descending=True).values
            off = (ex_a.reshape(b * t, k) != MOE._topk_routing(s_a, k)[1].sort(-1).values
                   ).any(-1)
            w["own_off"] += int(off.sum())
            w["own_ties"] += int((off & (top_a[:, k - 1] - top_a[:, k] <= 2 * eps)).sum())
            y_g = apply_moe(p, h_a, c_all).float().reshape(b * t, d)
            rms = y_g.pow(2).mean(-1, keepdim=True).sqrt()
            err = (y_a.float().reshape(b * t, d) - y_g).abs()[~off]
            tol = (A2A_RTOL * y_g.abs() + A2A_ATOL * rms)[~off]
            w["own_ratio"] = max(w["own_ratio"], float((err / tol.clamp_min(tiny)).max()))
            w["own_err"] = max(w["own_err"], float(err.max()))
            w["own_scale"] = max(w["own_scale"], float(y_g.abs().max()))
            rms_all.append(rms.flatten())
            del y_g, err, tol
            moved = (ex_a != ex_g).any(-1).reshape(b * t)
            if bool(moved.any()):
                s_g = h_g.reshape(b * t, d).float() @ w_r
                top_g = s_g.sort(-1, descending=True).values
                gap = (top_g[:, k - 1] - top_g[:, k])[moved]
                drift = (s_a - s_g).abs().amax(-1)[moved]
                bound = 2 * (drift + eps[moved])
                w["moved"] += int(moved.sum())
                w["explained"] += int((gap <= bound).sum())
                w["gap_ratio"] = max(w["gap_ratio"], float((gap / bound).max()))
                w["by_layer"][i % layers] += int(moved.sum())
                drifts.append(drift)
                c = i // layers
                rerouted[c * b:(c + 1) * b] |= moved.reshape(b, t)
    w["rms_med"] = float(torch.cat(rms_all).median())
    w["drift_med"] = float(torch.cat(drifts).median()) if drifts else 0.0
    w["positions"] = int(rerouted.sum())
    pos = torch.arange(st, device=ref.device)
    first = torch.where(rerouted.any(-1), rerouted.float().argmax(-1), st)
    clean = pos[None, :] < first[:, None]
    w.update(clean=int(clean.sum()), clean_ratio=0.0, clean_err=0.0, after_err=0.0, x=0,
             x_clean=0)
    after_sum, after_n, v = 0.0, 0, cfg.vocab_size
    for i in range(sb):
        r, g, c = ref[i, :, :v].float(), got[i, :, :v].float(), clean[i]
        diff = (g - r).abs()
        per = diff.amax(-1)
        if bool(c.any()):
            rms = r.pow(2).mean(-1).sqrt()
            w["clean_ratio"] = max(w["clean_ratio"],
                                   float((per[c] / (A2A_CLEAN_TOL * rms[c])).max()))
            w["clean_err"] = max(w["clean_err"], float(per[c].max()))
        if not bool(c.all()):
            w["after_err"] = max(w["after_err"], float(per[~c].max()))
            after_sum += float(diff[~c].sum())
            after_n += int((~c).sum()) * v
        xd = r.argmax(-1) != g.argmax(-1)
        w["x"] += int(xd.sum())
        w["x_clean"] += int((xd & c).sum())
        del r, g, diff
    w["after_mean"] = after_sum / max(after_n, 1)
    w["agree"] = 1 - w["x"] / (sb * st)
    return w


def _a2a_reference_check(torch, np):
    """The reduced f32 dbrx and qwen3-moe with ``moe_impl="a2a"`` on a
    (2, 4) mesh of the card against the same on a (2, 4) mesh of "cpu"
    shards, from the same weights: forward logits at (2, 64) within 1e-4
    under the ``prefill`` rules, and one ``make_train_step`` step under the
    ``train`` rules with the loss, grad norm, gradient leaves (AdamW's
    first moments) and parameters held as ``_train_archs_reference_check``
    holds them; the exchanges of both runs logged and equal."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.device_comm import record_hops
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.model import model as M
    from repro_torch.model.sharding import make_rules, sharding_context
    from repro_torch.optim import adamw
    from repro_torch.train import step as TS_
    from repro_torch.tree import tree_leaves, tree_map

    for name in A2A_SCORE:
        cfg = dataclasses.replace(get_config(name).reduced(), moe_impl="a2a")
        params = TS_.init_train_state(cfg, 1, device="cpu").params
        toks = torch.from_numpy(np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 64)))
        out = {}
        for dev in ("cpu", "cuda"):
            mesh = make_debug_mesh(*A2A_MESH, device=dev)
            moved = tree_map(lambda p: p.detach().to(dev, copy=True).requires_grad_(True),
                             params)
            with (torch.inference_mode(), sharding_context(mesh, make_rules(mesh, "prefill")),
                  record_hops() as fwd_hops):
                logits = M.forward(moved, cfg, toks.to(dev)).cpu()
            state = TS_.TrainState(moved, adamw.init_state(moved), None)
            with sharding_context(mesh, make_rules(mesh, "train")), record_hops() as hops:
                state, m = TS_.make_train_step(cfg)(state, _reduced_train_batch(cfg, dev))
            out[dev] = (logits, float(m["loss"]), float(m["grad_norm"]),
                        [p.detach().cpu() for p in tree_leaves(state.params)],
                        [mu.cpu() for mu in tree_leaves(state.opt.mu)],
                        [(h.kind, h.elements) for h in fwd_hops + hops])
        (x_c, l_c, g_c, p_c, m_c, h_c), (x_g, l_g, g_g, p_g, m_g, h_g) = out["cpu"], out["cuda"]
        ferr = float((x_c - x_g).abs().max())
        perr = max(float((a - b).abs().max()) for a, b in zip(p_g, p_c))
        mratio = _first_moment_ratio(m_g, m_c)
        ok = (ferr <= 1e-4 and abs(l_g - l_c) <= 1e-5 * abs(l_c)
              and abs(g_g - g_c) <= 1e-4 * abs(g_c) and mratio <= 1.0 and perr <= 1e-5
              and h_g == h_c and len(h_g) > 0)
        print(f"[reference] reduced f32 {name} a2a on a {A2A_MESH} mesh, card vs CPU: "
              f"forward max_abs_err {ferr:.2e} (tol 1e-4); train step loss {l_g:.6f} vs "
              f"{l_c:.6f}, grad norm {g_g:.6f} vs {g_c:.6f}, gradient leaves at {mratio:.3f} "
              f"of their tolerance, params max_abs_err {perr:.2e} (tol 1e-5); {len(h_g)} "
              f"exchanges, equal on both: {h_g == h_c} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"card and CPU disagree on the reduced {name} a2a path")


def _collectives_on_card(torch):
    """The ``collectives`` pass over phase 3g's seq mesh of 4 shards of the
    card: the sequence-parallel WKV forward and backward on real tensors
    there, at the pass's size, its hop log clean."""
    from repro_torch.analysis import collectives as C
    from repro_torch.analysis.findings import errors, format_table
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import make_seq_mesh

    found = C.run(get_config("rwkv6-1.6b"), mesh=make_seq_mesh(4))
    print(format_table(found, title="[collectives] rwkv6-1.6b on a seq mesh of 4 shards "
                                    "of the card"))
    if errors(found) or not any(f.location == C.COST_LOCATION for f in found):
        raise SystemExit("collectives pass on the card: not clean")


def _moe_a2a(torch, np):
    """Phase 3p."""
    t0 = time.perf_counter()
    for name in A2A_SCORE:
        _a2a_scoring(torch, np, name)
        _free(torch, f"phase 3p after {name}")
    t1 = time.perf_counter()
    _a2a_reference_check(torch, np)
    _collectives_on_card(torch)
    print(f"[time] phase 3p wall: {t1 - t0:.1f}s full-width scoring, "
          f"{time.perf_counter() - t1:.1f}s reduced f32 card vs CPU and the collectives pass")


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
    sms = torch.cuda.get_device_properties(0).multi_processor_count
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
                # Every rows-a-thread tile bit for bit the planner's.
                plans = {r: torch.equal(ST.launch_plan(x, c, rows=r, boundary=bnd), got)
                         for r in ST.ROW_TILES}
                print(f"[paper-kernels] stencil2d_cuda  {h}x{w} c={coeffs} b={bnd} "
                      f"{str(dtype):15s} max_abs_err={float(err.max()):.3e} "
                      f"bit-identical: {same} {'ok' if ok else 'FAIL'}; plan "
                      f"{ST.plan_stencil(h, w, dtype, sms)} rows, every plan bit-equal: {plans}")
                if not ok:
                    raise SystemExit(f"stencil2d_cuda {h}x{w} {dtype} disagrees with its plain version")
                if not all(plans.values()):
                    raise SystemExit(f"stencil2d plans differ at {h}x{w} {dtype}: {plans}")
                worst["stencil2d_cuda"] = max(worst["stencil2d_cuda"], float(err.max()))
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
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            measured[-1]["plan_rows"] = ST.plan_stencil(h, w, f32, sms)
            measured[-1]["plans"] = {
                r: _time_ms(torch, lambda x, c, r=r: ST.launch_plan(x, c, rows=r), sets,
                            reps=100 if h < 8192 else 20)[0] for r in ST.ROW_TILES}
            print(f"[time] stencil2d_cuda {h}x{w}: planned {measured[-1]['plan_rows']} rows; "
                  "every plan (rows: device us) " + ", ".join(
                      f"{r}: {t * 1e3:.2f}" for r, t in measured[-1]["plans"].items()))
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
                               "library_ms", "plan_rows", "plans") if k in r}
            for r in mine[1:]]})
    return rows


def _free(torch, what):
    """Collect the earlier phases' reference cycles (engines, closures) and
    return their blocks to the card before a phase of full-size models."""
    before = torch.cuda.memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[mem] before {what}: {before / 2**30:.2f} GiB allocated, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} after collecting cycles")


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
