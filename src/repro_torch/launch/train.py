"""Training launcher (counterpart of ``repro.launch.train``).

    python -m repro_torch.launch.train --arch rwkv6-1.6b --steps 8
    python -m repro_torch.launch.train --arch gemma3-1b --smoke --device cpu --steps 4

Every arch the reference trains.  Runs on the card unless ``--device``
names another.  The full config runs in its dtype (bf16) with its
``microbatch`` and ``remat``; ``--smoke`` takes the reduced f32 config.  As
in the reference, a frontend arch (qwen2-vl) trains its backbone on token
streams (``frontend=None``), and an encoder-decoder arch (seamless-m4t)
gets zero encoder frames of the batch's shape.  Fault tolerance is the
reference's: ``run_with_restarts`` around each step, an ``AsyncSaver`` for
``--ckpt-dir``, and the step-keyed data stream, so a restart neither skips
nor repeats data.  Prints loss, grad norm and tokens/s per logged step and
ends with ``done: steps=... loss a -> b``; exits non-zero on a non-finite
loss.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import sys
import time

import torch

from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.ft.watchdog import run_with_restarts
from repro_torch.kernels.common import resolve_device
from repro_torch.model.layers import dtype_of
from repro_torch.optim import adamw
from repro_torch.train import step as train_mod


class NonFiniteLoss(RuntimeError):
    pass


def main(argv=None, cfg=None) -> int:
    """Parse ``argv`` and train the config ``--arch`` names, or ``cfg``
    where the caller gives one (``repro_torch.examples.train_lm`` passes its
    own); ``--arch`` is then no option."""
    ap = argparse.ArgumentParser()
    if cfg is None:
        ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced f32 config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if cfg is None:
        cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    if cfg.frontend or cfg.is_enc_dec:
        # Text-only training, as the reference's launcher: frontend archs train
        # their backbone on token streams.
        cfg = dataclasses.replace(cfg, frontend=None)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                      global_batch=args.batch, seed=args.seed)
    opt_cfg = adamw.AdamWConfig(
        lr=args.lr, warmup_steps=max(args.steps // 20, 1), total_steps=args.steps)
    step_fn = train_mod.make_train_step(cfg, opt_cfg, compress=args.compress_grads)
    saver = ckpt.AsyncSaver()
    metrics_log = []

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def make_state():
        return train_mod.init_train_state(cfg, args.seed, device=device,
                                          compress=args.compress_grads)

    def do_step(state, step):
        batch = make_batch(dcfg, step, device=device)
        if cfg.is_enc_dec:
            batch["enc_embeds"] = torch.zeros((args.batch, args.seq, cfg.d_model),
                                              dtype=dtype_of(cfg), device=device)
        sync()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])      # waits for the step
        dt = time.perf_counter() - t0
        if not math.isfinite(loss):
            raise NonFiniteLoss(f"loss {loss} at step {step}")
        metrics_log.append((step, loss))
        if step % args.log_every == 0:
            print(f"step {step:5d}  loss {loss:.4f}  "
                  f"gnorm {float(metrics['grad_norm']):.3f}  "
                  f"{args.batch * args.seq / dt:,.0f} tok/s  {dt:.3f}s", flush=True)
        return state

    def save_fn(state, step):
        if args.ckpt_dir:
            saver.save_async(args.ckpt_dir, step, state)

    def restore_fn():
        if not args.ckpt_dir or ckpt.latest_step(args.ckpt_dir) is None:
            return None
        return ckpt.restore(args.ckpt_dir, make_state())

    print(f"train {cfg.name} on {device}: {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.dtype}, microbatch {cfg.microbatch}, remat "
          f"{cfg.remat}, batch {args.batch} x {args.seq}", flush=True)
    try:
        _, stats = run_with_restarts(
            make_state=make_state, step_fn=do_step, save_fn=save_fn,
            restore_fn=restore_fn, num_steps=args.steps,
            checkpoint_every=args.ckpt_every, watchdog_timeout_s=1800.0,
            on_event=lambda m: print(f"[ft] {m}", flush=True),
        )
    except NonFiniteLoss as e:
        print(f"error: {e}", file=sys.stderr, flush=True)
        return 1
    saver.wait()
    first = metrics_log[0][1] if metrics_log else float("nan")
    last = metrics_log[-1][1] if metrics_log else float("nan")
    print(f"done: steps={stats['steps_run']} restarts={stats['restarts']} "
          f"loss {first:.4f} -> {last:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
