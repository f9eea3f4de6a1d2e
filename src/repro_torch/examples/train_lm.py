"""End-to-end example: train a ~100M-param LM for a few hundred steps (the
port of ``examples/train_lm.py``).

Builds the reference's mid-size config from the qwen2 family (real vocab,
8 layers, f32, 8 query heads over 2 KV heads, ``remat="none"``), streams
the deterministic synthetic corpus and checkpoints asynchronously, all
through the port's training launcher (``repro_torch.launch.train``).  At
the default width (d_model 768) a head is 96 wide: flash attention's f32
kernels, forward and backward, are compiled for it.

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 300] [--device cpu]

runs on the card unless ``--device cpu`` is given (``--d-model 64 --steps
4 --seq 32`` for a quick pass on the CPU).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import tempfile

from repro_torch.configs.registry import get_config
from repro_torch.launch import train as train_launcher


def build_100m(d_model: int):
    base = get_config("qwen2-0.5b")
    return dataclasses.replace(
        base,
        name="qwen2-100m",
        num_layers=8,
        d_model=d_model,
        num_heads=8,
        num_kv_heads=2,
        head_dim=d_model // 8,
        d_ff=d_model * 4,
        vocab_size=32_768,
        dtype="float32",
        remat="none",
        microbatch=1,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--d-model", type=int, default=768)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a new temporary one)")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)

    cfg = build_100m(args.d_model)
    print(f"{cfg.name}: {cfg.param_count() / 1e6:.1f}M params")
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="train_lm_ckpt_")
    launch = ["--steps", str(args.steps), "--batch", str(args.batch),
              "--seq", str(args.seq), "--ckpt-dir", ckpt_dir, "--ckpt-every", "50",
              "--lr", "3e-4", "--log-every", "10"]
    if args.device:
        launch += ["--device", args.device]
    return train_launcher.main(launch, cfg=cfg)


if __name__ == "__main__":
    sys.exit(main())
