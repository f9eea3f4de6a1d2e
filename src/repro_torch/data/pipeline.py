"""Deterministic, stateless, resumable synthetic data (counterpart of
``repro.data.pipeline``).

Every batch is a pure function of ``(seed, step)``: a counter-based numpy
generator (Philox keyed on the pair) draws it, so there is no iterator
state to checkpoint and a restart resumes exactly by replaying the step
index.  The stream is the reference's in kind (Zipf token ids, every 8th
position copying the token 4 back, labels shifted by one) but not in its
numbers: the reference draws from JAX threefry, which numpy does not
reproduce.  Tests that compare the two frameworks hand both one numpy
batch.  :func:`host_batch_numpy`, the reference's loader variant, is
numpy in both, so the two frameworks' batches are equal there;
:func:`batch_specs` are the dry run's meta stand-ins.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels.common import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_exponent: float = 1.1


def _zipf_from_uniform(u: np.ndarray, vocab: int, s: float) -> np.ndarray:
    """Inverse-CDF Zipf sampling (the continuous approximation)."""
    k = np.power(1.0 - u, -1.0 / (s - 1.0))
    return (np.clip(k, 1.0, float(vocab)) - 1.0).astype(np.int64)


def make_batch_numpy(cfg: DataConfig, step: int) -> dict[str, np.ndarray]:
    """``{"tokens", "labels"}``, each (B, S) int64, keyed on (seed, step)."""
    key = np.array([cfg.seed, step], dtype=np.uint64)
    rng = np.random.Generator(np.random.Philox(key=key))
    b, s = cfg.global_batch, cfg.seq_len
    tokens = _zipf_from_uniform(rng.random((b, s)), cfg.vocab_size, cfg.zipf_exponent)
    # Learnable structure: every 8th position repeats the token 4 back.
    pos = np.arange(s)
    shifted = np.roll(tokens, 4, axis=1)
    tokens = np.where((pos % 8 == 0) & (pos >= 4), shifted, tokens)
    labels = np.roll(tokens, -1, axis=1)    # next-token targets
    return {"tokens": tokens, "labels": labels}


def make_batch(cfg: DataConfig, step: int, *, device=None) -> dict[str, torch.Tensor]:
    """:func:`make_batch_numpy` as int64 tensors on ``device`` (``None``:
    the card)."""
    device = resolve_device(device)
    return {k: torch.from_numpy(v).to(device)
            for k, v in make_batch_numpy(cfg, step).items()}


def batch_specs(cfg: DataConfig) -> dict[str, torch.Tensor]:
    """Meta tensors of one batch's ``tokens`` and ``labels`` (the dry run's
    inputs; nothing allocated), int64 as :func:`make_batch` gives them."""
    shape = (cfg.global_batch, cfg.seq_len)
    return {k: torch.empty(shape, dtype=torch.int64, device="meta")
            for k in ("tokens", "labels")}


def host_batch_numpy(cfg: DataConfig, step: int) -> dict[str, np.ndarray]:
    """The reference's host-side loader variant, the same numbers: Zipf
    tokens from ``np.random.default_rng((seed << 32) ^ step)`` (no copied
    positions), int32, labels shifted by one."""
    rng = np.random.default_rng((cfg.seed << 32) ^ step)
    b, s = cfg.global_batch, cfg.seq_len
    u = rng.random((b, s))
    k = np.power(1.0 - u, -1.0 / (cfg.zipf_exponent - 1.0))
    tokens = (np.clip(k, 1.0, float(cfg.vocab_size)) - 1.0).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    return {"tokens": tokens, "labels": labels}
