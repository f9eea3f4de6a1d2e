"""Roofline terms of a dry-run cell on one H100 (counterpart of
``repro.launch.roofline``).

Three terms per (arch x shape) cell, in seconds a step:

  compute    = sum over flop classes of FLOPs / that class's peak
  memory     = bytes accessed / HBM bandwidth
  collective = collective bytes / link bandwidth (0 on one card)

The FLOPs and bytes come from :func:`repro_torch.core.lowering.cost_counting`
over a meta trace of the whole step.  Unlike the reference's one bf16
peak, the compute term sums each class over its own peak: the port's f32
unembedding and its WKV, scan and token-shift kernels run at 67 TFLOP/s,
not 989.  The reference's ``cost_analysis_dict`` and
``parse_collective_bytes`` have no counterpart: there is no HLO, and one
card has no collectives.

``model_flops``, ``_attention_flops``, ``_decode_attention_flops`` and
``analytic_hbm_bytes`` are the reference's, unchanged but for the model
axis's width ``tp``, an argument here (the reference's 16).
"""

from __future__ import annotations

import dataclasses

from repro_torch.launch import mesh as mesh_mod

__all__ = ["RooflineTerms", "roofline_terms", "model_flops", "analytic_hbm_bytes"]


@dataclasses.dataclass(frozen=True)
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    flops: float
    hbm_bytes: float
    collective_bytes: float

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def bound_time_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def as_dict(self) -> dict:
        return {
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "collective_bytes": self.collective_bytes,
            "dominant": self.dominant,
        }


def roofline_terms(cost: dict, collectives: dict) -> RooflineTerms:
    """``cost``: ``flops`` and ``bytes accessed``, and ``flops_by_class``
    (class -> FLOPs, :data:`~repro_torch.launch.mesh.PEAK_FLOPS`'s keys)
    where the trace has it; without it every FLOP counts at the bf16 peak,
    as the reference counts them.  ``collectives``: ``total_bytes``."""
    flops = float(cost.get("flops", 0.0))
    hbm = float(cost.get("bytes accessed", 0.0))
    coll = float(collectives.get("total_bytes", 0))
    by_class = cost.get("flops_by_class")
    if by_class:
        compute = sum(f / mesh_mod.PEAK_FLOPS[c] for c, f in by_class.items())
    else:
        compute = flops / mesh_mod.PEAK_FLOPS_BF16
    return RooflineTerms(
        compute_s=compute,
        memory_s=hbm / mesh_mod.HBM_BW,
        collective_s=coll / (mesh_mod.ICI_BW_PER_LINK * mesh_mod.ICI_LINKS),
        flops=flops,
        hbm_bytes=hbm,
        collective_bytes=coll,
    )


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS: 6·N_active·D (+ attention quadratic term) per step.

    train counts fwd+bwd (×3 of forward's 2ND); prefill counts forward;
    decode counts one token (D = batch tokens).
    """
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        base = 6.0 * n_active * tokens
        attn = _attention_flops(cfg, shape.seq_len, shape.global_batch) * 3
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        base = 2.0 * n_active * tokens
        attn = _attention_flops(cfg, shape.seq_len, shape.global_batch)
    else:  # decode: one new token per sequence
        tokens = shape.global_batch * 1
        base = 2.0 * n_active * tokens
        attn = _decode_attention_flops(cfg, shape.seq_len, shape.global_batch)
    return base + attn


def _attention_flops(cfg, s: int, b: int) -> float:
    total = 0.0
    for kind in cfg.layer_kinds:
        if kind not in ("attn", "local", "global"):
            continue
        window = cfg.attn_window if kind == "local" else None
        eff = min(window, s) if window else s
        # 2 matmuls (QK^T and PV), causal halves the full square.
        per_q = eff if window else s / 2
        total += 2 * 2 * b * s * per_q * cfg.num_heads * cfg.head_dim
    if cfg.is_enc_dec:
        total *= 2.2  # encoder self + decoder self + cross (approx)
    return total


def _decode_attention_flops(cfg, s: int, b: int) -> float:
    total = 0.0
    for kind in cfg.layer_kinds:
        if kind in ("attn", "global"):
            total += 2 * 2 * b * s * cfg.num_heads * cfg.head_dim
        elif kind == "local":
            total += 2 * 2 * b * min(cfg.attn_window or s, s) * cfg.num_heads * cfg.head_dim
        elif kind in ("rec", "rwkv"):
            total += 2 * b * (cfg.d_rnn or cfg.d_model) * 4
    return total


def analytic_hbm_bytes(cfg, shape, n_chips: int, mode: str, tp: int = 16) -> float:
    """Fused-execution HBM traffic estimate per chip (roofline lower bound).

    The traced bytes count every unfused intermediate (each op's inputs and
    outputs); this model counts only irreducible HBM passes.  ``tp`` is the
    model axis's width (the reference's production mesh: 16; one card: 1).
    """
    itemsize = 2  # bf16 params/activations
    params = cfg.param_count()
    params_active = cfg.active_param_count()
    p_dev = params * itemsize / n_chips
    d = cfg.d_model

    if mode == "train":
        m = max(1, cfg.microbatch)
        tokens_dev = shape.global_batch * shape.seq_len / (n_chips / tp)
        # Params: per microbatch the data-axis all-gather materializes the
        # model-shard (params/tp) for fwd + bwd reads; optimizer rw in fp32.
        gathered = params * itemsize / tp
        param_traffic = m * 2 * gathered + p_dev / itemsize * (4 + 8 + 8 + 2 + 8)
        if cfg.num_experts:
            # Only routed experts' weights stream per microbatch.
            param_traffic *= params_active / params * 0.5 + 0.5
        # Activations: residual stream per layer (fwd save + bwd read +
        # recompute write/read) ~4 passes; ~6 intermediate tensors per layer
        # fused into ~3 extra passes of d-width traffic.
        act = tokens_dev * d * itemsize * cfg.num_layers * 7
        # Logits + CE in fp32 (vocab sharded over tp).
        logits = tokens_dev * cfg.vocab_size / tp * 4 * 3
        return (param_traffic + act + logits) / 1.0
    if mode == "prefill":
        tokens_dev = shape.global_batch * shape.seq_len / (n_chips / tp)
        param_traffic = params * itemsize / tp
        act = tokens_dev * d * itemsize * cfg.num_layers * 3
        logits = tokens_dev * cfg.vocab_size / tp * 4
        return param_traffic + act + logits
    # decode: every step streams active params once + reads the KV cache.
    param_traffic = params_active * itemsize / n_chips
    kv = 0.0
    for kind in cfg.layer_kinds:
        if kind in ("attn", "global"):
            s_eff = shape.seq_len
        elif kind == "local":
            s_eff = min(cfg.attn_window or shape.seq_len, shape.seq_len)
        else:
            s_eff = (cfg.d_rnn or d)  # recurrent state, not seq-length bound
            kv += shape.global_batch * s_eff * 4 * 2 / n_chips
            continue
        kv += (
            shape.global_batch * cfg.num_kv_heads * s_eff * cfg.head_dim
            * itemsize * 2 / n_chips
        )
    return param_traffic + kv
