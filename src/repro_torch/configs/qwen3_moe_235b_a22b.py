"""Qwen3-MoE-235B-A22B [hf:Qwen/Qwen3-30B-A3B family; hf]: the same numbers as
``repro.configs.qwen3_moe_235b_a22b``.

94L d_model=4096 64H (GQA kv=4) d_ff=1536 vocab=151936 — 128 experts top-8,
fine-grained experts, per-head q/k RMSNorm.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    d_ff=1536,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1_000_000.0,
    pattern=("attn",),
    mlp_type="swiglu",
    num_experts=128,
    num_experts_per_tok=8,
    tie_embeddings=False,
    sub_quadratic=False,
    microbatch=16,
    prefill_chunks=8,
)
