"""DBRX-132B [hf:databricks/dbrx-base; unverified]: the same numbers as
``repro.configs.dbrx_132b``.

40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352 — fine-grained MoE,
16 experts top-4.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="dbrx-132b",
    family="moe",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=10752,
    vocab_size=100352,
    head_dim=128,
    rope_theta=500_000.0,
    pattern=("attn",),
    mlp_type="swiglu",
    num_experts=16,
    num_experts_per_tok=4,
    tie_embeddings=False,
    sub_quadratic=False,
    microbatch=8,
    prefill_chunks=4,
)
