"""Qwen2-0.5B [arXiv:2407.10671; hf]: the same numbers as
``repro.configs.qwen2_0_5b``.

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151936 — QKV bias.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-0.5b",
    family="dense",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    d_ff=4864,
    vocab_size=151936,
    head_dim=64,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    pattern=("attn",),
    mlp_type="swiglu",
    tie_embeddings=True,
    sub_quadratic=False,
    microbatch=4,
)
