"""Qwen2-VL-7B backbone [arXiv:2409.12191; hf]: the same numbers as
``repro.configs.qwen2_vl_7b``.

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064 — M-RoPE (t/h/w
frequency sections), dynamic-resolution vision frontend stubbed as
precomputed patch embeddings per the assignment spec.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-7b",
    family="vlm",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),   # halves of head_dim=128 -> 64 = 16+24+24
    pattern=("attn",),
    mlp_type="swiglu",
    tie_embeddings=False,
    frontend="vision",
    sub_quadratic=False,
    microbatch=4,
)
