"""RWKV6-1.6B "Finch" [arXiv:2404.05892]: the same numbers as
``repro.configs.rwkv6_1_6b``.

24L d_model=2048 (attention-free) d_ff=7168 vocab=65536, 32 WKV heads of
64: data-dependent decay WKV recurrence + token shift.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-1.6b",
    family="ssm",
    num_layers=24,
    d_model=2048,
    num_heads=32,        # internal WKV heads (d=2048 / head_dim=64)
    num_kv_heads=32,
    d_ff=7168,
    vocab_size=65536,
    head_dim=64,
    pattern=("rwkv",),
    mlp_type="swiglu",
    rwkv=True,
    tie_embeddings=False,
    sub_quadratic=True,
    microbatch=2,
)
