"""Nemotron-4-15B [arXiv:2402.16819; unverified]: the same numbers as
``repro.configs.nemotron_4_15b``.

32L d_model=6144 48H (GQA kv=8) d_ff=24576 vocab=256000 — squared-ReLU MLP.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-15b",
    family="dense",
    num_layers=32,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=256000,
    head_dim=128,
    pattern=("attn",),
    mlp_type="relu2",
    tie_embeddings=False,
    sub_quadratic=False,
    microbatch=8,
)
