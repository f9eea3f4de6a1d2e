"""Minitron-8B (pruned Nemotron-4) [arXiv:2407.14679; hf]: the same numbers as
``repro.configs.minitron_8b``.

32L d_model=4096 32H (GQA kv=8) d_ff=16384 vocab=256000.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="minitron-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=256000,
    head_dim=128,
    pattern=("attn",),
    mlp_type="relu2",     # squared-ReLU (nemotron family)
    tie_embeddings=False,
    sub_quadratic=False,
    microbatch=4,
)
