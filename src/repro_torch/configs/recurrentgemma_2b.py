"""RecurrentGemma-2B (Griffin) [arXiv:2402.19427]: the same numbers as
``repro.configs.recurrentgemma_2b``.

26L d_model=2560 10H (GQA kv=1, head 256) d_ff=7680 vocab=256000: RG-LRU
recurrent blocks + local attention (window 2048), pattern (rec, rec, local),
so 8 periods plus a (rec, rec) remainder.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    d_ff=7680,
    vocab_size=256000,
    head_dim=256,
    pattern=("rec", "rec", "local"),
    attn_window=2048,
    mlp_type="geglu",
    rglru=True,
    conv_width=4,
    d_rnn=2560,
    tie_embeddings=True,
    sub_quadratic=True,
    microbatch=4,
)
