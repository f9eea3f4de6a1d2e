"""SeamlessM4T-large-v2 text backbone [arXiv:2308.11596; hf]: the same
numbers as ``repro.configs.seamless_m4t_large_v2``.

24L(enc) + 24L(dec) d_model=1024 16H (kv=16, i.e. MHA) d_ff=8192
vocab=256206 — encoder-decoder with cross-attention; the audio frontend is
a stub: the encoder takes precomputed frame embeddings.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    num_layers=24,
    encoder_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    head_dim=64,
    pattern=("attn",),
    mlp_type="swiglu",
    tie_embeddings=True,
    frontend="audio",
    sub_quadratic=False,
    microbatch=2,
)
