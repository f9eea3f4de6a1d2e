"""Gemma3-1B: the same numbers as ``repro.configs.gemma3_1b``.

26L d_model=1152 4H (GQA kv=1, head 256) d_ff=6912 vocab=262144 tied:
5 local : 1 global interleave (window 1024), RoPE theta 1e6, so 4 periods
of 6 plus a (local, local) remainder.  Local layers keep a KV ring, global
layers the whole context.
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-1b",
    family="dense",
    num_layers=26,
    d_model=1152,
    num_heads=4,
    num_kv_heads=1,
    d_ff=6912,
    vocab_size=262144,
    head_dim=256,
    rope_theta=1_000_000.0,
    pattern=("local", "local", "local", "local", "local", "global"),
    attn_window=1024,
    mlp_type="geglu",
    tie_embeddings=True,
    sub_quadratic=True,
    microbatch=2,
)
