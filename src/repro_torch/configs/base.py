"""Architecture configuration schema: the port's own copy of
``repro.configs.base.ArchConfig`` (same fields, same ``reduced()`` and
``padded_vocab``) and of its ``ShapeConfig`` cells (``SHAPES``, the dry
run's), so the port imports nothing of the JAX package."""

from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "hybrid", "ssm", "vlm", "audio"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Family
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None          # default: d_model // num_heads

    # --- attention ---------------------------------------------------------
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    mrope_sections: tuple[int, ...] | None = None
    attn_window: int | None = None
    pattern: tuple[str, ...] = ("attn",)
    attn_logit_softcap: float | None = None

    # --- mlp ----------------------------------------------------------------
    mlp_type: str = "swiglu"             # swiglu | geglu | relu2
    mlp_bias: bool = False

    # --- moe ----------------------------------------------------------------
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_capacity_factor: float = 1.25

    # --- recurrent ----------------------------------------------------------
    rglru: bool = False
    conv_width: int = 4
    d_rnn: int | None = None
    rwkv: bool = False

    # --- encoder-decoder ----------------------------------------------------
    encoder_layers: int = 0

    # --- embeddings / misc --------------------------------------------------
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    max_seq_len: int = 524_288
    sub_quadratic: bool = False
    frontend: str | None = None
    dtype: str = "bfloat16"

    # --- distribution defaults (kept for field parity with the reference) ---
    remat: str = "full"
    microbatch: int = 1
    prefill_chunks: int = 1
    moe_impl: str = "gather"
    attn_batch_over_model: bool = False
    fsdp_gather_weights: bool = False
    head_pad: int = 0

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // max(self.num_heads, 1))
        if self.d_rnn is None:
            object.__setattr__(self, "d_rnn", self.d_model)
        if self.num_heads and self.num_heads % max(self.num_kv_heads, 1):
            raise ValueError(f"{self.name}: heads {self.num_heads} % kv {self.num_kv_heads}")

    @property
    def padded_vocab(self) -> int:
        """Embedding-table rows padded to a 128 multiple; the padded logits
        are masked so they never win."""
        return -(-self.vocab_size // 128) * 128

    @property
    def layer_kinds(self) -> tuple[str, ...]:
        p = self.pattern
        return tuple(p[i % len(p)] for i in range(self.num_layers))

    @property
    def is_enc_dec(self) -> bool:
        return self.encoder_layers > 0

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + layers), as the
        reference counts it."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.head_dim
        nq, nkv = self.num_heads, self.num_kv_heads
        attn = d * hd * nq + 2 * d * hd * nkv + hd * nq * d
        mlp = 3 * d * f if self.mlp_type in ("swiglu", "geglu") else 2 * d * f
        if self.num_experts:
            mlp = mlp * self.num_experts + d * self.num_experts
        rec = 0
        if self.rglru:
            dr = self.d_rnn
            rec = 2 * d * dr + dr * d + self.conv_width * dr + 3 * dr
        if self.rwkv:
            rec = 6 * d * d
        total = 0
        for kind in self.layer_kinds:
            if kind in ("attn", "local", "global"):
                total += attn + mlp
            elif kind in ("rec", "rwkv"):
                total += rec + mlp
        if self.is_enc_dec:
            total += self.encoder_layers * (attn + mlp)
            total += self.num_layers * attn
        total += v * d * (1 if self.tie_embeddings else 2)
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed experts)."""
        if not self.num_experts:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        full_mlp = (3 if self.mlp_type in ("swiglu", "geglu") else 2) * d * f
        inactive = (self.num_experts - self.num_experts_per_tok) * full_mlp
        return self.param_count() - inactive * self.num_layers

    def reduced(self) -> "ArchConfig":
        """Smoke-test configuration of the same family (CPU-friendly)."""
        kv = max(1, min(self.num_kv_heads, 2))
        heads = max(kv, min(self.num_heads, 4))
        heads = (heads // kv) * kv
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=min(self.num_layers, len(self.pattern) * 2),
            d_model=128,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=128 // heads if 128 % heads == 0 else 32,
            d_ff=256,
            vocab_size=512,
            num_experts=min(self.num_experts, 4) if self.num_experts else 0,
            num_experts_per_tok=min(self.num_experts_per_tok, 2)
            if self.num_experts
            else 0,
            d_rnn=128,
            encoder_layers=min(self.encoder_layers, 2),
            max_seq_len=512,
            mrope_sections=(8, 4, 4) if self.mrope_sections else None,
            attn_window=min(self.attn_window, 64) if self.attn_window else None,
            dtype="float32",
            remat="none",
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell (the reference's ``ShapeConfig``)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


#: The reference's four cells, the dry run's shapes.
SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
