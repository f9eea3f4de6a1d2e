"""Model building blocks: norms, MLPs, embeddings, the logits projection
and rotary embeddings (counterparts of ``repro.model.layers``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(cfg) -> torch.dtype:
    """The torch dtype named by ``cfg.dtype``."""
    return _DTYPES[cfg.dtype]


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------

def init_rmsnorm(mk, d: int, name: str):
    return {"scale": mk(f"{name}.scale", (d,), "ones")}


def rms_norm(params, x: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * params["scale"].float()).to(x.dtype)


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------

def _check_mlp(cfg):
    if cfg.mlp_type not in ("swiglu", "geglu"):
        raise NotImplementedError(
            f"mlp_type {cfg.mlp_type!r} is not ported yet (swiglu, geglu)")


def init_mlp(mk, cfg, name: str):
    _check_mlp(cfg)
    d, f = cfg.d_model, cfg.d_ff
    return {"w_gate": mk(f"{name}.w_gate", (d, f)),
            "w_up": mk(f"{name}.w_up", (d, f)),
            "w_down": mk(f"{name}.w_down", (f, d))}


def apply_mlp(params, x: torch.Tensor, cfg) -> torch.Tensor:
    _check_mlp(cfg)
    gate = x @ params["w_gate"]
    if cfg.mlp_type == "swiglu":
        gate = F.silu(gate)
    else:                                   # geglu: the tanh-approximate gelu
        gate = F.gelu(gate, approximate="tanh")
    return (gate * (x @ params["w_up"])) @ params["w_down"]


# --------------------------------------------------------------------------
# Embeddings / logits
# --------------------------------------------------------------------------

def init_embeddings(mk, cfg, name: str = "tok"):
    v = cfg.padded_vocab
    p = {"embedding": mk(f"{name}.embedding", (v, cfg.d_model), "normal", 0.02)}
    if not cfg.tie_embeddings:
        p["unembed"] = mk(f"{name}.unembed", (cfg.d_model, v))
    return p


def embed_tokens(params, tokens: torch.Tensor, cfg) -> torch.Tensor:
    return params["embedding"][tokens].to(dtype_of(cfg))


def logits_projection(params, x: torch.Tensor, cfg) -> torch.Tensor:
    """f32 logits (B, S, padded_vocab); padded rows are masked to -1e30 so
    they never win the argmax or the softmax."""
    w = params["embedding"].T if cfg.tie_embeddings else params["unembed"]
    logits = x.float() @ w.float()
    if cfg.padded_vocab != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = -1e30
    return logits


# --------------------------------------------------------------------------
# Rotary embeddings (1-D RoPE)
# --------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    exponent = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               mrope_sections=None) -> torch.Tensor:
    """x: (B, H, T, D); positions: (B, T).  Rotates the two halves of the
    head dim by ``position * frequency`` in f32; output in x.dtype."""
    if mrope_sections is not None:
        raise NotImplementedError("M-RoPE (qwen2-vl) is not ported yet")
    d = x.shape[-1]
    half = d // 2
    freqs = rope_frequencies(d, theta, device=x.device)
    angle = positions.float()[:, :, None] * freqs            # (B, T, half)
    cos = torch.cos(angle)[:, None]                           # (B, 1, T, half)
    sin = torch.sin(angle)[:, None]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
