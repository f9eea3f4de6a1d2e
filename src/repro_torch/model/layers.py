"""Model building blocks: norms, MLPs, embeddings, the logits projection
and rotary embeddings (counterparts of ``repro.model.layers``)."""

from __future__ import annotations

import functools

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

def init_mlp(mk, cfg, name: str):
    d, f = cfg.d_model, cfg.d_ff
    p = {}
    if cfg.mlp_type in ("swiglu", "geglu"):
        p["w_gate"] = mk(f"{name}.w_gate", (d, f))
    p["w_up"] = mk(f"{name}.w_up", (d, f))              # relu2 (nemotron): no gate
    p["w_down"] = mk(f"{name}.w_down", (f, d))
    return p


def apply_mlp(params, x: torch.Tensor, cfg) -> torch.Tensor:
    up = x @ params["w_up"]
    if cfg.mlp_type == "swiglu":
        h = F.silu(x @ params["w_gate"]) * up
    elif cfg.mlp_type == "geglu":              # the tanh-approximate gelu
        h = F.gelu(x @ params["w_gate"], approximate="tanh") * up
    elif cfg.mlp_type == "relu2":
        h = F.relu(up).square()
    else:
        raise ValueError(cfg.mlp_type)
    return h @ params["w_down"]


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
# Rotary embeddings (RoPE and qwen2-vl's M-RoPE)
# --------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    exponent = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exponent)


@functools.lru_cache(maxsize=None)
def _section_ids(sections: tuple, device: torch.device) -> torch.Tensor:
    """(half,) int64: which positional stream each frequency band of
    M-RoPE takes; built once per device, so no layer copies it again."""
    ids = torch.repeat_interleave(torch.arange(len(sections)), torch.tensor(sections))
    return ids.to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               mrope_sections=None) -> torch.Tensor:
    """x: (B, H, T, D); positions: (B, T), or (3, B, T) for M-RoPE.
    Rotates the two halves of the head dim by ``position * frequency`` in
    f32; output in x.dtype.

    M-RoPE (qwen2-vl): the half-dim frequency bands are split into
    (temporal, height, width) sections, each rotated by its own positional
    stream.  (B, T) positions broadcast to all three streams, so text
    tokens (and every decode step) get plain 1-D RoPE."""
    d = x.shape[-1]
    half = d // 2
    freqs = rope_frequencies(d, theta, device=x.device)
    pos = positions.float()
    if mrope_sections is not None:
        if sum(mrope_sections) != half:
            raise ValueError(f"mrope_sections {mrope_sections} do not sum to {half}")
        if pos.ndim == 2:
            pos = pos[None].expand(3, *pos.shape)
        section = _section_ids(tuple(mrope_sections), x.device)     # (half,)
        angle = pos[section].permute(1, 2, 0) * freqs                # (B, T, half)
    else:
        angle = pos[:, :, None] * freqs                              # (B, T, half)
    cos = torch.cos(angle)[:, None]                                  # (B, 1, T, half)
    sin = torch.sin(angle)[:, None]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
