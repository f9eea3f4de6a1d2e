"""Model building blocks: norms, MLPs, embeddings, the logits projection
and rotary embeddings (counterparts of ``repro.model.layers``).

Each takes plain tensors, or the :class:`~repro_torch.model.sharding.Sharded`
tensors of a (data, model) mesh: the same code, with the reference's
``constrain`` and ``gather_for_use`` at the reference's places
(``layers.py:43-56, 76-93``), runs shard by shard through
:func:`~repro_torch.model.sharding.smap` and
:func:`~repro_torch.model.sharding.dense`, and is unchanged on plain
tensors.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.model.sharding import (
    constrain,
    dense,
    gather_for_use,
    is_sharded,
    offset,
    reshard,
    smap,
    transpose,
)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(cfg) -> torch.dtype:
    """The torch dtype named by ``cfg.dtype``."""
    return _DTYPES[cfg.dtype]


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------

def init_rmsnorm(mk, d: int, name: str):
    return {"scale": mk(f"{name}.scale", (d,), ("act_embed",), "ones")}


def _rms_norm(scale, x: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


def rms_norm(params, x, eps: float):
    """RMS norm over the last dim.  Sharded with that dim split (RWKV's
    output norm over the model axis's heads), each shard's sum of squares
    is all-reduced over the split's axes."""
    scale = params["scale"]
    if not is_sharded(x) or not x.dims[-1]:
        return smap(lambda s, t: _rms_norm(s, t, eps), scale, x)
    d = x.shape[-1]
    scale = reshard(scale, x.dims[-1:])
    sq = smap(lambda t: t.float().square().sum(dim=-1, keepdim=True), x,
              dims=x.dims[:-1] + ((),))
    sq.partial = x.dims[-1]
    sq = reshard(sq, sq.dims)

    def norm(s, t, total):
        out = t.float() * torch.rsqrt(total / d + eps)
        return (out * s.float()).to(t.dtype)

    return smap(norm, scale, x, sq)


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------

def init_mlp(mk, cfg, name: str):
    d, f = cfg.d_model, cfg.d_ff
    p = {}
    if cfg.mlp_type in ("swiglu", "geglu"):
        p["w_gate"] = mk(f"{name}.w_gate", (d, f), ("embed", "ff"))
    p["w_up"] = mk(f"{name}.w_up", (d, f), ("embed", "ff"))  # relu2 (nemotron): no gate
    p["w_down"] = mk(f"{name}.w_down", (f, d), ("ff", "embed"))
    return p


def apply_mlp(params, x, cfg):
    """Column-parallel up (and gate) over ``ff``, row-parallel down: its
    partial sums over the model axis all-reduced."""
    g = cfg.fsdp_gather_weights
    w_up = gather_for_use(params["w_up"], ("embed", "ff"), g)
    up = constrain(dense(x, w_up), "batch", "seq", "act_ff")
    if cfg.mlp_type in ("swiglu", "geglu"):
        w_gate = gather_for_use(params["w_gate"], ("embed", "ff"), g)
        gate = constrain(dense(x, w_gate), "batch", "seq", "act_ff")
        if cfg.mlp_type == "swiglu":
            h = smap(lambda a, b: F.silu(a) * b, gate, up)
        else:                                  # the tanh-approximate gelu
            h = smap(lambda a, b: F.gelu(a, approximate="tanh") * b, gate, up)
    elif cfg.mlp_type == "relu2":
        h = smap(lambda a: F.relu(a).square(), up)
    else:
        raise ValueError(cfg.mlp_type)
    h = constrain(h, "batch", "seq", "act_ff")
    w_down = gather_for_use(params["w_down"], ("ff", "embed"), g)
    return constrain(dense(h, w_down), "batch", "seq", "act_embed")


# --------------------------------------------------------------------------
# Embeddings / logits
# --------------------------------------------------------------------------

def init_embeddings(mk, cfg, name: str = "tok"):
    v = cfg.padded_vocab
    p = {"embedding": mk(f"{name}.embedding", (v, cfg.d_model), ("vocab", "embed"),
                         "normal", 0.02)}
    if not cfg.tie_embeddings:
        p["unembed"] = mk(f"{name}.unembed", (cfg.d_model, v), ("embed", "vocab"))
    return p


def embed_tokens(params, tokens, cfg):
    """The tokens' rows of the table.  Sharded, the table's rows lie over
    the model axis: each shard takes the rows of its vocabulary slice (0
    for the others) and the partial sums are all-reduced, which adds one
    row and zeros.  With ``fsdp_gather_weights`` the table's ``embed``
    shards are all-gathered first; without, the tokens are all-gathered
    over data and each data shard's ``d_model`` slice of every row goes
    back to its batch by an all-to-all."""
    emb = params["embedding"]
    if not is_sharded(emb):
        return emb[tokens].to(dtype_of(cfg))
    emb = gather_for_use(emb, ("vocab", "embed"), cfg.fsdp_gather_weights)
    if emb.dims[1]:
        tokens = reshard(tokens, ((),) * tokens.ndim)

    def look(cell, e, t):
        ids = t - offset(emb, 0, cell)
        hit = (ids >= 0) & (ids < e.shape[0])
        rows = e[ids.clamp(0, e.shape[0] - 1)]
        return torch.where(hit[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                             device=rows.device))

    x = smap(look, emb, tokens, cell=True, dims=tokens.dims + (emb.dims[1],))
    x.partial = emb.dims[0]
    x = constrain(x, "batch", "seq", "act_embed")
    return smap(lambda t: t.to(dtype_of(cfg)), x)


def logits_projection(params, x, cfg):
    """f32 logits (B, S, padded_vocab); padded rows are masked to -1e30 so
    they never win the argmax or the softmax.  Sharded, they stay split
    over the vocabulary (``constrain(logits, "batch", "seq", "vocab")``)."""
    g = cfg.fsdp_gather_weights
    if cfg.tie_embeddings:
        w = transpose(gather_for_use(params["embedding"], ("vocab", "embed"), g))
    else:
        w = gather_for_use(params["unembed"], ("embed", "vocab"), g)
    logits = dense(smap(lambda t: t.float(), x), smap(lambda t: t.float(), w))
    logits = constrain(logits, "batch", "seq", "vocab")
    if cfg.padded_vocab != cfg.vocab_size:
        def mask(cell, t):
            t[..., max(0, cfg.vocab_size - offset(logits, -1, cell)):] = -1e30
            return t
        logits = smap(mask, logits, cell=True)
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
