"""Meta-tensor stand-ins for one cell's inputs (counterpart of
``repro.launch.inputs``): the dry run traces ``train_step`` /
``prefill_step`` / ``decode_step`` against these, with nothing allocated.

Each spec comes with its tree of logical axes, as the reference's does;
:func:`resolve_pspecs` turns such a tree into partition specs under a
rules table.

Family conventions (the reference's):
  * vlm: the first seq_len // 4 positions are precomputed patch embeddings
    (a stub vision frontend) and the positions are M-RoPE's (3, B, S).
  * audio enc-dec: the encoder takes precomputed frame embeddings (B, S,
    D); the decoder sees seq_len text tokens (train / prefill) or a KV
    cache of seq_len (decode) with cross-attention onto the S-frame
    encoder memory.
  * long_500k: only sub-quadratic archs (:func:`cell_is_applicable`).

Token ids are int64 (as :func:`repro_torch.data.pipeline.make_batch`
gives them), the decode length a 0-d int32 tensor.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.model import model as M
from repro_torch.model.layers import dtype_of
from repro_torch.model.sharding import P, to_pspec

__all__ = ["batch_specs", "decode_specs", "resolve_pspecs", "cell_is_applicable"]


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ArchConfig, shape: ShapeConfig):
    """A training or prefill batch: (meta tensors, logical axes), two dicts
    with the same keys."""
    b, s = shape.global_batch, shape.seq_len
    specs = {"tokens": _meta((b, s), torch.int64)}
    axes = {"tokens": ("batch", "seq")}
    if shape.kind == "train":
        specs["labels"] = _meta((b, s), torch.int64)
        axes["labels"] = ("batch", "seq")
    if cfg.frontend == "vision":
        specs["frontend_embeds"] = _meta((b, s // 4, cfg.d_model), dtype_of(cfg))
        axes["frontend_embeds"] = ("batch", "seq", "act_embed")
        specs["positions"] = _meta((3, b, s), torch.int64)
        axes["positions"] = (None, "batch", "seq")
    if cfg.is_enc_dec:
        specs["enc_embeds"] = _meta((b, s, cfg.d_model), dtype_of(cfg))
        axes["enc_embeds"] = ("batch", "seq", "act_embed")
    return specs, axes


def decode_specs(cfg: ArchConfig, shape: ShapeConfig):
    """A decode step's inputs: ``(state, tokens, length, extras,
    extras_axes)``: the meta decode state for ``global_batch`` slots of
    ``seq_len`` positions, (B, 1) token ids, the 0-d length, and, for the
    encoder-decoder arch, ``enc_out`` (B, S, D)."""
    b, s = shape.global_batch, shape.seq_len
    state = M.abstract_decode_state(cfg, batch=b, max_len=s)
    tokens = _meta((b, 1), torch.int64)
    length = _meta((), torch.int32)
    extras, extras_axes = {}, {}
    if cfg.is_enc_dec:
        extras["enc_out"] = _meta((b, s, cfg.d_model), dtype_of(cfg))
        extras_axes["enc_out"] = ("batch", "kv_seq", "act_embed")
    return state, tokens, length, extras, extras_axes


def resolve_pspecs(axes_tree, rules):
    """Logical-axes tuples -> :class:`~repro_torch.model.sharding.PartitionSpec`
    via ``rules``, through dicts and lists; a ``None`` leaf is replicated."""
    if isinstance(axes_tree, dict):
        return {k: resolve_pspecs(v, rules) for k, v in axes_tree.items()}
    if isinstance(axes_tree, list):
        return [resolve_pspecs(v, rules) for v in axes_tree]
    return to_pspec(axes_tree, rules) if isinstance(axes_tree, tuple) else P()


def cell_is_applicable(cfg: ArchConfig, shape_name: str) -> tuple[bool, str]:
    """long_500k only for sub-quadratic archs (the reference's documented
    skip, with its reason)."""
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        return False, (
            f"{cfg.name} is pure full-attention; 500k decode requires "
            "sub-quadratic context handling (documented skip, DESIGN.md §5)"
        )
    return True, ""
