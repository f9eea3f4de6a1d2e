"""Gradient compression: blockwise int8 quantization with error feedback
(counterpart of ``repro.optim.compression``).

Each gradient leaf plus its carried residual is quantized to int8 in
blocks of 256 with one f32 scale per block, and what the quantization lost
is carried to the next step, so the accumulated compressed gradient tracks
the accumulated true gradient.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.tree import tree_leaves, tree_map

BLOCK = 256


class ErrorFeedbackState(NamedTuple):
    residual: Any  # param tree of f32 residuals


def init_error_feedback(params) -> ErrorFeedbackState:
    return ErrorFeedbackState(residual=tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params))


def quantize_int8(x: torch.Tensor):
    """Blockwise symmetric int8 quantization of the flattened ``x``.
    Returns ``(q (n, 256) int8, scale (n, 1) f32, shape, pad)``."""
    flat = x.float().reshape(-1)
    pad = (-flat.numel()) % BLOCK
    blocks = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, BLOCK)
    scale = torch.clamp(blocks.abs().amax(dim=1, keepdim=True) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale, tuple(x.shape), pad


def dequantize_int8(q, scale, shape, pad):
    flat = (q.float() * scale).reshape(-1)
    if pad:
        flat = flat[:-pad]
    return flat.reshape(shape)


def compress_leaf(g: torch.Tensor, residual: torch.Tensor):
    """Quantize ``g + residual``; return (dequantized in g.dtype, new residual)."""
    target = g.float() + residual
    deq = dequantize_int8(*quantize_int8(target))
    return deq.to(g.dtype), target - deq


def compressed_gradients(grads, ef: ErrorFeedbackState):
    """int8 + error feedback on every gradient leaf.  Returns
    ``(compressed grads, new ErrorFeedbackState)``."""
    pairs = tree_map(compress_leaf, grads, ef.residual)
    new_g = tree_map(lambda g, pr: pr[0], grads, pairs)
    new_r = tree_map(lambda g, pr: pr[1], grads, pairs)
    return new_g, ErrorFeedbackState(residual=new_r)


def compression_ratio(grads) -> float:
    """Bytes(int8 + scales) / bytes(original)."""
    leaves = tree_leaves(grads)
    total_in = sum(g.numel() * g.element_size() for g in leaves)
    total_out = sum(g.numel() + (g.numel() // BLOCK + 1) * 4 for g in leaves)
    return total_out / max(total_in, 1)
