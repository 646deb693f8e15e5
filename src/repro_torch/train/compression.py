"""Gradient compression for the data-parallel all-reduce, with error
feedback (``repro.train.compression``).

int8 block-quantization: each block of BLOCK values of the flattened
gradient is scaled to int8 by its largest magnitude; the quantization
residual is carried in an error-feedback buffer so the compression is
unbiased over time (Seide et al. / EF-SGD style). Off by default.

Every function works on tensors on their own device. ``torch.round`` rounds
half to even, as ``jnp.round`` does, so the payload and the scales equal the
reference's bit for bit. Trees are nested dicts of tensors (the model zoo's
parameter trees).
"""
from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.common import tree_map

BLOCK = 256


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: any shape f32 -> (int8 payload (n_blocks, BLOCK), f32 per-block
    scales (n_blocks,))."""
    flat = x.reshape(-1)
    flat = F.pad(flat, (0, (-flat.numel()) % BLOCK))
    blocks = flat.reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    scale = scale.clamp_min(1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale[:, 0]


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    shape) -> torch.Tensor:
    flat = (q.float() * scale[:, None]).reshape(-1)
    size = 1
    for s in shape:
        size *= s
    return flat[:size].reshape(tuple(shape))


def compress_grads_ef(grads: Any, error: Any) -> Tuple[Any, Any]:
    """Quantize (grads + error) per leaf; return (dequantized grads for the
    optimizer, new error buffers)."""
    def leaf(g, e):
        g32 = g.float() + e
        deq = dequantize_int8(*quantize_int8(g32), g32.shape)
        return deq, g32 - deq

    pairs = tree_map(leaf, grads, error)      # tuples are leaves here
    return (tree_map(lambda t: t[0], pairs),
            tree_map(lambda t: t[1], pairs))


def init_error_buffers(params) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
