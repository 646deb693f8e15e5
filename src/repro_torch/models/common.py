"""Shared building blocks of the model zoo (``repro.models.common``): dense
initialisation from an explicit ``torch.Generator``, RMSNorm and rotary
position embeddings. Norms and rotations compute in f32 and cast back to
the input's type, as the reference does.
"""
from __future__ import annotations

import math

import torch

from repro_torch.runtime.device import resolve_device

# ModelConfig.dtype -> torch dtype
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dense_init(generator, shape, dtype, scale: float | None = None,
               device="cuda") -> torch.Tensor:
    """Truncated-normal (to [-3, 3]) dense weight with fan-in scaling by
    default: fan-in is shape[0] for a matrix, the product of all but the
    last dim for a head-factored weight. Drawn in f32 from ``generator``
    (which must draw on ``device``), then cast to ``dtype``."""
    fan_in = shape[0] if len(shape) <= 2 else math.prod(shape[:-1])
    if scale is None:
        scale = 1.0 / math.sqrt(max(fan_in, 1))
    w = torch.empty(shape, dtype=torch.float32, device=resolve_device(device))
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -3.0, 3.0, generator=generator)
    return (w * scale).to(dtype)


def rms_norm(x, scale, eps):
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


def rope_cos_sin(positions, dim, theta):
    """positions: (...,) int -> cos, sin of shape (..., dim // 2), f32."""
    exponent = torch.arange(0, dim, 2, dtype=torch.float32,
                            device=positions.device) / dim
    inv_freq = 1.0 / (theta ** exponent)
    angles = positions.float()[..., None] * inv_freq
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x, cos, sin):
    """x: (..., S, H, D); cos/sin: (..., S, D // 2) broadcast over heads.
    Rotates the pairs (x[i], x[i + D/2]): the two-halves convention."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    c = cos[..., None, :].float()
    s = sin[..., None, :].float()
    out = torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)
    return out.to(x.dtype)
