"""Shared building blocks of the model zoo (``repro.models.common``): dense
and embedding initialisation from an explicit ``torch.Generator``, RMSNorm,
LayerNorm, rotary and sinusoidal position embeddings, the activations, and
the carry of the reference's weights (``carry``). Norms and rotations
compute in f32 and cast back to the input's type, as the reference does.

Parameter idiom: an ``*_init`` of the model zoo returns a pair ``(params,
axes)`` of two nested dicts of the same structure, tensors and tuples of
logical axis names, as the reference's; ``pack`` merges child pairs.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

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


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def pack(**pairs):
    """Merge {name: (params, axes)} into ({name: params}, {name: axes})."""
    return ({k: v[0] for k, v in pairs.items()},
            {k: v[1] for k, v in pairs.items()})


def dense(generator, shape, axes, dtype, scale=None, device="cuda"):
    """``dense_init`` with its logical axes: a pair."""
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} and axes {axes} differ in rank")
    return (dense_init(generator, shape, dtype, scale, device=device),
            tuple(axes))


def embed_init(generator, vocab, d_model, dtype, device="cuda"):
    w = torch.randn((vocab, d_model), generator=generator,
                    dtype=torch.float32, device=resolve_device(device))
    return (w * 0.02).to(dtype), ("vocab", "embed")


def norm_init(dim, dtype, with_bias=False, device="cuda"):
    dev = resolve_device(device)
    if with_bias:
        return ({"scale": torch.ones((dim,), dtype=dtype, device=dev),
                 "bias": torch.zeros((dim,), dtype=dtype, device=dev)},
                {"scale": ("embed",), "bias": ("embed",)})
    return torch.ones((dim,), dtype=dtype, device=dev), ("embed",)


def make_norm(cfg, dtype, device="cuda"):
    return norm_init(cfg.d_model, dtype, with_bias=(cfg.norm == "layernorm"),
                     device=device)


def carry(expected, arrays, device="cuda", path=""):
    """The reference's parameters, a nested dict of numpy arrays (bfloat16
    ones included), -> the port's tree on ``device``. ``expected`` is the
    port's own tree (its tensors may lie on the meta device): every name and
    shape must match it, and each leaf takes the expected leaf's type. The
    values are carried exactly where the types agree."""
    device = resolve_device(device)
    if isinstance(expected, dict):
        if not isinstance(arrays, dict) or set(arrays) != set(expected):
            got = sorted(arrays) if isinstance(arrays, dict) else arrays
            raise ValueError(f"{path or 'params'}: expected weights "
                             f"{sorted(expected)}, got {got}")
        return {k: carry(expected[k], arrays[k], device,
                         f"{path}/{k}" if path else k) for k in expected}
    a = np.asarray(arrays)
    if a.shape != tuple(expected.shape):
        raise ValueError(f"{path}: expected {tuple(expected.shape)}, got "
                         f"{a.shape}")
    return torch.from_numpy(a.astype(np.float32)).to(device=device,
                                                     dtype=expected.dtype)


def rms_norm(x, scale, eps):
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


def layer_norm(x, p, eps):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    out = out * p["scale"].float() + p["bias"].float()
    return out.to(x.dtype)


def apply_norm(cfg, x, p):
    if cfg.norm == "layernorm":
        return layer_norm(x, p, cfg.norm_eps)
    return rms_norm(x, p, cfg.norm_eps)


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


def sinusoidal_positions(seq_len, dim, device="cuda"):
    """Whisper-style fixed sinusoidal embeddings (seq_len, dim), f32."""
    dev = resolve_device(device)
    pos = torch.arange(seq_len, dtype=torch.float32, device=dev)[:, None]
    inv = torch.exp(-math.log(10000.0)
                    * torch.arange(dim // 2, dtype=torch.float32, device=dev)
                    / max(dim // 2 - 1, 1))
    ang = pos * inv[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _gelu_tanh(x):
    # jax.nn.gelu's default is the tanh approximation
    return F.gelu(x, approximate="tanh")


def activation(name: str):
    return {"silu": F.silu, "gelu": _gelu_tanh}[name]
