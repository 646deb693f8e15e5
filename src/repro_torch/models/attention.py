"""GQA attention (``repro.models.attention``, its GQA part): the
full-sequence path with RoPE and optional qk-norm, whose ``allow_flash``
branch runs the flash-attention kernel (B8).

Weights keep the reference's head-factored layout: ``wq`` (d, H, hd),
``wk`` and ``wv`` (d, KH, hd), ``wo`` (H, hd, d). Parameters are a plain
dict of tensors (``gqa_init``, ``gqa_params_from_arrays``); ``GQAttention``
holds the same dict as an ``nn.Module``.

B8 has no backward, as in the reference: ``gqa_apply(allow_flash=True)``
on a shape the kernel takes raises when grad mode is on and the input or a
weight requires grad; run it under ``torch.no_grad()``.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models.common import (DTYPES, apply_rope, dense_init,
                                       rms_norm, rope_cos_sin)
from repro_torch.runtime.device import resolve_device


def _shapes(cfg) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    shapes = dict(wq=(d, cfg.n_heads, hd), wk=(d, cfg.n_kv_heads, hd),
                  wv=(d, cfg.n_kv_heads, hd), wo=(cfg.n_heads, hd, d))
    if cfg.qk_norm:
        shapes.update(q_norm=(hd,), k_norm=(hd,))
    return shapes


def gqa_init(cfg, generator, dtype=None, device="cuda") -> dict:
    """Random GQA weights of ``cfg`` in ``dtype`` (default: the config's),
    drawn from ``generator``, which must draw on ``device``."""
    dev = resolve_device(device)
    dtype = dtype or DTYPES[cfg.dtype]
    hd = cfg.resolved_head_dim
    shapes = _shapes(cfg)
    p = {name: dense_init(generator, shapes[name], dtype, device=dev)
         for name in ("wq", "wk", "wv")}
    p["wo"] = dense_init(generator, shapes["wo"], dtype,
                         scale=1.0 / math.sqrt(cfg.n_heads * hd), device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dtype, device=dev)
        p["k_norm"] = torch.ones((hd,), dtype=dtype, device=dev)
    return p


def gqa_params_from_arrays(cfg, arrays, dtype=None, device="cuda") -> dict:
    """The reference's ``gqa_init`` parameters, as numpy arrays (bfloat16
    ones included), -> the port's dict on ``device``, in ``dtype`` (default:
    the arrays' own type). The values are carried exactly."""
    dev = resolve_device(device)
    shapes = _shapes(cfg)
    if set(arrays) != set(shapes):
        raise ValueError(f"expected weights {sorted(shapes)}, got "
                         f"{sorted(arrays)}")
    p = {}
    for name, a in arrays.items():
        a = np.asarray(a)
        if a.shape != shapes[name]:
            raise ValueError(f"{name}: expected {shapes[name]}, got "
                             f"{a.shape}")
        p[name] = torch.from_numpy(a.astype(np.float32)).to(
            device=dev, dtype=dtype or DTYPES[str(a.dtype)])
    return p


def _qkv(cfg, p, x, positions):
    hd = cfg.resolved_head_dim
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    cos, sin = rope_cos_sin(positions, hd, cfg.rope_theta)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _sdpa(q, k, v, mask, n_kv_heads):
    """Grouped scaled-dot-product attention.

    q: (B,S,H,D) k,v: (B,T,Hkv,D) mask: (B,S,T) or (S,T) bool. Scores in
    the inputs' type, then f32; probabilities cast back before the product
    with v, as the reference does."""
    b, s, h, d = q.shape
    t, dv = k.shape[1], v.shape[-1]
    g = h // n_kv_heads
    qg = q.reshape(b, s, n_kv_heads, g, d)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k).float()
    scores = scores / math.sqrt(d)
    if mask.dim() == 2:                         # (S,T)
        mask = mask[None, None, None]           # (1,1,1,S,T)
    else:                                       # (B,S,T)
        mask = mask[:, None, None]              # (B,1,1,S,T)
    scores = torch.where(mask, scores, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, s, h, dv)


def gqa_apply(cfg, p, x, positions, mask, allow_flash=False):
    """Full-sequence attention. x:(B,S,d) positions:(B,S) mask:(S,T) bool.

    allow_flash: with ``cfg.use_flash_kernel`` and a shape the kernel takes
    (``ops.flash_available``), causal flash attention (B8) replaces
    ``_sdpa``, exactly where the reference's branch runs; ``mask`` is then
    not read, as in the reference."""
    q, k, v = _qkv(cfg, p, x, positions)
    if allow_flash and getattr(cfg, "use_flash_kernel", False):
        if ops.flash_available(q, k):
            out = ops.flash_attention_gqa(q, k, v, causal=True)
            return torch.einsum("bshk,hkd->bsd", out, p["wo"])
    # cfg.attn_seq_shard only places q and the output on the model axis's
    # sequence shards in the reference (a sharding constraint); on one card
    # it computes the same as this branch.
    out = _sdpa(q, k, v, mask, cfg.n_kv_heads)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])


class GQAttention(nn.Module):
    """A GQA layer over a parameter dict from ``gqa_init`` or
    ``gqa_params_from_arrays``, kept in the reference's layout."""

    def __init__(self, cfg, params: dict):
        super().__init__()
        self.cfg = cfg
        for name, shape in _shapes(cfg).items():
            if tuple(params[name].shape) != shape:
                raise ValueError(f"{name}: expected {shape}, got "
                                 f"{tuple(params[name].shape)}")
            setattr(self, name, nn.Parameter(params[name]))

    def params(self) -> dict:
        return dict(self.named_parameters())

    def forward(self, x, positions, mask, allow_flash=False):
        return gqa_apply(self.cfg, self.params(), x, positions, mask,
                         allow_flash=allow_flash)
