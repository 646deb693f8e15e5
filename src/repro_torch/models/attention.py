"""Attention mixers (``repro.models.attention``): GQA (RoPE, optional
qk-norm), MLA (DeepSeek-V2) and cross-attention (enc-dec). Each has a
full-sequence path (prefill) and a single-token cached path (decode). The
GQA full-sequence path's ``allow_flash`` branch runs the flash-attention
kernel (B8); serving never takes it (``use_flash_kernel=False``, as in the
reference), so prefill and decode run ``_sdpa``.

Caches are preallocated dicts of tensors. Prefill and decode write into
them in place (the reference's ``dynamic_update_slice`` and
``.at[bidx, positions].set``) and return the same dict.

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
from repro_torch.models.common import (DTYPES, apply_rope, carry, dense,
                                       dense_init, pack, rms_norm,
                                       rope_cos_sin)
from repro_torch.runtime.device import resolve_device


def _shapes(cfg) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    shapes = dict(wq=(d, cfg.n_heads, hd), wk=(d, cfg.n_kv_heads, hd),
                  wv=(d, cfg.n_kv_heads, hd), wo=(cfg.n_heads, hd, d))
    if cfg.qk_norm:
        shapes.update(q_norm=(hd,), k_norm=(hd,))
    return shapes


_GQA_AXES = dict(wq=("embed", "heads", "head_dim"),
                 wk=("embed", "kv_heads", "head_dim"),
                 wv=("embed", "kv_heads", "head_dim"),
                 wo=("heads", "head_dim", "embed"),
                 q_norm=("head_dim",), k_norm=("head_dim",))


def gqa_axes(cfg) -> dict:
    """The logical axes of ``gqa_init``'s weights, as the reference's."""
    return {name: _GQA_AXES[name] for name in _shapes(cfg)}


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
    arrays = {name: np.asarray(a) for name, a in arrays.items()}
    expected = {
        name: torch.empty(shape, device="meta", dtype=dtype or DTYPES.get(
            str(arrays[name].dtype) if name in arrays else "", torch.float32))
        for name, shape in _shapes(cfg).items()}
    return carry(expected, arrays, device)


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


def gqa_init_cache(cfg, batch, max_seq, dtype, device="cuda"):
    hd = cfg.resolved_head_dim
    shape = (batch, max_seq, cfg.n_kv_heads, hd)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def gqa_cache_axes():
    return {"k": ("batch", "kv_seq", "kv_heads", "head_dim"),
            "v": ("batch", "kv_seq", "kv_heads", "head_dim")}


def gqa_prefill(cfg, p, x, positions, mask, cache):
    """Like gqa_apply (its ``_sdpa`` branch) but also writes k/v into the
    cache's first S positions."""
    q, k, v = _qkv(cfg, p, x, positions)
    s = x.shape[1]
    cache["k"][:, :s] = k
    cache["v"][:, :s] = v
    out = _sdpa(q, k, v, mask, cfg.n_kv_heads)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"]), cache


def _decode_mask(positions, t):
    """(B, T): the cache positions up to each row's current index."""
    return torch.arange(t, device=positions.device)[None, :] \
        <= positions[:, None]


def gqa_decode(cfg, p, x, positions, cache):
    """x: (B,1,d); positions: (B,) current index; cache k/v: (B,T,Hkv,D)."""
    b = x.shape[0]
    q, k, v = _qkv(cfg, p, x, positions[:, None])
    bidx = torch.arange(b, device=x.device)
    cache["k"][bidx, positions] = k[:, 0]
    cache["v"][bidx, positions] = v[:, 0]
    mask = _decode_mask(positions, cache["k"].shape[1])[:, None, :]
    out = _sdpa(q, cache["k"], cache["v"], mask, cfg.n_kv_heads)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"]), cache


# ===========================================================================
# MLA (multi-head latent attention)
# ===========================================================================
def mla_init(cfg, generator, dtype, device="cuda"):
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    dev = resolve_device(device)
    return pack(
        wq=dense(generator, (d, h, m.qk_nope_head_dim + m.qk_rope_head_dim),
                 ("embed", "heads", "head_dim"), dtype, device=dev),
        w_dkv=dense(generator, (d, m.kv_lora_rank), ("embed", "lora"), dtype,
                    device=dev),
        w_krope=dense(generator, (d, m.qk_rope_head_dim),
                      ("embed", "rope_dim"), dtype, device=dev),
        kv_norm=(torch.ones((m.kv_lora_rank,), dtype=dtype, device=dev),
                 ("lora",)),
        w_uk=dense(generator, (m.kv_lora_rank, h, m.qk_nope_head_dim),
                   ("lora", "heads", "head_dim"), dtype, device=dev),
        w_uv=dense(generator, (m.kv_lora_rank, h, m.v_head_dim),
                   ("lora", "heads", "head_dim"), dtype, device=dev),
        wo=dense(generator, (h, m.v_head_dim, d),
                 ("heads", "head_dim", "embed"), dtype,
                 scale=1.0 / math.sqrt(h * m.v_head_dim), device=dev),
    )


def _mla_qc(cfg, p, x, positions):
    """Shared q / compressed-kv computation. Returns q_nope, q_rope, c_kv,
    k_rope."""
    m = cfg.mla
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    q_nope, q_rope = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    c_kv = rms_norm(torch.einsum("bsd,dl->bsl", x, p["w_dkv"]),
                    p["kv_norm"], cfg.norm_eps)
    k_rope = torch.einsum("bsd,dr->bsr", x, p["w_krope"])
    cos, sin = rope_cos_sin(positions, m.qk_rope_head_dim, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    k_rope = apply_rope(k_rope[:, :, None, :], cos, sin)[:, :, 0, :]
    return q_nope, q_rope, c_kv, k_rope


def mla_apply(cfg, p, x, positions, mask, cache=None):
    """Full-sequence MLA (expanded form). With ``cache``, also writes the
    compressed kv and the rotated key of the first S positions into it and
    returns ``(y, cache)``."""
    m = cfg.mla
    q_nope, q_rope, c_kv, k_rope = _mla_qc(cfg, p, x, positions)
    k_nope = torch.einsum("bsl,lhk->bshk", c_kv, p["w_uk"])
    v = torch.einsum("bsl,lhv->bshv", c_kv, p["w_uv"])
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        *k_nope.shape[:3], m.qk_rope_head_dim)], dim=-1)
    out = _sdpa(q, k, v, mask, cfg.n_heads)    # MLA heads are not grouped
    y = torch.einsum("bshv,hvd->bsd", out, p["wo"])
    if cache is None:
        return y
    s = x.shape[1]
    cache["c_kv"][:, :s] = c_kv
    cache["k_rope"][:, :s] = k_rope
    return y, cache


def mla_init_cache(cfg, batch, max_seq, dtype, device="cuda"):
    m = cfg.mla
    dev = resolve_device(device)
    return {"c_kv": torch.zeros((batch, max_seq, m.kv_lora_rank),
                                dtype=dtype, device=dev),
            "k_rope": torch.zeros((batch, max_seq, m.qk_rope_head_dim),
                                  dtype=dtype, device=dev)}


def mla_cache_axes():
    return {"c_kv": ("batch", "kv_seq", "lora"),
            "k_rope": ("batch", "kv_seq", "rope_dim")}


def mla_decode(cfg, p, x, positions, cache):
    """Absorbed-weight MLA decode: attention runs in the compressed space,
    so the cache is only (lora + rope) wide per token."""
    m = cfg.mla
    b = x.shape[0]
    q_nope, q_rope, c_kv_new, k_rope_new = _mla_qc(cfg, p, x,
                                                   positions[:, None])
    bidx = torch.arange(b, device=x.device)
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    c_kv[bidx, positions] = c_kv_new[:, 0]
    k_rope[bidx, positions] = k_rope_new[:, 0]
    # absorb w_uk into q: (B,1,H,nope) x (lora,H,nope) -> (B,1,H,lora)
    q_lora = torch.einsum("bshk,lhk->bshl", q_nope, p["w_uk"])
    scores = (torch.einsum("bshl,btl->bhst", q_lora, c_kv)
              + torch.einsum("bshr,btr->bhst", q_rope, k_rope)).float()
    scores = scores / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    mask = _decode_mask(positions, c_kv.shape[1])[:, None, None, :]
    scores = torch.where(mask, scores, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    out_lora = torch.einsum("bhst,btl->bshl", probs, c_kv)
    out = torch.einsum("bshl,lhv->bshv", out_lora, p["w_uv"])
    y = torch.einsum("bshv,hvd->bsd", out, p["wo"])
    return y, cache


# ===========================================================================
# Cross-attention (whisper decoder -> encoder states); no RoPE.
# ===========================================================================
def xattn_init(cfg, generator, dtype, device="cuda"):
    hd = cfg.resolved_head_dim
    d = cfg.d_model
    dev = resolve_device(device)
    heads = ("embed", "heads", "head_dim")
    return pack(
        wq=dense(generator, (d, cfg.n_heads, hd), heads, dtype, device=dev),
        wk=dense(generator, (d, cfg.n_heads, hd), heads, dtype, device=dev),
        wv=dense(generator, (d, cfg.n_heads, hd), heads, dtype, device=dev),
        wo=dense(generator, (cfg.n_heads, hd, d),
                 ("heads", "head_dim", "embed"), dtype,
                 scale=1.0 / math.sqrt(cfg.n_heads * hd), device=dev),
    )


def xattn_kv(p, enc):
    return (torch.einsum("btd,dhk->bthk", enc, p["wk"]),
            torch.einsum("btd,dhk->bthk", enc, p["wv"]))


def xattn_apply(cfg, p, x, kv):
    k, v = kv
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    mask = torch.ones((q.shape[1], k.shape[1]), dtype=torch.bool,
                      device=x.device)
    out = _sdpa(q, k, v, mask, cfg.n_heads)
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
