"""Encoder-decoder backbone (Whisper-base) (``repro.models.encdec``). The
audio conv frontend is a STUB: callers provide precomputed frame embeddings
(B, enc_seq, d_model). Stacked layers run in a Python loop, as in
``transformer``; prefill and decode write the caches in place.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.common import (apply_norm, embed_init, make_norm,
                                       pack, sinusoidal_positions, tree_map)
from repro_torch.models.transformer import (_stacked_init, block,
                                            mask_padded_vocab, stacked_zeros)
from repro_torch.runtime.device import resolve_device


# ===========================================================================
# Init
# ===========================================================================
def _enc_layer_init(cfg, generator, dtype, device):
    return pack(
        norm1=make_norm(cfg, dtype, device),
        self_attn=(attn.gqa_init(cfg, generator, dtype, device),
                   attn.gqa_axes(cfg)),
        norm2=make_norm(cfg, dtype, device),
        ff=mlp_mod.mlp_init(cfg, generator, dtype, device=device),
    )


def _dec_layer_init(cfg, generator, dtype, device):
    return pack(
        norm1=make_norm(cfg, dtype, device),
        self_attn=(attn.gqa_init(cfg, generator, dtype, device),
                   attn.gqa_axes(cfg)),
        norm_x=make_norm(cfg, dtype, device),
        cross_attn=attn.xattn_init(cfg, generator, dtype, device),
        norm2=make_norm(cfg, dtype, device),
        ff=mlp_mod.mlp_init(cfg, generator, dtype, device=device),
    )


def init_params(cfg, generator, dtype, device="cuda"):
    dev = resolve_device(device)
    return pack(
        embed=embed_init(generator, cfg.padded_vocab, cfg.d_model, dtype,
                         dev),
        enc_blocks=_stacked_init(cfg.n_encoder_layers, lambda: (
            _enc_layer_init(cfg, generator, dtype, dev))),
        enc_norm=make_norm(cfg, dtype, dev),
        dec_blocks=_stacked_init(cfg.n_layers, lambda: (
            _dec_layer_init(cfg, generator, dtype, dev))),
        final_norm=make_norm(cfg, dtype, dev),
    )


# ===========================================================================
# Encoder
# ===========================================================================
def encode(cfg, params, frames):
    """frames: (B, enc_seq, d) stub embeddings -> encoder states."""
    b, t, d = frames.shape
    x = frames + sinusoidal_positions(t, d, frames.device).to(
        frames.dtype)[None]
    zero_pos = torch.zeros((b, t), dtype=torch.long, device=frames.device)
    full_mask = torch.ones((t, t), dtype=torch.bool, device=frames.device)
    for i in range(cfg.n_encoder_layers):
        lp = block(params["enc_blocks"], i)
        h = apply_norm(cfg, x, lp["norm1"])
        # RoPE at position 0 is the identity
        x = x + attn.gqa_apply(cfg, lp["self_attn"], h, zero_pos, full_mask)
        h = apply_norm(cfg, x, lp["norm2"])
        x = x + mlp_mod.mlp_apply(cfg, lp["ff"], h)
    return apply_norm(cfg, x, params["enc_norm"])


# ===========================================================================
# Decoder (full sequence)
# ===========================================================================
def decode_full(cfg, params, tokens, enc_out, caches=None,
                write_cache=False):
    """Returns (hidden, caches); with ``write_cache`` the self-attention
    k/v and the encoder states' cross k/v are written into ``caches``."""
    if write_cache and caches is None:
        raise ValueError("write_cache needs caches")
    b, s = tokens.shape
    x = params["embed"][tokens]
    positions = torch.arange(s, device=x.device).expand(b, s)
    mask = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
    for i in range(cfg.n_layers):
        lp = block(params["dec_blocks"], i)
        bc = block(caches, i) if write_cache else None
        h = apply_norm(cfg, x, lp["norm1"])
        if write_cache:
            out, _ = attn.gqa_prefill(cfg, lp["self_attn"], h, positions,
                                      mask, bc["self"])
        else:
            out = attn.gqa_apply(cfg, lp["self_attn"], h, positions, mask)
        x = x + out
        h = apply_norm(cfg, x, lp["norm_x"])
        kv = attn.xattn_kv(lp["cross_attn"], enc_out)
        x = x + attn.xattn_apply(cfg, lp["cross_attn"], h, kv)
        h = apply_norm(cfg, x, lp["norm2"])
        x = x + mlp_mod.mlp_apply(cfg, lp["ff"], h)
        if write_cache:
            bc["cross_k"].copy_(kv[0])
            bc["cross_v"].copy_(kv[1])
    x = apply_norm(cfg, x, params["final_norm"])
    return x, caches


def logits_from_hidden(cfg, params, hidden):
    return mask_padded_vocab(
        cfg, torch.einsum("bsd,vd->bsv", hidden, params["embed"]))


# ===========================================================================
# Caches + decode step
# ===========================================================================
def init_cache(cfg, batch, max_seq, dtype, device="cuda"):
    hd = cfg.resolved_head_dim
    cross = (batch, cfg.encoder_seq_len, cfg.n_heads, hd)
    per = {"self": attn.gqa_init_cache(cfg, batch, max_seq, dtype, "meta"),
           "cross_k": torch.empty(cross, dtype=dtype, device="meta"),
           "cross_v": torch.empty(cross, dtype=dtype, device="meta")}
    axes = {"self": attn.gqa_cache_axes(),
            "cross_k": ("batch", "enc_seq", "heads", "head_dim"),
            "cross_v": ("batch", "enc_seq", "heads", "head_dim")}
    axes = tree_map(lambda ax: ("layers",) + tuple(ax), axes)
    return stacked_zeros(cfg.n_layers, per, device), axes


def decode_step(cfg, params, token, positions, caches):
    """token: (B,1); caches from init_cache/prefill, written in place."""
    x = params["embed"][token]
    for i in range(cfg.n_layers):
        lp, bc = block(params["dec_blocks"], i), block(caches, i)
        h = apply_norm(cfg, x, lp["norm1"])
        out, _ = attn.gqa_decode(cfg, lp["self_attn"], h, positions,
                                 bc["self"])
        x = x + out
        h = apply_norm(cfg, x, lp["norm_x"])
        x = x + attn.xattn_apply(cfg, lp["cross_attn"], h,
                                 (bc["cross_k"], bc["cross_v"]))
        h = apply_norm(cfg, x, lp["norm2"])
        x = x + mlp_mod.mlp_apply(cfg, lp["ff"], h)
    x = apply_norm(cfg, x, params["final_norm"])
    return logits_from_hidden(cfg, params, x), caches
