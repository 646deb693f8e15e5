"""Decoder-only LM assembly (dense / MoE / SSM / hybrid)
(``repro.models.transformer``).

The layer stack is cfg.pattern (a short tuple of (mixer, ff) kinds)
repeated cfg.n_blocks times. Block parameters and caches are stacked along
a leading "layers" axis, as in the reference; its ``lax.scan`` over the
stack is a Python loop here that indexes the stacked tensors (views, so a
cache written by a layer is written into the stack). Under grad each block
(one repeat of the pattern) runs under the config's remat policy, the
counterpart of the reference's ``_remat_wrap``: ``"none"`` keeps every
activation, ``"full"`` recomputes the block in the backward pass
(``torch.utils.checkpoint``), ``"dots"`` saves the matrix products' outputs
and recomputes the rest (selective checkpointing, ``checkpoint_dots``).
Serving runs without grad and takes none. The reference's ``constrain`` is
a sharding annotation, a no-op on one card, and is left out.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ATTN, DENSE_FF, MLA_, MOE_FF, NO_FF, SSM
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (apply_norm, dense, embed_init,
                                       make_norm, pack, tree_map)
from repro_torch.runtime.device import resolve_device


# ===========================================================================
# Init
# ===========================================================================
def _layer_init(cfg, mixer, ff, generator, dtype, device):
    parts = {"norm1": make_norm(cfg, dtype, device)}
    if mixer == ATTN:
        parts["mixer"] = (attn.gqa_init(cfg, generator, dtype, device),
                          attn.gqa_axes(cfg))
    elif mixer == MLA_:
        parts["mixer"] = attn.mla_init(cfg, generator, dtype, device)
    elif mixer == SSM:
        parts["mixer"] = ssm_mod.ssm_init(cfg, generator, dtype, device)
    else:
        raise ValueError(mixer)
    if ff != NO_FF:
        parts["norm2"] = make_norm(cfg, dtype, device)
        if ff == DENSE_FF:
            parts["ff"] = mlp_mod.mlp_init(cfg, generator, dtype,
                                           device=device)
        elif ff == MOE_FF:
            parts["ff"] = moe_mod.moe_init(cfg, generator, dtype, device)
        else:
            raise ValueError(ff)
    return pack(**parts)


def _block_init(cfg, generator, dtype, device):
    return pack(**{f"layer{i}": _layer_init(cfg, mixer, ff, generator, dtype,
                                            device)
                   for i, (mixer, ff) in enumerate(cfg.pattern)})


def _stacked_init(n, init_one):
    """``n`` draws of ``init_one()`` (a pair) stacked on a new leading
    "layers" axis. Each draw is copied into the preallocated stack, so the
    peak is the stack plus one draw (the reference stacks a list)."""
    first, axes = init_one()
    stacked = tree_map(lambda t: t.new_empty((n,) + tuple(t.shape)), first)
    for i in range(n):
        p = first if i == 0 else init_one()[0]
        tree_map(lambda s, t: s[i].copy_(t), stacked, p)
    axes = tree_map(lambda ax: ("layers",) + tuple(ax), axes)
    return stacked, axes


def init_params(cfg, generator, dtype, device="cuda"):
    """Returns the (params, axes) pair for the whole LM."""
    dev = resolve_device(device)
    parts = dict(
        embed=embed_init(generator, cfg.padded_vocab, cfg.d_model, dtype,
                         dev),
        blocks=_stacked_init(cfg.n_blocks, lambda: _block_init(
            cfg, generator, dtype, dev)),
        final_norm=make_norm(cfg, dtype, dev),
    )
    if not cfg.tie_embeddings:
        parts["unembed"] = dense(generator, (cfg.d_model, cfg.padded_vocab),
                                 ("embed", "vocab"), dtype, scale=0.02,
                                 device=dev)
    return pack(**parts)


def block(tree, i):
    """Block ``i`` of a stacked tree (views)."""
    return tree_map(lambda t: t[i], tree)


# ===========================================================================
# Forward (full sequence: prefill)
# ===========================================================================
def _apply_layer(cfg, lp, mixer, ff, x, positions, mask, generator,
                 cache=None, write_cache=False):
    """One (mixer, ff) layer. Returns (x, aux); with ``write_cache`` the
    layer's cache is written in place."""
    aux = None
    h = apply_norm(cfg, x, lp["norm1"])
    if mixer == ATTN:
        if write_cache:
            out, _ = attn.gqa_prefill(cfg, lp["mixer"], h, positions, mask,
                                      cache)
        else:
            out = attn.gqa_apply(cfg, lp["mixer"], h, positions, mask)
    elif mixer == MLA_:
        if write_cache:
            out, _ = attn.mla_apply(cfg, lp["mixer"], h, positions, mask,
                                    cache)
        else:
            out = attn.mla_apply(cfg, lp["mixer"], h, positions, mask)
    elif mixer == SSM:
        if write_cache:
            out, nc = ssm_mod.ssm_apply(cfg, lp["mixer"], h,
                                        return_cache=True)
            tree_map(lambda c, t: c.copy_(t), cache, nc)
        else:
            out = ssm_mod.ssm_apply(cfg, lp["mixer"], h)
    else:
        raise ValueError(mixer)
    x = x + out
    if ff != NO_FF:
        h = apply_norm(cfg, x, lp["norm2"])
        if ff == DENSE_FF:
            out = mlp_mod.mlp_apply(cfg, lp["ff"], h)
        else:
            out, aux = moe_mod.moe_apply(cfg, lp["ff"], h, generator)
        x = x + out
    return x, aux


def _block(cfg, bp, x, lb, dropped, positions, mask, generator, bc=None,
           write_cache=False):
    """One repeat of the pattern: its layers in order, the MoE's aux terms
    added to the running sums (the reference's scan carry)."""
    for j, (mixer, ff) in enumerate(cfg.pattern):
        name = f"layer{j}"
        cache = bc[name] if bc is not None else None
        x, aux = _apply_layer(cfg, bp[name], mixer, ff, x, positions, mask,
                              generator, cache, write_cache)
        if aux is not None:
            lb = lb + aux["load_balance_loss"]
            dropped = dropped + aux["dropped_frac"]
    return x, lb, dropped


# the matrix products whose outputs "dots" saves (einsum and matmul lower
# to these); everything else is recomputed
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                   torch.ops.aten.addmm.default,
                   torch.ops.aten.baddbmm.default})


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_context():
    return create_selective_checkpoint_contexts(_save_dots)


def _remat_wrap(cfg, fn, generator=None):
    """``fn`` under ``cfg.remat_policy`` when grad mode is on."""
    if cfg.remat_policy == "none" or not torch.is_grad_enabled():
        return fn
    if generator is not None and cfg.moe is not None \
            and cfg.moe.router_jitter > 0:
        # the recomputation would draw other router noise than the forward
        raise ValueError(f"{cfg.name}: router jitter under remat policy "
                         f"{cfg.remat_policy!r} is not supported")
    kwargs = {"use_reentrant": False}
    if cfg.remat_policy == "dots":
        kwargs["context_fn"] = _dots_context
    elif cfg.remat_policy != "full":
        raise ValueError(f"unknown remat policy {cfg.remat_policy!r}")
    return functools.partial(checkpoint, fn, **kwargs)


def forward(cfg, params, tokens, generator=None, caches=None,
            write_cache=False, inputs_embeds=None, positions=None):
    """Full-sequence forward. tokens: (B,S) int (or inputs_embeds (B,S,d)).

    Returns (hidden (B,S,d), aux, caches); with ``write_cache`` the caches
    are written in place. Logits are computed by the caller."""
    x = params["embed"][tokens] if inputs_embeds is None else inputs_embeds
    b, s = x.shape[:2]
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    mask = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
    lb = torch.zeros((), dtype=torch.float32, device=x.device)
    dropped = torch.zeros((), dtype=torch.float32, device=x.device)
    block_fn = functools.partial(_block, cfg) if caches is not None \
        else _remat_wrap(cfg, functools.partial(_block, cfg), generator)
    for i in range(cfg.n_blocks):
        bc = block(caches, i) if caches is not None else None
        x, lb, dropped = block_fn(block(params["blocks"], i), x, lb, dropped,
                                  positions, mask, generator, bc,
                                  write_cache)
    x = apply_norm(cfg, x, params["final_norm"])
    aux = {"load_balance_loss": lb, "dropped_frac": dropped / cfg.n_layers}
    return x, aux, caches


def logits_from_hidden(cfg, params, hidden):
    if cfg.tie_embeddings:
        logits = torch.einsum("bsd,vd->bsv", hidden, params["embed"])
    else:
        logits = hidden @ params["unembed"]
    return mask_padded_vocab(cfg, logits)


def mask_padded_vocab(cfg, logits):
    """Vocab-padded slots never win argmax/softmax."""
    if cfg.padded_vocab == cfg.vocab_size:
        return logits
    pad = torch.arange(cfg.padded_vocab, device=logits.device) \
        >= cfg.vocab_size
    return logits.masked_fill(pad, -1e30)


# ===========================================================================
# Caches
# ===========================================================================
def stacked_zeros(n, per_layer, device):
    """Zeros of each leaf of ``per_layer`` (a tree of meta tensors) with a
    leading axis of ``n``, on ``device``."""
    dev = resolve_device(device)
    return tree_map(lambda t: torch.zeros((n,) + tuple(t.shape),
                                          dtype=t.dtype, device=dev),
                    per_layer)


def init_cache(cfg, batch, max_seq, dtype, device="cuda"):
    """Stacked (over blocks) cache tree + its logical axes tree."""
    per_layer, axes = {}, {}
    for i, (mixer, _) in enumerate(cfg.pattern):
        name = f"layer{i}"
        if mixer == ATTN:
            per_layer[name] = attn.gqa_init_cache(cfg, batch, max_seq, dtype,
                                                  "meta")
            axes[name] = attn.gqa_cache_axes()
        elif mixer == MLA_:
            per_layer[name] = attn.mla_init_cache(cfg, batch, max_seq, dtype,
                                                  "meta")
            axes[name] = attn.mla_cache_axes()
        elif mixer == SSM:
            per_layer[name] = ssm_mod.ssm_init_cache(cfg, batch, dtype,
                                                     "meta")
            axes[name] = ssm_mod.ssm_cache_axes()
    axes = tree_map(lambda ax: ("layers",) + tuple(ax), axes)
    return stacked_zeros(cfg.n_blocks, per_layer, device), axes


# ===========================================================================
# Decode (one token)
# ===========================================================================
def decode_step(cfg, params, token, positions, caches):
    """token: (B,1) int; positions: (B,) int. Returns (logits, caches); the
    caches are written in place."""
    x = params["embed"][token]
    for i in range(cfg.n_blocks):
        bp = block(params["blocks"], i)
        for j, (mixer, ff) in enumerate(cfg.pattern):
            name = f"layer{j}"
            lp, cache = bp[name], block(caches[name], i)
            h = apply_norm(cfg, x, lp["norm1"])
            if mixer == ATTN:
                out, _ = attn.gqa_decode(cfg, lp["mixer"], h, positions,
                                         cache)
            elif mixer == MLA_:
                out, _ = attn.mla_decode(cfg, lp["mixer"], h, positions,
                                         cache)
            else:
                out, _ = ssm_mod.ssm_decode(cfg, lp["mixer"], h, cache)
            x = x + out
            if ff != NO_FF:
                h = apply_norm(cfg, x, lp["norm2"])
                if ff == DENSE_FF:
                    out = mlp_mod.mlp_apply(cfg, lp["ff"], h)
                else:
                    out, _ = moe_mod.moe_apply(cfg, lp["ff"], h)
                x = x + out
    x = apply_norm(cfg, x, params["final_norm"])
    return logits_from_hidden(cfg, params, x), caches
