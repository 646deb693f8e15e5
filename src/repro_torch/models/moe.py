"""Mixture-of-experts feed-forward with grouped sort-based dispatch
(``repro.models.moe``).

- Tokens are dispatched within groups: one group a batch row, or, at decode
  (S == 1), one group of all B tokens. The reference vmaps a one-group
  dispatch; here ``_dispatch_group`` and ``_combine_group`` take every
  group at once along a leading axis.
- Capacity-based: each expert takes at most C = ceil(tokens_per_group *
  top_k / E * capacity_factor) tokens a group (at least top_k); overflow
  tokens go to a dump slot, are dropped (contribute zero) and are reported
  in the aux stats. Decode is dropless (C = T).
- Which tokens overflow follows the reference's order: a stable sort of the
  (token, choice) pairs by expert, and a top-k that puts the lower expert
  index first among equal probabilities (``jax.lax.top_k``'s order; a
  stable descending sort gives it, ``torch.topk`` promises none).
- Expert compute is one batched einsum over the experts; router math in f32;
  top-k probabilities renormalized (DeepSeek convention).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.common import activation, dense, pack


def moe_init(cfg, generator, dtype, device="cuda"):
    mo = cfg.moe
    d, e, f = cfg.d_model, mo.num_experts, mo.expert_d_ff
    parts = dict(
        router=dense(generator, (d, e), ("embed", "expert_in"),
                     torch.float32, scale=0.02, device=device),
        w_gate=dense(generator, (e, d, f), ("expert", "embed", "mlp"), dtype,
                     device=device),
        w_up=dense(generator, (e, d, f), ("expert", "embed", "mlp"), dtype,
                   device=device),
        w_down=dense(generator, (e, f, d), ("expert", "mlp", "embed"), dtype,
                     device=device),
    )
    if mo.num_shared_experts:
        sf = mo.shared_d_ff
        parts["shared"] = pack(
            w_gate=dense(generator, (d, sf), ("embed", "mlp"), dtype,
                         device=device),
            w_up=dense(generator, (d, sf), ("embed", "mlp"), dtype,
                       device=device),
            w_down=dense(generator, (sf, d), ("mlp", "embed"), dtype,
                         device=device),
        )
    return pack(**parts)


def _capacity(tokens_per_group: int, mo) -> int:
    c = math.ceil(tokens_per_group * mo.top_k / mo.num_experts
                  * mo.capacity_factor)
    return max(int(c), mo.top_k)


def _top_k(probs, k):
    """``jax.lax.top_k`` along the last axis: among equal values the lower
    index comes first."""
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


def _rows(index, d):
    """A (G, N) index as a (G, N, d) index for gather/scatter along dim 1."""
    return index[..., None].expand(-1, -1, d)


def _dispatch_group(x, top_ids, num_experts, capacity):
    """Every group's dispatch. x: (G,T,d), top_ids: (G,T,k). Returns
    expert_in (G,E,C,d), slot (G,T*k), valid (G,T*k) and the sort order
    (G,T*k)."""
    g, t, k = top_ids.shape
    d = x.shape[-1]
    flat_e = top_ids.reshape(g, t * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = flat_e.gather(1, order)
    counts = torch.zeros((g, num_experts), dtype=torch.long,
                         device=x.device).scatter_add_(
        1, sorted_e, torch.ones_like(sorted_e))
    starts = counts.cumsum(1) - counts
    pos = torch.arange(t * k, device=x.device)[None] \
        - starts.gather(1, sorted_e)
    valid = pos < capacity
    slot = torch.where(valid, sorted_e * capacity + pos,
                       num_experts * capacity)
    x_rep = x.repeat_interleave(k, dim=1).gather(1, _rows(order, d))
    buf = x.new_zeros((g, num_experts * capacity + 1, d))
    buf.scatter_add_(1, _rows(slot, d),
                     torch.where(valid[..., None], x_rep, 0))
    expert_in = buf[:, :-1].reshape(g, num_experts, capacity, d)
    return expert_in, slot, valid, order


def _combine_group(expert_out, slot, valid, order, top_probs, t, k):
    """Inverse of _dispatch_group. expert_out: (G,E,C,d) -> (G,T,d)."""
    g, d = expert_out.shape[0], expert_out.shape[-1]
    flat = torch.cat([expert_out.reshape(g, -1, d),
                      expert_out.new_zeros((g, 1, d))], dim=1)
    y_sorted = flat.gather(1, _rows(slot, d)) \
        * valid[..., None].to(expert_out.dtype)
    y = torch.empty_like(y_sorted).scatter_(1, _rows(order, d), y_sorted)
    w = top_probs.to(expert_out.dtype)[..., None]
    return (y.reshape(g, t, k, d) * w).sum(dim=2)


def moe_apply(cfg, p, x, generator=None):
    """x: (B, S, d) -> (y, aux) with aux = {load_balance_loss,
    dropped_frac}. Router jitter only when ``generator`` is given (serving
    passes none)."""
    mo = cfg.moe
    b, s, d = x.shape
    xg = x.reshape(1, b, d) if s == 1 else x
    g, t, _ = xg.shape

    logits = xg.float() @ p["router"].float()
    if generator is not None and mo.router_jitter > 0:
        logits = logits + mo.router_jitter * torch.randn(
            logits.shape, generator=generator, device=logits.device)
    probs = torch.softmax(logits, dim=-1)                 # (g, t, E)
    top_probs, top_ids = _top_k(probs, mo.top_k)
    top_probs = top_probs / top_probs.sum(-1, keepdim=True).clamp_min(1e-9)

    capacity = t if s == 1 else _capacity(t, mo)
    act = activation(cfg.act)
    expert_in, slot, valid, order = _dispatch_group(
        xg, top_ids, mo.num_experts, capacity)
    h = act(torch.einsum("gecd,edf->gecf", expert_in, p["w_gate"])) \
        * torch.einsum("gecd,edf->gecf", expert_in, p["w_up"])
    out = torch.einsum("gecf,efd->gecd", h, p["w_down"])
    y = _combine_group(out, slot, valid, order, top_probs, t,
                       mo.top_k).reshape(b, s, d)
    dropped = 1.0 - valid.float().mean(dim=1)

    # Switch-style load-balance loss: E * sum_e f_e * p_e  (f32)
    one_hot = F.one_hot(top_ids, mo.num_experts).float()
    f_e = one_hot.sum(dim=(0, 1, 2)) / (g * t * mo.top_k)
    p_e = probs.mean(dim=(0, 1))
    lb_loss = mo.num_experts * (f_e * p_e).sum() * mo.load_balance_coef

    if mo.num_shared_experts:
        sp = p["shared"]
        h = act(x @ sp["w_gate"]) * (x @ sp["w_up"])
        y = y + h @ sp["w_down"]

    return y, {"load_balance_loss": lb_loss, "dropped_frac": dropped.mean()}
