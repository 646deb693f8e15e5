"""Feed-forward blocks (``repro.models.mlp``): SwiGLU (silu) and the plain
GELU MLP (tanh-approximate GELU, ``jax.nn.gelu``'s default)."""
from __future__ import annotations

from repro_torch.models.common import activation, dense, pack


def mlp_init(cfg, generator, dtype, d_ff=None, device="cuda"):
    d_ff = d_ff or cfg.d_ff
    d = cfg.d_model
    parts = {}
    if cfg.act == "silu":
        parts["w_gate"] = dense(generator, (d, d_ff), ("embed", "mlp"),
                                dtype, device=device)
    parts["w_up"] = dense(generator, (d, d_ff), ("embed", "mlp"), dtype,
                          device=device)
    parts["w_down"] = dense(generator, (d_ff, d), ("mlp", "embed"), dtype,
                            device=device)
    return pack(**parts)


def mlp_apply(cfg, p, x):
    act = activation(cfg.act)
    if cfg.act == "silu":
        h = act(x @ p["w_gate"]) * (x @ p["w_up"])
    else:
        h = act(x @ p["w_up"])
    return h @ p["w_down"]
