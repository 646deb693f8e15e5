"""Mamba-2 SSD (state-space duality) mixer [arXiv:2405.21060]
(``repro.models.ssm``).

The chunked SSD algorithm for prefill (within-chunk "attention-like"
quadratic term + inter-chunk linear recurrence) and the O(1) sequential
step for decode. A pure sequential scan lives in ``ssd_reference`` and is
the oracle for tests.

Recurrence (per head h, state (P,N)):
    h_t = exp(dt_t * A_h) * h_{t-1} + dt_t * x_t ⊗ B_t
    y_t = C_t · h_t + D_h * x_t
with B_t, C_t shared across heads within a group (n_groups, GQA-like).

The reference's einsums with ``preferred_element_type=f32`` take operands
in the input's type and accumulate and return f32; here those operands are
cast up to f32 (exactly) before the einsum, after any rounding to the
input's type that the reference makes first.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense, pack
from repro_torch.runtime.device import resolve_device


# --------------------------------------------------------------------------
# Init
# --------------------------------------------------------------------------
def ssm_dims(cfg):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    n_heads = d_in // s.head_dim
    return s, d_in, n_heads


def ssm_init(cfg, generator, dtype, device="cuda"):
    s, d_in, h = ssm_dims(cfg)
    d, g, n, k = cfg.d_model, s.n_groups, s.d_state, s.d_conv
    dev = resolve_device(device)
    f32 = torch.float32
    # dt bias init so softplus(dt_bias) spans [1e-3, 1e-1] (mamba convention)
    u = torch.rand((h,), generator=generator, dtype=f32, device=dev)
    dt0 = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    dt_bias = dt0 + torch.log(-torch.expm1(-dt0))         # inverse softplus
    a_init = torch.log(torch.linspace(1.0, 16.0, h, dtype=f32, device=dev))

    def last_tap(rows):
        w = torch.zeros((rows, k), dtype=dtype, device=dev)
        w[:, -1] = 1.0
        return w

    return pack(
        w_z=dense(generator, (d, d_in), ("embed", "ssm_inner"), dtype,
                  device=dev),
        w_x=dense(generator, (d, d_in), ("embed", "ssm_inner"), dtype,
                  device=dev),
        w_B=dense(generator, (d, g * n), ("embed", "ssm_state"), dtype,
                  device=dev),
        w_C=dense(generator, (d, g * n), ("embed", "ssm_state"), dtype,
                  device=dev),
        w_dt=dense(generator, (d, h), ("embed", "ssm_heads"), dtype,
                   device=dev),
        w_out=dense(generator, (d_in, d), ("ssm_inner", "embed"), dtype,
                    device=dev),
        dt_bias=(dt_bias, ("ssm_heads",)),
        A_log=(a_init, ("ssm_heads",)),
        D=(torch.ones((h,), dtype=f32, device=dev), ("ssm_heads",)),
        conv_x=(last_tap(d_in), ("ssm_inner", "conv_k")),
        conv_B=(last_tap(g * n), ("ssm_state", "conv_k")),
        conv_C=(last_tap(g * n), ("ssm_state", "conv_k")),
        gate_norm=(torch.ones((d_in,), dtype=dtype, device=dev),
                   ("ssm_inner",)),
    )


# --------------------------------------------------------------------------
# Pieces
# --------------------------------------------------------------------------
def _causal_conv(x, w):
    """Depthwise causal conv. x: (B,S,C), w: (C,K) -> (B,S,C). A
    cross-correlation, as the reference's ``conv_general_dilated``: the
    weights are not flipped."""
    k = w.shape[-1]
    xp = F.pad(x.transpose(1, 2), (k - 1, 0))            # (B, C, K-1+S)
    out = F.conv1d(xp, w[:, None, :].to(x.dtype), groups=w.shape[0])
    return out.transpose(1, 2)


def _gated_norm(y, z, scale, eps):
    """RMSNorm(y * silu(z)), the Mamba-2 gated norm."""
    gf = (y * F.silu(z)).float()
    var = gf.square().mean(-1, keepdim=True)
    return (gf * torch.rsqrt(var + eps) * scale.float()).to(y.dtype)


def _proj_conv(cfg, p, x):
    """Shared projections for full-sequence paths. Returns z, the pre-conv
    xr, Br, Cr (for the cache), the post-conv xs, Bs, Cs, and dt."""
    z = x @ p["w_z"]
    xr = x @ p["w_x"]
    Br = x @ p["w_B"]
    Cr = x @ p["w_C"]
    dt = F.softplus((x @ p["w_dt"]).float() + p["dt_bias"])   # (B,S,H) f32
    xs = F.silu(_causal_conv(xr, p["conv_x"]))
    Bs = F.silu(_causal_conv(Br, p["conv_B"]))
    Cs = F.silu(_causal_conv(Cr, p["conv_C"]))
    return z, xr, Br, Cr, xs, Bs, Cs, dt


def _split_heads(cfg, xs, Bs, Cs):
    s, d_in, h = ssm_dims(cfg)
    b, l, _ = xs.shape
    g, n, p_ = s.n_groups, s.d_state, s.head_dim
    xh = xs.reshape(b, l, g, h // g, p_)
    Bh = Bs.reshape(b, l, g, n)
    Ch = Cs.reshape(b, l, g, n)
    return xh, Bh, Ch


# --------------------------------------------------------------------------
# Chunked SSD (prefill)
# --------------------------------------------------------------------------
def ssd_chunked(cfg, xh, Bh, Ch, dt, A, init_state=None):
    """xh:(b,l,g,hg,p) Bh/Ch:(b,l,g,n) dt:(b,l,h) A:(h,) -> y (f32),
    final_state (f32).

    Chunk the sequence, compute the quadratic within-chunk term, carry the
    (g,hg,p,n) state across chunks."""
    s = cfg.ssm
    b, l, g, hg, p_ = xh.shape
    n = Bh.shape[-1]
    q = min(s.chunk_size, l)
    if l % q:
        raise ValueError(f"sequence {l} is not a multiple of chunk {q}")
    c = l // q
    h = g * hg
    f32 = torch.float32

    dtc = dt.reshape(b, c, q, h).float()
    dA = dtc * A[None, None, None, :]                    # log-decay (<=0)
    cum = torch.cumsum(dA, dim=2)                        # inclusive
    xc = xh.reshape(b, c, q, g, hg, p_)
    Bc = Bh.reshape(b, c, q, g, n)
    Cc = Ch.reshape(b, c, q, g, n)
    dtx = xc * dtc.reshape(b, c, q, g, hg)[..., None].to(xc.dtype)

    # --- within-chunk (quadratic) term: L[i,j] = exp(cum_i - cum_j), i >= j
    Lh = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (b,c,q,q,h) i,j
    causal = torch.ones((q, q), dtype=torch.bool, device=xh.device).tril()
    Lh = torch.where(causal[None, None, :, :, None], torch.exp(Lh), 0.0)
    scores = torch.einsum("bcqgn,bckgn->bcgqk", Cc, Bc)   # i=q, j=k
    Lg = Lh.reshape(b, c, q, q, g, hg)
    y_diag = torch.einsum("bcgik,bcikgh,bckghp->bcighp", scores.to(f32),
                          Lg, dtx.to(f32))

    # --- chunk states
    decay_end = torch.exp(cum[:, :, -1:, :] - cum)       # (b,c,q,h)
    de = decay_end.reshape(b, c, q, g, hg)
    states = torch.einsum("bcqgn,bcqgh,bcqghp->bcghpn", Bc.to(f32),
                          de.to(Bc.dtype).to(f32), dtx.to(f32))
    chunk_decay = torch.exp(cum[:, :, -1, :]).reshape(b, c, g, hg)

    # --- inter-chunk recurrence (the state BEFORE each chunk)
    state = (torch.zeros((b, g, hg, p_, n), dtype=f32, device=xh.device)
             if init_state is None else init_state.to(f32))
    h_before = []
    for ci in range(c):
        h_before.append(state)
        state = chunk_decay[:, ci, ..., None, None] * state + states[:, ci]
    h_before = torch.stack(h_before, dim=1)              # (b,c,g,hg,p,n)

    # --- inter-chunk contribution
    in_decay = torch.exp(cum).reshape(b, c, q, g, hg)
    y_off = torch.einsum("bcqgn,bcqgh,bcghpn->bcqghp", Cc.to(f32),
                         in_decay.to(Cc.dtype).to(f32),
                         h_before.to(Cc.dtype).to(f32))

    y = (y_diag + y_off).reshape(b, l, g, hg, p_)
    return y, state


def ssm_apply(cfg, p, x, init_cache=None, return_cache=False):
    """Full-sequence Mamba-2 block. x: (B,S,d) -> (B,S,d) [, cache]."""
    s, d_in, h = ssm_dims(cfg)
    z, xr, Br, Cr, xs, Bs, Cs, dt = _proj_conv(cfg, p, x)
    xh, Bh, Ch = _split_heads(cfg, xs, Bs, Cs)
    A = -torch.exp(p["A_log"])
    init_state = init_cache["ssd_state"] if init_cache is not None else None
    y, final_state = ssd_chunked(cfg, xh, Bh, Ch, dt, A, init_state)
    b, l = x.shape[:2]
    y = y.to(x.dtype) + xh * p["D"].reshape(
        s.n_groups, h // s.n_groups, 1).to(x.dtype)
    y = y.reshape(b, l, d_in)
    y = _gated_norm(y, z, p["gate_norm"], cfg.norm_eps)
    out = y @ p["w_out"]
    if not return_cache:
        return out
    k = s.d_conv
    xBC = torch.cat([xr, Br, Cr], dim=-1)                # pre-conv activations
    pad = F.pad(xBC, (0, 0, k - 1, 0))
    conv_state = pad[:, -(k - 1):, :]                    # (B, K-1, conv_dim)
    return out, {"ssd_state": final_state, "conv_state": conv_state}


# --------------------------------------------------------------------------
# Decode (single token)
# --------------------------------------------------------------------------
def ssm_init_cache(cfg, batch, dtype, device="cuda"):
    s, d_in, h = ssm_dims(cfg)
    g, n = s.n_groups, s.d_state
    conv_dim = d_in + 2 * g * n
    dev = resolve_device(device)
    return {"ssd_state": torch.zeros((batch, g, h // g, s.head_dim, n),
                                     dtype=torch.float32, device=dev),
            "conv_state": torch.zeros((batch, s.d_conv - 1, conv_dim),
                                      dtype=dtype, device=dev)}


def ssm_cache_axes():
    return {"ssd_state": ("batch", "ssm_groups", "ssm_heads", "head_dim",
                          "ssm_state"),
            "conv_state": ("batch", "conv_k", "ssm_inner")}


def ssm_decode(cfg, p, x, cache):
    """x: (B,1,d). O(1) recurrent step; writes the new state and conv
    window into ``cache`` in place and returns it."""
    s, d_in, h = ssm_dims(cfg)
    g, n, p_ = s.n_groups, s.d_state, s.head_dim
    hg = h // g
    b = x.shape[0]
    xt = x[:, 0, :]
    z = xt @ p["w_z"]
    xr = xt @ p["w_x"]
    Br = xt @ p["w_B"]
    Cr = xt @ p["w_C"]
    dt = F.softplus((xt @ p["w_dt"]).float() + p["dt_bias"])

    xBC = torch.cat([xr, Br, Cr], dim=-1)                # (B, conv_dim)
    window = torch.cat([cache["conv_state"], xBC[:, None, :]], dim=1)
    wfull = torch.cat([p["conv_x"], p["conv_B"], p["conv_C"]], dim=0)
    conv_out = torch.einsum("bkc,ck->bc", window.float(), wfull.float())
    conv_out = F.silu(conv_out).to(x.dtype)
    xs = conv_out[:, :d_in]
    Bs = conv_out[:, d_in:d_in + g * n]
    Cs = conv_out[:, d_in + g * n:]

    xhh = xs.reshape(b, g, hg, p_).float()
    Bh = Bs.reshape(b, g, n).float()
    Ch = Cs.reshape(b, g, n).float()
    A = -torch.exp(p["A_log"])
    a = torch.exp(dt * A).reshape(b, g, hg)              # (B,g,hg)
    dtg = dt.reshape(b, g, hg)

    h_new = (a[..., None, None] * cache["ssd_state"]
             + torch.einsum("bghp,bgn->bghpn", dtg[..., None] * xhh, Bh))
    y = torch.einsum("bghpn,bgn->bghp", h_new, Ch)
    y = y + xhh * p["D"].reshape(g, hg, 1)
    y = y.reshape(b, d_in).to(x.dtype)
    y = _gated_norm(y[:, None, :], z[:, None, :], p["gate_norm"],
                    cfg.norm_eps)
    out = y @ p["w_out"]
    cache["ssd_state"].copy_(h_new)
    cache["conv_state"].copy_(window[:, 1:, :])
    return out, cache


# --------------------------------------------------------------------------
# Sequential reference (test oracle)
# --------------------------------------------------------------------------
def ssd_reference(cfg, xh, Bh, Ch, dt, A, init_state=None):
    """Step-by-step recurrence over time. Same signature/returns as
    ssd_chunked."""
    b, l, g, hg, p_ = xh.shape
    n = Bh.shape[-1]
    state = (torch.zeros((b, g, hg, p_, n), dtype=torch.float32,
                         device=xh.device)
             if init_state is None else init_state)
    dtf = dt.float()
    ys = []
    for t in range(l):
        dtg = dtf[:, t].reshape(b, g, hg)
        a = torch.exp(dtg * A.reshape(g, hg))
        state = (a[..., None, None] * state
                 + torch.einsum("bghp,bgn->bghpn",
                                dtg[..., None] * xh[:, t].float(),
                                Bh[:, t].float()))
        ys.append(torch.einsum("bghpn,bgn->bghp", state, Ch[:, t].float()))
    return torch.stack(ys, dim=1), state
