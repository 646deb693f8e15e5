"""Archive-scale GP fits past the O(N^3) wall of ``gp_fit``, ported from
``repro.explore.bigfit``: the inducing-point path and the local-GP ensemble.

**Inducing points** (``fit_inducing`` / ``update_inducing``): an SGPR-style
sparse fit on m = ``cfg.n_inducing`` deterministically strided history
points. With A = L_m^-1 K_mn / sigma the posterior needs only B = I + A A^T
and c = L_B^-1 A ys / sigma — every per-round quantity is (m,) or (m, m), so
after the one O(n m^2) cold fit a tell round appends with a rank-q update
of the RUNNING sufficient statistics (A A^T, A y, A 1, count/sum/sq/min)
and one (m, m) refactorization: O(m^2 q + m^3), independent of n. The
distances go through the hand-written ``gp_sqdist`` kernel and the (m, n)
cross-covariance solve through the hand-written blocked ``tri_solve``
kernel (``kernels.ops``), at the sites where the reference calls them.

**Local ensemble** (``fit_ensemble``): kd-style alternating-dimension median
splits partition history into E equal cells of ``cfg.expert_size``; one
exact GP per cell (one batched Cholesky over the cells), and prediction
merges the ``cfg.n_experts_predict`` nearest experts by generalized
product-of-experts (precision-weighted, weights 1/k). E = 1 is exactly the
dense GP. The lengthscale search runs on the ``gp_sqdist`` kernel; each
cell's assembly is plain torch, as the reference's.

Determinism: every fit is a pure function of (cfg, history) — the inducing
set, the lengthscale subsample and the kd partition are index arithmetic,
no RNG. The incremental path re-associates the A A^T accumulation, so a
resumed run (which cold-refits) agrees with an uninterrupted one to float
tolerance, not bitwise.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.explore.surrogate import (_solve_lower, cholesky_or_nan,
                                           lengthscale_sweep)
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.runtime.device import resolve_device


class InducingGPState(NamedTuple):
    """SGPR sufficient statistics + factors. Everything a tell round
    touches is (m,) or (m, m); history size enters only through the
    running scalars."""
    z: torch.Tensor            # (m, d) inducing inputs (unit cube)
    l_m: torch.Tensor          # (m, m) chol(K_mm + jitter I)
    l_b: torch.Tensor          # (m, m) chol(I + A A^T)
    c: torch.Tensor            # (m,)   L_B^-1 (A ys) / sigma
    aat: torch.Tensor          # (m, m) running A A^T
    ay: torch.Tensor           # (m,)   running A @ y_raw
    a1: torch.Tensor           # (m,)   running A @ 1
    count: torch.Tensor        # ()     observations folded in
    y_sum: torch.Tensor        # ()
    y_sq: torch.Tensor         # ()
    y_min: torch.Tensor        # ()
    y_mean: torch.Tensor       # ()     derived standardization
    y_std: torch.Tensor        # ()
    lengthscale: torch.Tensor  # ()
    best: torch.Tensor         # ()     standardized incumbent


class EnsembleGPState(NamedTuple):
    """E local experts over a kd partition of history (equal cells, pad
    rows decoupled to identity), merged at prediction by gPoE."""
    x: torch.Tensor            # (E, s, d) cell inputs
    valid: torch.Tensor        # (E, s) f32 row validity
    chol: torch.Tensor         # (E, s, s)
    alpha: torch.Tensor        # (E, s)
    centroid: torch.Tensor     # (E, d) valid-row centroids
    y_mean: torch.Tensor       # ()
    y_std: torch.Tensor        # ()
    lengthscale: torch.Tensor  # ()
    best: torch.Tensor         # ()


def inducing_state_from_arrays(tree, device="cuda") -> InducingGPState:
    """An InducingGPState from the reference's ``InducingGPState`` held as
    numpy arrays (any object with its attributes), on ``device``."""
    dev = resolve_device(device)
    return InducingGPState(*(torch.tensor(np.asarray(getattr(tree, f)),
                                          dtype=torch.float32, device=dev)
                             for f in InducingGPState._fields))


def _f32(x, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def _sigma(cfg, device) -> torch.Tensor:
    return torch.sqrt(_f32(cfg.noise + cfg.jitter, device))


def _standardize(y_sum, y_sq, y_min, count):
    mean = y_sum / count
    var = torch.clamp_min(y_sq / count - mean * mean, 0.0)
    std = torch.clamp_min(torch.sqrt(var), 1e-8)
    return mean, std, (y_min - mean) / std


def select_lengthscale(cfg, x, y):
    """Lengthscale by exact NLL on a strided history subsample of at most
    ``cfg.n_max_exact`` points — the dense grid sweep of the small-N path,
    on a slice it can afford. The distances come from the ``gp_sqdist``
    kernel, as the reference's ``kops.gp_sqdist``."""
    grid = _f32(cfg.lengthscales, x.device)
    if grid.shape[0] == 1:
        return grid[0]
    n = x.shape[0]
    ns = min(n, cfg.n_max_exact)
    idx = (torch.arange(ns, device=x.device) * n) // ns
    xs, ys_raw = x[idx], y[idx]
    std = torch.clamp_min(ys_raw.std(correction=0), 1e-8)
    ys = (ys_raw - ys_raw.mean()) / std
    nll = lengthscale_sweep(cfg, kops.gp_sqdist(xs, xs), ys, grid)[2]
    return grid[torch.argmin(nll)]


def _cross_cov(cfg, xa, xb, ls):
    # distances through the kernel (the reference's kops.gp_sqdist), the
    # covariance map in plain torch: the lengthscale is a tensor, which the
    # kernel's fixed-parameter epilogue does not take
    return kref.gp_kernel_fn(cfg.kernel, kops.gp_sqdist(xa, xb), ls, 1.0)


def _refresh_factors(cfg, state: InducingGPState) -> InducingGPState:
    """Recompute the derived pieces (standardization, L_B, c, best) from
    the running sufficient statistics — shared by cold fit and update."""
    m = state.z.shape[0]
    dev = state.z.device
    y_mean, y_std, best = _standardize(state.y_sum, state.y_sq,
                                       state.y_min, state.count)
    l_b = cholesky_or_nan(torch.eye(m, dtype=torch.float32, device=dev)
                          + state.aat)
    ays = (state.ay - y_mean * state.a1) / y_std
    c = _solve_lower(l_b, ays[:, None])[:, 0] / _sigma(cfg, dev)
    return state._replace(l_b=l_b, c=c, y_mean=y_mean, y_std=y_std,
                          best=best)


def fit_inducing(cfg, x, y, *, z=None, lengthscale=None) -> InducingGPState:
    """Cold SGPR fit on the full history x (n, d), y (n,): O(n m^2) once.
    z defaults to a deterministic strided subset of history (tests pass it
    explicitly to pin the model across incremental comparisons)."""
    n = x.shape[0]
    dev = x.device
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    if z is None:
        m = min(cfg.n_inducing, n)
        z = x[(torch.arange(m, device=dev) * n) // m]
    m = z.shape[0]
    ls = select_lengthscale(cfg, x, y) if lengthscale is None \
        else _f32(lengthscale, dev)
    # 10x jitter on K_mm: the strided inducing set can carry near-duplicate
    # history points
    kmm = _cross_cov(cfg, z, z, ls) \
        + 10.0 * cfg.jitter * torch.eye(m, dtype=torch.float32, device=dev)
    l_m = cholesky_or_nan(kmm)
    kmn = _cross_cov(cfg, z, x, ls)                       # (m, n)
    a = kops.tri_solve(l_m, kmn) / _sigma(cfg, dev)      # the blocked kernel
    zero = _f32(0.0, dev)
    state = InducingGPState(
        z=z, l_m=l_m, l_b=l_m, c=torch.zeros((m,), dtype=torch.float32,
                                              device=dev),
        aat=a @ a.T, ay=a @ y, a1=a.sum(1),
        count=_f32(float(n), dev), y_sum=y.sum(), y_sq=(y * y).sum(),
        y_min=y.min(), y_mean=zero, y_std=_f32(1.0, dev),
        lengthscale=ls, best=zero)
    return _refresh_factors(cfg, state)


def update_inducing(cfg, state: InducingGPState, x_new, y_new, mask=None
                    ) -> InducingGPState:
    """Incremental tell: fold a completed batch (q, d)/(q,) into the
    running statistics — a rank-q update of A A^T plus one (m, m)
    refactorization, independent of history size; the inducing set and
    lengthscale stay pinned to the cold fit. ``mask`` (q,) zero-weights
    padded rows (the mid-round fantasy updates of ``rescore``)."""
    x_new = x_new.to(torch.float32)
    y_new = y_new.to(torch.float32)
    mask = torch.ones_like(y_new) if mask is None \
        else mask.to(torch.float32)
    kzn = _cross_cov(cfg, state.z, x_new, state.lengthscale) \
        * mask[None, :]                                     # (m, q)
    a_new = _solve_lower(state.l_m, kzn) / _sigma(cfg, kzn.device)
    inf = _f32(float("inf"), kzn.device)
    state = state._replace(
        aat=state.aat + a_new @ a_new.T,
        ay=state.ay + a_new @ y_new,
        a1=state.a1 + a_new.sum(1),
        count=state.count + mask.sum(),
        y_sum=state.y_sum + (y_new * mask).sum(),
        y_sq=state.y_sq + (y_new * y_new * mask).sum(),
        y_min=torch.minimum(state.y_min,
                            torch.where(mask > 0.5, y_new, inf).min()))
    return _refresh_factors(cfg, state)


def _inducing_parts(cfg, state, xq):
    # plain assembly, not the kernel: the acquisition ascent differentiates
    # through it (the reference keeps Pallas out too, bigfit.py:205)
    kqm = kref.gp_kernel_fn(cfg.kernel, kref.gp_sqdist_ref(xq, state.z),
                            state.lengthscale, 1.0)          # (..., q, m)
    w = _solve_lower(state.l_m, kqm.transpose(-1, -2))        # (..., m, q)
    u = _solve_lower(state.l_b, w)
    return w, u, u.transpose(-1, -2) @ state.c


def posterior_inducing(cfg, state: InducingGPState, xq):
    """Joint SGPR posterior of xq (..., q, d), standardized units: mean
    (..., q) and full covariance (..., q, q). Differentiable."""
    w, u, mean = _inducing_parts(cfg, state, xq)
    kq = kref.gp_kernel_fn(cfg.kernel, kref.gp_sqdist_ref(xq, xq),
                           state.lengthscale, 1.0)
    cov = kq - w.transpose(-1, -2) @ w + u.transpose(-1, -2) @ u
    return mean, 0.5 * (cov + cov.transpose(-1, -2))


def mean_var_inducing(cfg, state: InducingGPState, xq):
    """Marginal mean/variance (q,) — the cheap per-point view."""
    w, u, mean = _inducing_parts(cfg, state, xq)
    var = torch.clamp_min(1.0 - (w * w).sum(-2) + (u * u).sum(-2),
                          cfg.jitter)
    return mean, var


# ---------------------------------------------------------------------------
# local-GP ensemble path
# ---------------------------------------------------------------------------
def _kd_order(x, valid, levels: int):
    """Deterministic kd-style ordering: ``levels`` rounds of alternating-
    dimension median splits (stable argsort halving). Invalid (pad) rows
    sort last, so cells are contiguous, spatially coherent runs with the
    pads at the tail. Returns a permutation of arange(n_p)."""
    n_p, d = x.shape
    idx = torch.arange(n_p, device=x.device)
    inf = _f32(float("inf"), x.device)
    for lvl in range(levels):
        groups = idx.reshape(2 ** lvl, -1)
        key = torch.where(valid[groups] > 0.5, x[groups, lvl % d], inf)
        order = torch.argsort(key, dim=1, stable=True)
        idx = torch.gather(groups, 1, order).reshape(-1)
    return idx


def fit_ensemble(cfg, x, y, *, lengthscale=None) -> EnsembleGPState:
    """Partition history into E = 2^ceil(log2(n / expert_size)) equal cells
    of ``cfg.expert_size`` by kd median splits and fit one exact GP per cell
    (one batched Cholesky). Pad rows are decoupled to identity covariance
    rows with zero targets, so alpha there is exactly zero and they never
    leak into predictions. n <= expert_size gives E = 1: the dense GP."""
    n, dim = x.shape
    dev = x.device
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    s = cfg.expert_size
    levels = max(0, (max(1, -(-n // s)) - 1).bit_length())
    e = 2 ** levels
    n_p = e * s
    xp = torch.zeros((n_p, dim), dtype=torch.float32, device=dev)
    xp[:n] = x
    yp = torch.zeros((n_p,), dtype=torch.float32, device=dev)
    yp[:n] = y
    valid = (torch.arange(n_p, device=dev) < n).to(torch.float32)

    ls = select_lengthscale(cfg, x, y) if lengthscale is None \
        else _f32(lengthscale, dev)
    y_mean = y.mean()
    y_std = torch.clamp_min(y.std(correction=0), 1e-8)

    order = _kd_order(xp, valid, levels)
    xe = xp[order].reshape(e, s, dim)
    ye = ((yp[order] - y_mean) / y_std).reshape(e, s)
    ve = valid[order].reshape(e, s)
    nugget = cfg.noise + cfg.jitter
    # every cell at once: plain assembly, as the reference's vmapped cells
    k = kref.gp_kernel_fn(cfg.kernel, kref.gp_sqdist_ref(xe, xe), ls, 1.0)
    eye = torch.eye(s, dtype=torch.float32, device=dev)
    pair = ve[:, :, None] * ve[:, None, :]
    k = torch.where(pair > 0.5, k + nugget * eye, eye)
    chol = cholesky_or_nan(k)
    alpha = torch.cholesky_solve((ye * ve)[..., None], chol)[..., 0]
    cnt = torch.clamp_min(ve.sum(1), 1.0)
    centroid = (xe * ve[..., None]).sum(1) / cnt[:, None]
    return EnsembleGPState(x=xe, valid=ve, chol=chol, alpha=alpha,
                           centroid=centroid, y_mean=y_mean, y_std=y_std,
                           lengthscale=ls, best=(y.min() - y_mean) / y_std)


def _nearest_experts(cfg, state: EnsembleGPState, xq):
    """Indices (..., k) of the k experts whose centroids lie nearest the
    batch centroid of xq (..., q, d), nearest first. The reference takes
    ``lax.top_k(-d2, k)``, which puts the lower index first among ties;
    ``torch.topk`` promises no order among ties, so this takes the first k
    of a stable ascending sort of d2: the same experts in the same order."""
    k_sel = min(cfg.n_experts_predict, state.x.shape[0])
    qc = xq.mean(-2)
    d2 = ((state.centroid - qc[..., None, :]) ** 2).sum(-1)      # (..., E)
    return torch.argsort(d2, dim=-1, stable=True)[..., :k_sel]


def _expert_parts(cfg, state: EnsembleGPState, xq):
    """Each selected expert's mean (..., k, q) and V = L^-1 k_s (..., k, s,
    q) at xq (..., q, d), cross-covariances in plain torch (the acquisition
    ascent differentiates through them)."""
    sel = _nearest_experts(cfg, state, xq)
    xc, vc = state.x[sel], state.valid[sel]           # (..., k, s, d/-)
    ks = kref.gp_kernel_fn(
        cfg.kernel, kref.gp_sqdist_ref(xq[..., None, :, :], xc),
        state.lengthscale, 1.0) * vc[..., None, :]     # (..., k, q, s)
    mean = (ks @ state.alpha[sel][..., None])[..., 0]
    v = _solve_lower(state.chol[sel], ks.transpose(-1, -2))
    return mean, v


def posterior_ensemble(cfg, state: EnsembleGPState, xq):
    """Joint posterior of xq (..., q, d) from the k nearest experts (by
    batch centroid to cell centroid), merged by generalized product-of-
    experts with uniform weights 1/k: precision = mean of the expert
    precisions, mean precision-weighted. k = 1 (E = 1) is exactly the single
    expert."""
    means, v = _expert_parts(cfg, state, xq)
    kq = kref.gp_kernel_fn(cfg.kernel, kref.gp_sqdist_ref(xq, xq),
                           state.lengthscale, 1.0)[..., None, :, :]
    covs = kq - v.transpose(-1, -2) @ v
    covs = 0.5 * (covs + covs.transpose(-1, -2))
    q = xq.shape[-2]
    jit_eye = 10.0 * cfg.jitter * torch.eye(q, dtype=torch.float32,
                                           device=xq.device)
    precs = torch.linalg.inv(covs + jit_eye)                 # (..., k, q, q)
    prec = precs.mean(-3)
    cov = torch.linalg.inv(prec + jit_eye)
    mean = (cov @ (precs @ means[..., None]).mean(-3))[..., 0]
    return mean, 0.5 * (cov + cov.transpose(-1, -2))


def mean_var_ensemble(cfg, state: EnsembleGPState, xq):
    """Marginal gPoE merge — per-point precisions only."""
    means, v = _expert_parts(cfg, state, xq)
    vars_ = torch.clamp_min(1.0 - (v * v).sum(-2), cfg.jitter)
    var = 1.0 / (1.0 / vars_).mean(-2)
    mean = (means / vars_).mean(-2) * var
    return mean, torch.clamp_min(var, cfg.jitter)


def fit_big(cfg, x, y):
    """Route the archive-scale fit by ``cfg.big_method``."""
    if cfg.big_method == "ensemble":
        return fit_ensemble(cfg, x, y)
    if cfg.big_method != "inducing":
        raise ValueError(f"unknown big_method: {cfg.big_method!r}")
    return fit_inducing(cfg, x, y)
