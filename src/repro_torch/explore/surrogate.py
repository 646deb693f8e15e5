"""Surrogate-assisted adaptive exploration: a batched Gaussian-process
ask/tell engine with q-EI / q-UCB batch acquisition, ported from
``repro.explore.surrogate``.

- **GP core** (``gp_fit`` / ``gp_posterior``): inputs normalized to the
  unit cube, outputs standardized; the (n, n) distance matrix comes from the
  hand-written ``gp_sqdist`` kernel (``kernels.ops``); the lengthscale is
  chosen from a fixed grid by marginal likelihood (one batched Cholesky over
  the grid). Histories past ``cfg.n_max_exact`` go to the archive-scale
  fits (``explore/bigfit.py``: inducing points or a local-GP ensemble).
- **Batch acquisition** (``q_ei`` / ``q_ucb``): Monte-Carlo over the joint
  posterior of the q-point batch. Column i of the normals depends only on
  (seed, round, slot i), so nested batches share their common slots' draws
  and q-EI is exactly monotone in q.
- **Proposals** (``propose_batch``): the acquisition is maximized jointly
  over the (q, dim) batch by a multi-start projected-gradient ascent, the
  starts a batch dimension under autograd.
- **Ask/tell** (:class:`SurrogateExplorer`) and the asynchronous loop
  (``run_surrogate``), which streams each round's batch through an
  ``Environment``/``EnvironmentPool``, or as one tenant of an
  ``ExplorationService``, and re-scores the still-queued candidates as
  results land (OSPREY-style; dispatch order only).

Randomness is split into *draws* and *applies*: ``draw_proposal_noise``
draws a round's starts and normals on the host from generators seeded by
(seed, round, ...), so a run draws the same numbers on the CPU and on the
card, and tests can hand the apply functions the reference's own draws.
Each evaluation job seeds its own generator from (seed, round, slot) on the
evaluation device, inside the job: a retried or speculated attempt draws
the same noise, so a run with injected faults is bit-identical to a clean
one.

A failed Cholesky writes NaN (``cholesky_or_nan``), as
``jnp.linalg.cholesky`` does, where ``torch.linalg.cholesky`` would raise:
the ascent's ``nan_to_num`` and the ``argmax`` over starts then behave as
the reference's.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
import time
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.explore.sampling import _sobol_points
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.runtime.device import make_generator, resolve_device


@dataclasses.dataclass(frozen=True)
class SurrogateConfig:
    """Configuration of the GP surrogate and its acquisition optimizer (the
    reference's fields and defaults).

    bounds: ((lo, hi), ...) physical box, one pair per genome dim.
    kernel: "matern52" or "rbf".
    noise: observation noise variance (standardized-y units).
    jitter: PSD jitter added to every Cholesky.
    lengthscales: the marginal-likelihood fit grid (unit-cube units).
    q: proposals per ask/tell round.
    n_init: Sobol space-filling points before the GP takes over (rounded up
        to a multiple of q).
    mc_samples: Monte-Carlo draws for the batch acquisition.
    n_starts / opt_steps / opt_lr: the multi-start ascent.
    ucb_beta: exploration weight of q-UCB.
    acquisition: "qei" or "qucb".
    seed: master seed — the whole trajectory is a pure function of it.
    n_max_exact: largest history the dense O(n^3) fit handles; beyond it
        ``gp_fit`` routes to the archive-scale path (explore/bigfit.py).
    big_method: "inducing" (SGPR, incremental tell) or "ensemble" (local
        experts, refit per round).
    n_inducing: inducing-set size m of the SGPR path.
    expert_size / n_experts_predict: local-ensemble cell size and how many
        nearest experts merge at prediction.
    """
    bounds: Tuple[Tuple[float, float], ...]
    kernel: str = "matern52"
    noise: float = 1e-4
    jitter: float = 1e-6
    lengthscales: Tuple[float, ...] = (0.05, 0.1, 0.2, 0.4, 0.8)
    q: int = 8
    n_init: int = 16
    mc_samples: int = 96
    n_starts: int = 12
    opt_steps: int = 24
    opt_lr: float = 0.08
    ucb_beta: float = 2.0
    acquisition: str = "qei"
    seed: int = 0
    n_max_exact: int = 1024
    big_method: str = "inducing"
    n_inducing: int = 512
    expert_size: int = 512
    n_experts_predict: int = 4

    @property
    def dim(self) -> int:
        return len(self.bounds)

    @property
    def n_init_padded(self) -> int:
        return -(-self.n_init // self.q) * self.q

    def lo(self) -> np.ndarray:
        return np.asarray([b[0] for b in self.bounds], np.float32)

    def hi(self) -> np.ndarray:
        return np.asarray([b[1] for b in self.bounds], np.float32)


class GPState(NamedTuple):
    """A fitted GP: unit-cube inputs + Cholesky of the (jittered) train
    covariance + precomputed solve; y is standardized inside."""
    x: torch.Tensor            # (n, d) unit-cube inputs
    chol: torch.Tensor         # (n, n) L with L L^T = K + (noise+jitter) I
    alpha: torch.Tensor        # (n,)  (K + (noise+jitter) I)^-1 y_std
    y_mean: torch.Tensor       # ()
    y_std: torch.Tensor        # ()
    lengthscale: torch.Tensor  # ()
    best: torch.Tensor         # () standardized incumbent (min observed)


def gp_state_from_arrays(tree, device="cuda") -> GPState:
    """A GPState from the reference's ``GPState`` held as numpy arrays (any
    object with its attributes), on ``device``."""
    dev = resolve_device(device)
    return GPState(*(torch.tensor(np.asarray(getattr(tree, f)),
                                  dtype=torch.float32, device=dev)
                     for f in GPState._fields))


def derive_seed(*path: int) -> int:
    """A 63-bit generator seed that is a pure function of ``path`` (seed,
    round, slot, ...), the port's counterpart of ``fold_in``."""
    h = hashlib.sha256(repr(tuple(int(p) for p in path)).encode()).digest()
    return int.from_bytes(h[:8], "big") >> 1


def cholesky_or_nan(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of each matrix of ``a``; a matrix that is not
    positive definite gets an all-NaN factor, as ``jnp.linalg.cholesky``
    returns, where ``torch.linalg.cholesky`` would raise."""
    l, info = torch.linalg.cholesky_ex(a)
    return torch.where((info > 0)[..., None, None],
                       torch.full_like(l, float("nan")), l)


def _solve_lower(l, b):
    return torch.linalg.solve_triangular(l, b, upper=False)


def _nugget_eye(cfg: SurrogateConfig, n: int, device) -> torch.Tensor:
    return (cfg.noise + cfg.jitter) * torch.eye(n, dtype=torch.float32,
                                                device=device)


def lengthscale_sweep(cfg: SurrogateConfig, d2, ys, grid):
    """Factor K(ls) + (noise+jitter) I for every lengthscale of ``grid``
    (G,) over one (n, n) distance matrix, as one batched Cholesky. Returns
    (chol (G, n, n), alpha (G, n), negative log marginal likelihood (G,)).
    The covariance map is plain torch here, as in the reference."""
    n = d2.shape[0]
    k = kref.gp_kernel_fn(cfg.kernel, d2, grid[:, None, None], 1.0) \
        + _nugget_eye(cfg, n, d2.device)
    chol = cholesky_or_nan(k)
    alpha = torch.cholesky_solve(ys[None, :, None].expand(len(grid), n, 1),
                                 chol)[..., 0]
    nll = 0.5 * (ys * alpha).sum(-1) \
        + torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)
    return chol, alpha, nll


# ---------------------------------------------------------------------------
# GP core
# ---------------------------------------------------------------------------
def gp_fit(cfg: SurrogateConfig, x, y):
    """Fit the GP on unit-cube x (n, d) and raw y (n,): standardize y,
    sweep the lengthscale grid by exact negative log marginal likelihood
    (one batched Cholesky over ONE distance matrix), keep the winner's
    factor. Histories beyond ``cfg.n_max_exact`` route to the archive-scale
    path and return its state type."""
    from repro_torch.explore import bigfit
    if x.shape[0] > cfg.n_max_exact:
        return bigfit.fit_big(cfg, x, y)
    y_mean = y.mean()
    y_std = torch.clamp_min(y.std(correction=0), 1e-8)
    ys = (y - y_mean) / y_std
    d2 = kops.gp_sqdist(x, x)          # the kernel, as the reference's kops
    grid = torch.tensor(cfg.lengthscales, dtype=torch.float32,
                        device=x.device)
    chol, alpha, nll = lengthscale_sweep(cfg, d2, ys, grid)
    i = torch.argmin(nll)
    return GPState(x=x, chol=chol[i], alpha=alpha[i], y_mean=y_mean,
                   y_std=y_std, lengthscale=grid[i], best=ys.min())


def gp_posterior(cfg: SurrogateConfig, state, xq):
    """Joint posterior of the batch xq (..., m, d) in standardized units:
    mean (..., m) and full covariance (..., m, m), symmetrized. Dispatches
    on the fitted state's type.

    The cross-covariances assemble through the plain ``ref.gp_sqdist_ref``
    and ``ref.gp_kernel_fn``, not the kernel, as the reference does on
    purpose (``repro/explore/surrogate.py:185-190``): the acquisition ascent
    differentiates through this function, and the m x n blocks are small."""
    from repro_torch.explore import bigfit
    if isinstance(state, bigfit.InducingGPState):
        return bigfit.posterior_inducing(cfg, state, xq)
    if isinstance(state, bigfit.EnsembleGPState):
        return bigfit.posterior_ensemble(cfg, state, xq)
    ks = kref.gp_kernel_fn(cfg.kernel, kref.gp_sqdist_ref(xq, state.x),
                           state.lengthscale, 1.0)           # (..., m, n)
    mean = ks @ state.alpha
    v = _solve_lower(state.chol, ks.transpose(-1, -2))
    kq = kref.gp_kernel_fn(cfg.kernel, kref.gp_sqdist_ref(xq, xq),
                           state.lengthscale, 1.0)
    cov = kq - v.transpose(-1, -2) @ v
    return mean, 0.5 * (cov + cov.transpose(-1, -2))


def gp_mean_var(cfg: SurrogateConfig, state, xq):
    """Marginal posterior mean/variance (m,) in standardized units (plain
    assembly, as in ``gp_posterior``)."""
    from repro_torch.explore import bigfit
    if isinstance(state, bigfit.InducingGPState):
        return bigfit.mean_var_inducing(cfg, state, xq)
    if isinstance(state, bigfit.EnsembleGPState):
        return bigfit.mean_var_ensemble(cfg, state, xq)
    ks = kref.gp_kernel_fn(cfg.kernel, kref.gp_sqdist_ref(xq, state.x),
                           state.lengthscale, 1.0)
    mean = ks @ state.alpha
    v = _solve_lower(state.chol, ks.transpose(-1, -2))
    var = torch.clamp_min(1.0 - (v * v).sum(-2), cfg.jitter)
    return mean, var


# ---------------------------------------------------------------------------
# batch acquisition (maximize; minimization of the objective)
# ---------------------------------------------------------------------------
def _batch_chol(cov, jitter):
    """Lower Cholesky factor of each (q, q) batch covariance + jitter I,
    column by column in a fixed order (all NaN where one is not positive
    definite). Entry (i, j) is (a_ij - sum_{k<j} L_ik L_jk) / L_jj with the
    sum in k order, whatever q is, so the factor of a leading principal
    submatrix is exactly the leading block of the factor; LAPACK's blocked
    and recursive schedules do not promise that bit for bit."""
    q = cov.shape[-1]
    a = cov + jitter * torch.eye(q, dtype=cov.dtype, device=cov.device)
    rows = torch.arange(q, device=cov.device)
    cols = []
    for j in range(q):
        s = a[..., :, j]
        for k in range(j):
            s = s - cols[k] * cols[k][..., j:j + 1]
        d = torch.sqrt(s[..., j:j + 1])
        cols.append(torch.where(rows > j, s / d,
                                torch.where(rows == j, d, 0.0)))
    chol = torch.stack(cols, -1)
    bad = ~(chol.diagonal(dim1=-2, dim2=-1) > 0).all(-1)
    return torch.where(bad[..., None, None], float("nan"), chol)


def _mc_samples(mean, normals, chol):
    """mean + L z for every draw z (a row of ``normals``): sample i sums
    z_j L_ij over j in order, so a slot's samples do not depend on the
    batch size q (entries of L past the diagonal are exact zeros)."""
    acc = normals[:, None, 0] * chol[..., None, :, 0]
    for j in range(1, chol.shape[-1]):
        acc = acc + normals[:, None, j] * chol[..., None, :, j]
    return mean[..., None, :] + acc


def q_ei(mean, cov, best, normals, *, jitter: float = 1e-6):
    """Monte-Carlo q-EI (minimization): E[max(best - min_i Y_i, 0)] over
    joint posterior samples Y = mean + L z of the batch; ``normals``
    (n_samples, q) are the z. Leading batch dims of mean/cov broadcast.
    Exactly monotone in q for nested batches (``_batch_chol``,
    ``_mc_samples``)."""
    samples = _mc_samples(mean, normals, _batch_chol(cov, jitter))
    return torch.clamp_min(best - samples.min(-1).values, 0.0).mean(-1)


def q_ucb(mean, cov, beta, normals, *, jitter: float = 1e-6):
    """Monte-Carlo q-UCB (minimization form): E[max_i (beta |L z|_i -
    mean_i)] over the ``normals`` (n_samples, q)."""
    lz = _mc_samples(torch.zeros_like(mean), normals,
                     _batch_chol(cov, jitter))
    samples = mean[..., None, :] - beta * torch.abs(lz)
    return (-samples.min(-1).values).mean(-1)


def expected_improvement(mean, var, best):
    """Closed-form single-point EI (minimization) — the per-candidate
    priority score used for dispatch ordering and re-prioritization."""
    sigma = torch.sqrt(var)
    u = (best - mean) / sigma
    phi = torch.exp(-0.5 * u * u) / math.sqrt(2.0 * math.pi)
    cdf = 0.5 * (1.0 + torch.erf(u / math.sqrt(2.0)))
    return (best - mean) * cdf + sigma * phi


def draw_proposal_noise(cfg: SurrogateConfig, round_: int):
    """The draws of round ``round_``'s ascent, on the host: starts
    (n_starts, q, dim) uniform in the unit cube and normals (mc_samples, q)
    whose column i comes from a generator seeded by (seed, round, 1, i)
    alone."""
    gen = torch.Generator().manual_seed(derive_seed(cfg.seed, round_, 0))
    starts = torch.rand((cfg.n_starts, cfg.q, cfg.dim), generator=gen)
    normals = torch.stack([torch.randn(
        (cfg.mc_samples,), generator=torch.Generator().manual_seed(
            derive_seed(cfg.seed, round_, 1, i))) for i in range(cfg.q)], 1)
    return starts, normals


def propose_batch(cfg: SurrogateConfig, state, starts, normals):
    """Maximize the batch acquisition jointly over (q, dim) by projected
    gradient ascent from every start at once (the reference's vmap over
    starts is the leading batch dimension; each start steps along its own
    normalized gradient). Returns (batch (q, d) in the unit cube,
    acquisition value)."""

    def score(xq):
        mean, cov = gp_posterior(cfg, state, xq)
        if cfg.acquisition == "qucb":
            return q_ucb(mean, cov, cfg.ucb_beta, normals,
                         jitter=cfg.jitter * 10.0)
        return q_ei(mean, cov, state.best, normals, jitter=cfg.jitter * 10.0)

    x = starts
    with torch.enable_grad():
        for _ in range(cfg.opt_steps):
            x = x.detach().requires_grad_(True)
            g = torch.nan_to_num(torch.autograd.grad(score(x).sum(), x)[0])
            norm = torch.linalg.vector_norm(g, dim=(-2, -1), keepdim=True)
            x = torch.clamp(x.detach() + cfg.opt_lr * g / (norm + 1e-12),
                            0.0, 1.0)
    with torch.no_grad():
        vals = score(x)
    i = torch.argmax(vals)
    return x[i], vals[i]


def _fantasy_scores(cfg: SurrogateConfig, chol, hx, hy, ls, xn, yn, mn, xp):
    """EI scores for pending candidates xp (q, d) under the posterior
    extended with this round's landed results. The history factor ``chol``
    is EXTENDED by a bordered rank-q block, never refactorized; landed rows
    are padded to q with ``mn`` masking (masked rows decouple to identity:
    zero alpha, zero cross-covariance). Plain assembly, as the reference's
    (``repro/explore/surrogate.py:310-327``)."""
    nugget = cfg.noise + cfg.jitter
    q, n = xn.shape[0], hx.shape[0]
    dev = xn.device
    b = kref.gp_kernel_fn(cfg.kernel, kref.gp_sqdist_ref(xn, hx),
                          ls, 1.0) * mn[:, None]
    l21 = _solve_lower(chol, b.T).T
    s22 = kref.gp_kernel_fn(cfg.kernel, kref.gp_sqdist_ref(xn, xn), ls, 1.0)
    eye_q = torch.eye(q, dtype=torch.float32, device=dev)
    pair = mn[:, None] * mn[None, :]
    s22 = torch.where(pair > 0.5, s22 + nugget * eye_q, eye_q)
    l22 = cholesky_or_nan(s22 - l21 @ l21.T)
    lext = torch.cat([
        torch.cat([chol, torch.zeros((n, q), dtype=torch.float32,
                                     device=dev)], 1),
        torch.cat([l21, l22], 1)], 0)
    cnt = n + mn.sum()
    mean = (hy.sum() + (yn * mn).sum()) / cnt
    var = (((hy - mean) ** 2).sum() + (mn * (yn - mean) ** 2).sum()) / cnt
    std = torch.clamp_min(torch.sqrt(torch.clamp_min(var, 0.0)), 1e-8)
    ys = torch.cat([(hy - mean) / std, mn * (yn - mean) / std])
    alpha = torch.cholesky_solve(ys[:, None], lext)[:, 0]
    ks = torch.cat([
        kref.gp_kernel_fn(cfg.kernel, kref.gp_sqdist_ref(xp, hx), ls, 1.0),
        kref.gp_kernel_fn(cfg.kernel, kref.gp_sqdist_ref(xp, xn),
                          ls, 1.0) * mn[None, :]], 1)
    pm = ks @ alpha
    v = _solve_lower(lext, ks.T)
    pv = torch.clamp_min(1.0 - (v * v).sum(0), cfg.jitter)
    # min over VALID standardized observations (history may be empty in
    # round 0 — the landed mask guarantees at least one valid entry)
    mask_full = torch.cat([torch.ones(n, dtype=torch.float32, device=dev),
                           mn])
    vals = torch.cat([(hy - mean) / std, (yn - mean) / std])
    best = torch.where(mask_full > 0.5, vals, float("inf")).min()
    return expected_improvement(pm, pv, best)


# ---------------------------------------------------------------------------
# ask/tell
# ---------------------------------------------------------------------------
class SurrogateExplorer:
    """Deterministic ask/tell surrogate explorer on ``device`` (the card
    unless the caller asks for the CPU).

    ``ask()`` returns the next batch of ``cfg.q`` physical-space genomes,
    highest dispatch priority first; ``tell(x, y)`` feeds results back in
    ask order. The trajectory is a pure function of (cfg, told history):
    round r's batch depends only on the points told for rounds < r. The
    history lives on the host as numpy arrays (the reference's layout);
    fits and proposals run on ``device``.
    """

    def __init__(self, cfg: SurrogateConfig, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        d = cfg.dim
        self.x01 = np.zeros((0, d), np.float32)   # unit-cube history
        self.y = np.zeros((0,), np.float32)
        self.round = 0
        self._sobol = _sobol_points(cfg.n_init_padded, d,
                                    cfg.seed).astype(np.float32)
        self._lo = cfg.lo()
        self._span = cfg.hi() - self._lo
        self.last_state = None
        self.last_priorities: Optional[np.ndarray] = None
        self._rescore_cache = None     # ((round, ls), chol of history K)
        # archive-scale fitted state, carried across rounds and updated
        # incrementally in tell() — None until history crosses
        # cfg.n_max_exact, and reset on resume (cold refit).
        self._big_state = None

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    # -------------------------------------------------------------- state io
    def state_arrays(self):
        """Checkpointable state: the told history + round counter (the
        reference's keys)."""
        return {"x01": self.x01, "y": self.y,
                "round": np.int32(self.round)}

    def load_state_arrays(self, tree) -> None:
        """Restore ``{"x01", "y", "round"}`` — written by this port or by the
        reference package (numpy arrays either way)."""
        self.x01 = np.asarray(tree["x01"], np.float32)
        self.y = np.asarray(tree["y"], np.float32)
        self.round = int(tree["round"])
        # the archive-scale state is not checkpointed: a resumed run
        # cold-refits from the restored history
        self._big_state = None

    # --------------------------------------------------------------- ask/tell
    @torch.no_grad()
    def ask(self) -> np.ndarray:
        """Next batch, (q, dim) physical coordinates, priority-ordered."""
        cfg = self.cfg
        n = len(self.x01)
        if n < cfg.n_init_padded:
            batch01 = self._sobol[n:n + cfg.q]
            self.last_state = None
            self.last_priorities = np.arange(cfg.q, 0.0, -1.0,
                                             dtype=np.float32)
        else:
            if n > cfg.n_max_exact:
                # archive scale: reuse the incrementally-updated state;
                # cold fit only when there is none yet (first crossing,
                # resume, ensemble method)
                if self._big_state is None:
                    self._big_state = gp_fit(cfg, self._t(self.x01),
                                             self._t(self.y))
                state = self._big_state
            else:
                state = gp_fit(cfg, self._t(self.x01), self._t(self.y))
            starts, normals = draw_proposal_noise(cfg, self.round)
            batch, _ = propose_batch(cfg, state, starts.to(self.device),
                                     normals.to(self.device))
            prio = expected_improvement(*gp_mean_var(cfg, state, batch),
                                        state.best).cpu().numpy()
            # host-side, exactly as the reference orders
            order = np.argsort(-prio, kind="stable")
            batch01 = batch.cpu().numpy()[order]
            self.last_state = state
            self.last_priorities = prio[order]
        return self._lo + np.asarray(batch01, np.float32) * self._span

    @torch.no_grad()
    def tell(self, x, y) -> None:
        """Record a completed batch (physical x (m, d), objectives y (m,)),
        in ask order — the round barrier. At archive scale the fitted
        inducing state absorbs the batch incrementally."""
        from repro_torch.explore import bigfit
        x01 = np.clip((np.asarray(x, np.float32) - self._lo) / self._span,
                      0.0, 1.0).astype(np.float32)
        ya = np.asarray(y, np.float32)
        self.x01 = np.concatenate([self.x01, x01])
        self.y = np.concatenate([self.y, ya])
        self.round += 1
        if isinstance(self._big_state, bigfit.InducingGPState):
            self._big_state = bigfit.update_inducing(
                self.cfg, self._big_state, self._t(x01), self._t(ya))
        elif self._big_state is not None:
            self._big_state = None   # ensemble experts: refit on next ask

    @property
    def best(self):
        """(best_x physical, best_y) observed so far (None before data)."""
        if len(self.y) == 0:
            return None, None
        i = int(np.argmin(self.y))
        return self._lo + self.x01[i] * self._span, float(self.y[i])

    @torch.no_grad()
    def predict(self, x):
        """Posterior ``(mean, std)`` at physical ``x`` (m, d), in RAW
        objective units. Reuses the round's fitted state when ``ask()``
        produced one; otherwise fits on the told history."""
        if len(self.y) < 2:
            raise ValueError("predict() needs >= 2 told observations")
        x01 = np.clip(
            (np.asarray(x, np.float32).reshape(-1, self.cfg.dim) - self._lo)
            / self._span, 0.0, 1.0).astype(np.float32)
        state = self.last_state
        if state is None:
            state = gp_fit(self.cfg, self._t(self.x01), self._t(self.y))
        mean, var = gp_mean_var(self.cfg, state, self._t(x01))
        y_std = float(state.y_std)
        mean = mean.cpu().numpy().astype(np.float64) * y_std \
            + float(state.y_mean)
        std = np.sqrt(np.maximum(var.cpu().numpy().astype(np.float64),
                                 0.0)) * y_std
        return mean, std

    @torch.no_grad()
    def rescore(self, partial_x01, partial_y, pending01) -> np.ndarray:
        """OSPREY-style re-prioritization: EI of still-pending candidates
        (k, d) under the posterior updated with this round's partial
        results. Affects dispatch ORDER only, never what is evaluated.

        Exact path: the history Cholesky comes from the round's fitted state
        (or is computed once per init round, cached) and is EXTENDED with
        the landed rows. Archive scale: the landed rows fold into a masked
        incremental update of the inducing statistics; an ensemble scores
        under the round's posterior as it is."""
        from repro_torch.explore import bigfit
        cfg = self.cfg
        q = cfg.q
        xn = np.zeros((q, cfg.dim), np.float32)
        yn = np.zeros((q,), np.float32)
        mn = np.zeros((q,), np.float32)
        k = len(partial_x01)
        xn[:k] = np.asarray(partial_x01, np.float32)
        yn[:k] = np.asarray(partial_y, np.float32)
        mn[:k] = 1.0
        p = len(pending01)
        xp = np.zeros((q, cfg.dim), np.float32)
        xp[:p] = np.asarray(pending01, np.float32)
        xn, yn, mn, xp = (self._t(a) for a in (xn, yn, mn, xp))

        if isinstance(self.last_state, bigfit.InducingGPState):
            st2 = bigfit.update_inducing(cfg, self.last_state, xn, yn, mn)
            scores = expected_improvement(
                *bigfit.mean_var_inducing(cfg, st2, xp), st2.best)
            return scores.cpu().numpy()[:p]
        if isinstance(self.last_state, bigfit.EnsembleGPState):
            # experts would need a refit to absorb the landed rows; score
            # under the round's posterior as it is (dispatch order only)
            scores = expected_improvement(
                *bigfit.mean_var_ensemble(cfg, self.last_state, xp),
                self.last_state.best)
            return scores.cpu().numpy()[:p]

        hx = self._t(self.x01)
        if self.last_state is not None:
            ls = self.last_state.lengthscale
            chol = self.last_state.chol
        else:
            ls_f = cfg.lengthscales[len(cfg.lengthscales) // 2]
            cache = self._rescore_cache
            if cache is None or cache[0] != (self.round, ls_f):
                # the history factor in plain torch, as the reference's
                # (repro/explore/surrogate.py:353-355)
                kh = kref.gp_kernel_fn(cfg.kernel,
                                       kref.gp_sqdist_ref(hx, hx), ls_f, 1.0)
                self._rescore_cache = cache = (
                    (self.round, ls_f),
                    cholesky_or_nan(kh + _nugget_eye(cfg, len(hx),
                                                     self.device)))
            ls = torch.tensor(ls_f, dtype=torch.float32, device=self.device)
            chol = cache[1]
        scores = _fantasy_scores(cfg, chol, hx, self._t(self.y), ls, xn, yn,
                                 mn, xp)
        return scores.cpu().numpy()[:p]


# ---------------------------------------------------------------------------
# asynchronous ask/tell loop
# ---------------------------------------------------------------------------
class SurrogateResult(NamedTuple):
    """Outcome of one (possibly interrupted/resumed) surrogate run."""
    genomes: Optional[np.ndarray]      # (n, d) physical — None if interrupted
    objectives: Optional[np.ndarray]   # (n,)
    best_genome: Optional[np.ndarray]
    best_objective: Optional[float]
    rounds_done: int
    rounds_total: int
    resumed_rounds: int
    interrupted: bool
    attempts: int                      # environment attempts incl. retries
    repriorities: int                  # OSPREY-style queue re-orderings
    wall_s: float


def make_eval_task(cfg: SurrogateConfig, eval_fn: Callable, device="cuda"):
    """One proposal evaluation as a PyTask: the context carries (round,
    slot, genome tuple); the job seeds its own generator from (seed, round,
    slot) on ``device``, inside the job — pure, resubmittable,
    fingerprint-verifiable. ``eval_fn(generator, genomes (1, d)) -> (1,)``.
    """
    from repro_torch.core.prototype import Val
    from repro_torch.core.task import PyTask
    dev = resolve_device(device)

    def fn(ctx):
        r, s = int(ctx["round"]), int(ctx["slot"])
        x = torch.tensor([list(ctx["x"])], dtype=torch.float32, device=dev)
        gen = make_generator(derive_seed(cfg.seed, r, s), dev)
        return {"y": float(eval_fn(gen, x)[0])}

    return PyTask("propose_eval", fn,
                  inputs=(Val("round", int), Val("slot", int), Val("x")),
                  outputs=(Val("y", float),))


def run_surrogate(cfg: SurrogateConfig, eval_fn: Callable, *,
                  rounds: int, environment=None, checkpoint_dir: str = None,
                  stop_after_rounds: Optional[int] = None, record=None,
                  progress: Callable[[int, int], None] = None,
                  service=None, experiment_id: str = "surrogate",
                  device="cuda",
                  settings: Optional[str] = None) -> SurrogateResult:
    """Drive the ask/tell loop for ``rounds`` rounds of ``cfg.q``
    evaluations each, inline or through a (fault-injected) Environment or
    EnvironmentPool, or as tenant ``experiment_id`` of a shared
    ``ExplorationService`` (``service=``, not with ``environment=``), with
    the GP engine and the evaluations on ``device``.

    Each round: ``ask()`` fixes the batch; jobs stream through
    ``submit_async`` up to the environment's capacity at a time, highest
    acquisition priority first; every arrival triggers a re-score of the
    still-queued slots (dispatch order only); the round barrier ``tell``s
    results in slot order. With ``checkpoint_dir`` the history commits
    every round and the run resumes from the newest commit; ``settings`` (a
    JSON string) is stored with each commit, and a resume from a commit
    written with other settings raises. ``stop_after_rounds`` is the mid-run
    kill switch the resume tests drive.

    With ``service=`` each slot is submitted under its ask-order priority
    (q - slot) and the re-score goes through ``service.update_priorities``:
    re-prioritization becomes a queue primitive, and the surrogate shares
    the service's pool with other tenants.

    ``eval_fn(generator, genomes (n, d)) -> (n,) scalars`` (minimized).
    """
    if service is not None and environment is not None:
        raise ValueError("pass either environment= or service=, not both")
    from repro_torch import checkpoint
    from repro_torch.core.cache import inputs_digest
    from repro_torch.core.prototype import Context
    from repro_torch.core.scheduler import TaskRecord

    t0 = time.monotonic()
    task = make_eval_task(cfg, eval_fn, device)
    explorer = SurrogateExplorer(cfg, device)
    q, d = cfg.q, cfg.dim

    # -- resume: restore the history committed last run ---------------------
    resumed = 0
    if checkpoint_dir is not None:
        last = checkpoint.latest_step(checkpoint_dir)
        if last:
            like = {"x01": np.zeros((last * q, d), np.float32),
                    "y": np.zeros((last * q,), np.float32),
                    "round": np.int32(0)}
            if settings is not None:
                like["settings"] = None
            saved = checkpoint.restore(checkpoint_dir, last, like)
            if settings is not None:
                checkpoint.require_settings(checkpoint_dir,
                                            saved["settings"].item(),
                                            settings)
            explorer.load_state_arrays(saved)
            resumed = last
            if record is not None:
                for r in range(last):
                    for s in range(q):
                        record.tasks.append(TaskRecord(
                            task=task.name, capsule=r * q + s,
                            environment="checkpoint",
                            inputs_digest="", started_s=0.0, wall_s=0.0,
                            retries=0, cache_hit=True, mode="cache"))

    attempts = 0
    repriorities = 0
    # a checkpoint may already hold MORE rounds than requested — the run
    # then does no new work, but the result stays self-consistent
    n_rounds = max(rounds, resumed)
    stop_at = n_rounds if stop_after_rounds is None \
        else min(n_rounds, stop_after_rounds)
    env_name = (environment.name if environment is not None
                else getattr(service, "name", None) or "inline")

    def note(r, s, ctx, meta):
        nonlocal attempts
        attempts += len(meta.get("attempts") or ()) or 1
        if record is not None:
            record.tasks.append(TaskRecord(
                task=task.name, capsule=r * q + s,
                environment=env_name,
                inputs_digest=inputs_digest(task, ctx),
                started_s=meta.get("t0", t0) - t0,
                wall_s=meta.get("wall_s", 0.0),
                retries=meta.get("retries", 0), cache_hit=False,
                mode="surrogate",
                # copy: a losing speculative attempt may append to the
                # pool's live meta list after submit_traced returns
                attempts=list(meta.get("attempts") or ()) or None))

    for r in range(explorer.round, stop_at):
        xq = explorer.ask()                       # (q, d), priority order
        ctxs = [Context({"round": r, "slot": s,
                         "x": tuple(float(v) for v in xq[s])})
                for s in range(q)]
        ys: List[Optional[float]] = [None] * q

        if service is not None:
            # one tenant of a shared service: slots carry their ask-order
            # priority into the queue, and the re-score below runs through
            # update_priorities, the queue primitive
            tid_by_slot = {s: service.submit_tasks(
                experiment_id, [(task, ctxs[s])], priority=float(q - s))[0]
                for s in range(q)}
            slot_by_tid = {tid: s for s, tid in tid_by_slot.items()}
            for tid, out in service.as_completed(
                    experiment_id, list(tid_by_slot.values())):
                s = slot_by_tid[tid]
                if out is None:
                    service.result(experiment_id, tid)   # raises the error
                ys[s] = out["y"]
                note(r, s, ctxs[s], {"retries": 0, "wall_s": 0.0})
                waiting = [
                    w for w in range(q) if ys[w] is None
                    and (e := service.queue.get(
                        experiment_id, tid_by_slot[w])) is not None
                    and e.state == "pending"]
                landed = [w for w in range(q) if ys[w] is not None]
                if len(waiting) > 1 and landed:
                    x01 = (xq - explorer._lo) / explorer._span
                    scores = explorer.rescore(
                        x01[landed], [ys[w] for w in landed], x01[waiting])
                    if service.update_priorities(
                            experiment_id,
                            {tid_by_slot[w]: float(scores[i])
                             for i, w in enumerate(waiting)}):
                        repriorities += 1
        elif environment is None:
            for s in range(q):
                a_t0 = time.monotonic()
                out = task.run(ctxs[s])
                ys[s] = out["y"]
                note(r, s, ctxs[s], {"t0": a_t0, "retries": 0,
                                     "wall_s": time.monotonic() - a_t0})
        else:
            import concurrent.futures as cf
            cap = max(2, getattr(environment, "total_capacity", 2))
            queue = list(range(q))               # priority-ordered slots
            inflight: dict = {}
            while queue or inflight:
                while queue and len(inflight) < cap:
                    s = queue.pop(0)
                    inflight[environment.submit_async(task, ctxs[s])] = s
                done_set, _ = cf.wait(
                    list(inflight), return_when=cf.FIRST_COMPLETED)
                for f in done_set:
                    s = inflight.pop(f)
                    out, meta = f.result()
                    ys[s] = out["y"]
                    note(r, s, ctxs[s], meta)
                if queue and len(queue) > 1:
                    # re-score the still-queued slots under the posterior
                    # updated with this round's landed results; dispatch
                    # order follows the new priorities
                    landed = [s for s in range(q) if ys[s] is not None]
                    if landed:
                        x01 = (xq - explorer._lo) / explorer._span
                        scores = explorer.rescore(
                            x01[landed], [ys[s] for s in landed],
                            x01[queue])
                        new = [queue[i] for i in
                               np.argsort(-scores, kind="stable")]
                        if new != queue:
                            repriorities += 1
                        queue = new
        explorer.tell(xq, [float(v) for v in ys])
        if checkpoint_dir is not None:
            tree = explorer.state_arrays()
            if settings is not None:
                tree["settings"] = settings
            checkpoint.save(checkpoint_dir, explorer.round, tree)
            checkpoint.prune(checkpoint_dir, keep=2)
        if progress:
            progress(explorer.round, n_rounds)

    wall = time.monotonic() - t0
    if explorer.round < n_rounds:
        return SurrogateResult(
            genomes=None, objectives=None, best_genome=None,
            best_objective=None, rounds_done=explorer.round,
            rounds_total=n_rounds, resumed_rounds=resumed, interrupted=True,
            attempts=attempts, repriorities=repriorities, wall_s=wall)
    best_x, best_y = explorer.best
    return SurrogateResult(
        genomes=explorer._lo + explorer.x01 * explorer._span,
        objectives=explorer.y.copy(), best_genome=best_x,
        best_objective=best_y, rounds_done=explorer.round,
        rounds_total=n_rounds, resumed_rounds=resumed, interrupted=False,
        attempts=attempts, repriorities=repriorities, wall_s=wall)
