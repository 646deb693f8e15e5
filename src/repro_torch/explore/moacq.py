"""Multi-objective surrogate acquisition over the NSGA-II archive: qEHVI,
ported from ``repro.explore.moacq``.

Independent per-objective GPs (each through ``surrogate.gp_fit``, so the
archive-scale inducing/ensemble routing applies per objective), a candidate
pool bred from the live Pareto archive by the NSGA-II variation operators,
and a qEHVI-style batch acquisition, expected hypervolume improvement by
Monte-Carlo box sampling:

- HV is estimated by uniform samples U in the [ideal, ref] box; the cells
  still alive (not dominated by the current front) come from ONE pairwise
  sweep, ``kops.dominance_pass(u, front)``: the ``dominance_pass`` kernel's
  rectangular launch on the card, its plain version on the CPU (the
  reference calls its plain version here; both give equal counts).
- the batch is built greedily (kriging believer): each slot scores every
  pool candidate by the expected fraction of alive cells its posterior
  samples dominate, picks the best, then commits that candidate's posterior
  mean as a pseudo-observation so later slots chase the remaining
  hypervolume. The comparisons run on the device; the greedy loop over
  their (P, S, U) booleans runs on the host in numpy, as the reference's.
- the archive itself is maintained by ``evolution.archive.merge`` (rank +
  crowding truncation), the GA's survival rule.

Dominance is invariant under per-objective affine maps, and the box volume
scales by a constant across candidates, so the acquisition runs in each
GP's standardized units without changing the argmax.

Randomness is split into *draws* and *applies*: ``draw_ask`` draws a
round's pool offspring, the pool's uniform half, the box samples and the
posterior normals on the host, each from a generator seeded by (seed,
round, ...) with the reference's ``fold_in`` numbers, so a round draws the
same numbers on the CPU and on the card and tests can hand ``ask`` the
reference's own draws. ask() is then a pure function of (cfg, history), and
the archive is replayed from history on resume.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.evolution import archive as earchive
from repro_torch.evolution import nsga2
from repro_torch.explore import surrogate as sur
from repro_torch.explore.sampling import _sobol_points
from repro_torch.kernels import ops as kops
from repro_torch.runtime.device import make_generator, resolve_device


@dataclasses.dataclass(frozen=True)
class MOSurrogateConfig:
    """qEHVI explorer configuration (the reference's fields and defaults).
    GP hyper-parameters mirror ``surrogate.SurrogateConfig`` (the
    archive-scale routing knobs included); the acquisition adds the
    archive/pool machinery and the hypervolume reference point."""
    bounds: Tuple[Tuple[float, float], ...]
    n_objectives: int = 3
    kernel: str = "matern52"
    noise: float = 1e-4
    jitter: float = 1e-6
    lengthscales: Tuple[float, ...] = (0.05, 0.1, 0.2, 0.4, 0.8)
    q: int = 8
    n_init: int = 16
    mc_samples: int = 32        # posterior draws per candidate
    hv_samples: int = 128       # box samples for the HV estimate
    pool_size: int = 64         # candidates per round (archive offspring
                                # + space-filling)
    archive_size: int = 64
    ref_point: Optional[Tuple[float, ...]] = None   # raw units; None =
                                # observed nadir + 10% span, per round
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

    def gp_config(self) -> sur.SurrogateConfig:
        """The per-objective scalar GP view of this config."""
        return sur.SurrogateConfig(
            bounds=self.bounds, kernel=self.kernel, noise=self.noise,
            jitter=self.jitter, lengthscales=self.lengthscales, q=self.q,
            n_init=self.n_init, seed=self.seed,
            n_max_exact=self.n_max_exact, big_method=self.big_method,
            n_inducing=self.n_inducing, expert_size=self.expert_size,
            n_experts_predict=self.n_experts_predict)


class AskDraws(NamedTuple):
    """Every random number one qEHVI ask consumes (host tensors)."""
    offspring: nsga2.OffspringDraws   # the pool's bred half
    uniform: torch.Tensor             # (pool - pool//2, d) its uniform half
    u: torch.Tensor                   # (hv_samples, M) box uniforms in [0, 1)
    z: torch.Tensor                   # (pool, mc_samples, M) normals


def _host_generator(*path: int) -> torch.Generator:
    return torch.Generator().manual_seed(sur.derive_seed(*path))


def draw_ask(cfg: MOSurrogateConfig, round_: int) -> AskDraws:
    """The draws of round ``round_``'s ask, on the host, each from its own
    generator seeded by (seed, round, k) with the reference's ``fold_in``
    numbers: 3 the offspring, 4 the uniform half, (7, 0) the box samples,
    (7, 1) the normals."""
    d, m, p = cfg.dim, cfg.n_objectives, cfg.pool_size
    n_off = p // 2
    ga_cfg = _unit_ga(cfg)
    return AskDraws(
        offspring=nsga2.draw_offspring(
            ga_cfg, _host_generator(cfg.seed, round_, 3), cfg.archive_size,
            n_off),
        uniform=torch.rand((p - n_off, d),
                           generator=_host_generator(cfg.seed, round_, 4)),
        u=torch.rand((cfg.hv_samples, m),
                     generator=_host_generator(cfg.seed, round_, 7, 0)),
        z=torch.randn((p, cfg.mc_samples, m),
                      generator=_host_generator(cfg.seed, round_, 7, 1)))


def _unit_ga(cfg: MOSurrogateConfig) -> nsga2.NSGA2Config:
    """Unit-cube variation operators over the archive (pool breeding)."""
    d = cfg.dim
    return nsga2.NSGA2Config(
        mu=cfg.archive_size, genome_dim=d,
        bounds=tuple((0.0, 1.0) for _ in range(d)),
        n_objectives=cfg.n_objectives, reevaluate=0.0)


def _box(y_std_all):
    """[ideal, ref] box in standardized units from the observed history
    (y_std_all (n, M) standardized)."""
    ideal = y_std_all.min(0).values
    nadir = y_std_all.max(0).values
    span = torch.clamp_min(nadir - ideal, 1e-6)
    return ideal - 0.05 * span, nadir + 0.1 * span


def qehvi_select(cfg: MOSurrogateConfig, mu_std, var_std, front_std, u01, z):
    """Greedy kriging-believer qEHVI: pick ``cfg.q`` of the P pool
    candidates. mu_std/var_std (P, M) marginal posteriors (standardized),
    front_std (F, M) the current non-dominated set (rows of ``nsga2.BIG``
    for padding), u01 (hv_samples, M) box uniforms and z (P, mc_samples, M)
    normals (``draw_ask``), all on one device. Returns (indices (q,), gains
    (q,) f32): the gains are the per-slot expected alive-cell fractions,
    monotone decreasing."""
    p = mu_std.shape[0]
    ideal, ref = _box(torch.cat(
        [front_std[(front_std < nsga2.BIG / 2).all(1)], mu_std]))
    u = ideal + (ref - ideal) * u01
    counts, _ = kops.dominance_pass(u, front_std)
    samples = mu_std[:, None, :] + torch.sqrt(var_std)[:, None, :] * z
    # dom[c, s, u]: posterior draw s of candidate c dominates box cell u
    le = samples[:, :, None, :] <= u[None, None, :, :]
    lt = samples[:, :, None, :] < u[None, None, :, :]
    dom = (le.all(-1) & lt.any(-1)).cpu().numpy()            # (P, S, NU)
    alive = (counts == 0).cpu().numpy()      # a mutable believer mask
    mu_np = mu_std.cpu().numpy()
    u_np = u.cpu().numpy()
    picked: List[int] = []
    gains: List[float] = []
    taken = np.zeros(p, bool)
    for _ in range(cfg.q):
        gain = (dom & alive[None, None, :]).mean(axis=(1, 2))
        gain[taken] = -np.inf
        c = int(np.argmax(gain))
        picked.append(c)
        gains.append(float(max(gain[c], 0.0)))
        taken[c] = True
        # believer: the pick's posterior mean joins the front, and the cells
        # it dominates stop counting for the remaining slots
        bel = mu_np[c]
        alive &= ~((bel[None, :] <= u_np).all(-1)
                   & (bel[None, :] < u_np).any(-1))
    return np.asarray(picked), np.asarray(gains, np.float32)


def hv_estimate(objectives, ref_point, *, n_samples: int = 4096, seed=0,
                device="cuda", u01=None) -> float:
    """Monte-Carlo hypervolume of a raw-unit objective set against
    ``ref_point``: box-sample fraction x box volume, the samples' dominance
    from one ``kops.dominance_pass`` sweep on ``device``. The (n_samples, M)
    uniforms come from a host generator seeded by ``derive_seed(seed)``;
    ``u01`` hands in other uniforms instead (tests replay the reference's).
    Deterministic in ``seed``."""
    dev = resolve_device(device)
    obj = torch.as_tensor(np.asarray(objectives, np.float32), device=dev)
    ref = torch.as_tensor(np.asarray(ref_point, np.float32), device=dev)
    ideal = obj.min(0).values
    vol = float(torch.prod(torch.clamp_min(ref - ideal, 0.0)))
    if vol == 0.0:
        return 0.0
    if u01 is None:
        u01 = torch.rand((n_samples, obj.shape[1]),
                         generator=_host_generator(seed))
    u = ideal + (ref - ideal) * u01.to(dev)
    counts, _ = kops.dominance_pass(u, obj)
    return float((counts > 0).to(torch.float32).mean()) * vol


class MOSurrogateExplorer:
    """Deterministic multi-objective ask/tell explorer on ``device`` (the
    card unless the caller asks for the CPU): per-objective GPs + qEHVI
    batches bred from the live Pareto archive. The history lives on the
    host as numpy arrays (the reference's layout); the archive, the fits and
    the acquisition run on ``device``."""

    def __init__(self, cfg: MOSurrogateConfig, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        d, m = cfg.dim, cfg.n_objectives
        self.x01 = np.zeros((0, d), np.float32)
        self.y = np.zeros((0, m), np.float32)
        self.round = 0
        self._sobol = _sobol_points(cfg.n_init_padded, d,
                                    cfg.seed).astype(np.float32)
        self._lo = cfg.lo()
        self._span = cfg.hi() - self._lo
        self.archive = earchive.init_archive(cfg.archive_size, d, m,
                                             device=self.device)
        self._ga = _unit_ga(cfg)
        self.last_gains: Optional[np.ndarray] = None

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    # -------------------------------------------------------------- state io
    def state_arrays(self):
        return {"x01": self.x01, "y": self.y,
                "round": np.int32(self.round)}

    @torch.no_grad()
    def load_state_arrays(self, tree) -> None:
        """Restore ``{"x01", "y", "round"}`` (written by this port or by the
        reference) and replay the archive from the history in round-sized
        blocks: merge is deterministic per call, so the replayed archive is
        the one the uninterrupted run carried."""
        self.x01 = np.asarray(tree["x01"], np.float32)
        self.y = np.asarray(tree["y"], np.float32)
        self.round = int(tree["round"])
        cfg = self.cfg
        self.archive = earchive.init_archive(cfg.archive_size, cfg.dim,
                                             cfg.n_objectives,
                                             device=self.device)
        for s in range(0, len(self.y), cfg.q):
            self.archive = earchive.merge(self.archive,
                                          self._t(self.x01[s:s + cfg.q]),
                                          self._t(self.y[s:s + cfg.q]))

    # --------------------------------------------------------------- ask/tell
    def _pool(self, draws: AskDraws) -> torch.Tensor:
        """Candidate pool (P, d) on the device: half bred from the archive
        by the NSGA-II variation operators (tournament + SBX + mutation over
        rank and crowding), half space-filling."""
        obj = self.archive.objectives
        ranks = nsga2.nondominated_ranks(obj, self.archive.valid)
        crowd = nsga2.crowding_distance(obj, ranks)
        off, _ = nsga2.apply_offspring(
            self._ga, nsga2.OffspringDraws(*(t.to(self.device)
                                             for t in draws.offspring)),
            self.archive.genomes, ranks, crowd)
        return torch.clamp(torch.cat([off, draws.uniform.to(self.device)]),
                           0.0, 1.0)

    @torch.no_grad()
    def ask(self, draws: Optional[AskDraws] = None) -> np.ndarray:
        """Next batch (q, dim) in physical coordinates, qEHVI-greedy order
        (slot 0 claimed the most expected hypervolume). ``draws`` replaces
        the round's own (``draw_ask``)."""
        cfg = self.cfg
        n = len(self.x01)
        if n < cfg.n_init_padded:
            batch01 = self._sobol[n:n + cfg.q]
            self.last_gains = None
            return self._lo + np.asarray(batch01, np.float32) * self._span
        if draws is None:
            draws = draw_ask(cfg, self.round)
        x = self._t(self.x01)
        gp_cfg = cfg.gp_config()
        states = [sur.gp_fit(gp_cfg, x, self._t(self.y[:, m]))
                  for m in range(cfg.n_objectives)]
        pool = self._pool(draws)
        mv = [sur.gp_mean_var(gp_cfg, st, pool) for st in states]
        mu_std = torch.stack([m for m, _ in mv], 1)            # (P, M)
        var_std = torch.stack([v for _, v in mv], 1)
        front_mask = earchive.pareto_front(self.archive)
        y_mean = torch.stack([st.y_mean for st in states])
        y_std = torch.stack([st.y_std for st in states])
        front_std = torch.where(
            front_mask[:, None],
            (self.archive.objectives - y_mean[None]) / y_std[None],
            nsga2.BIG)
        if cfg.ref_point is not None:
            ref_std = (self._t(cfg.ref_point) - y_mean) / y_std
            # candidates beyond the reference box cannot add hypervolume;
            # clamp their samples out by inflating their predicted mean
            mu_std = torch.where(mu_std > ref_std[None], nsga2.BIG, mu_std)
        picked, gains = qehvi_select(cfg, mu_std, var_std, front_std,
                                     draws.u.to(self.device),
                                     draws.z.to(self.device))
        self.last_gains = gains
        batch01 = pool.cpu().numpy()[picked]
        return self._lo + batch01.astype(np.float32) * self._span

    @torch.no_grad()
    def tell(self, x, y) -> None:
        """Record a completed batch (x (m, d) physical, y (m, M) raw
        objectives) and fold it into the Pareto archive."""
        x01 = np.clip((np.asarray(x, np.float32) - self._lo) / self._span,
                      0.0, 1.0).astype(np.float32)
        ya = np.asarray(y, np.float32)
        self.x01 = np.concatenate([self.x01, x01])
        self.y = np.concatenate([self.y, ya])
        self.round += 1
        self.archive = earchive.merge(self.archive, self._t(x01),
                                      self._t(ya))

    @torch.no_grad()
    def front(self):
        """(genomes physical, objectives raw) of the archive's rank-0
        members, as numpy arrays."""
        mask = earchive.pareto_front(self.archive).cpu().numpy()
        g01 = self.archive.genomes.cpu().numpy()[mask]
        return (self._lo + g01 * self._span,
                self.archive.objectives.cpu().numpy()[mask])


class MOSurrogateResult(NamedTuple):
    genomes: Optional[np.ndarray]        # (n, d) physical
    objectives: Optional[np.ndarray]     # (n, M) raw
    front_genomes: Optional[np.ndarray]
    front_objectives: Optional[np.ndarray]
    hv: Optional[float]                  # final front hypervolume (MC)
    rounds_done: int
    rounds_total: int
    resumed_rounds: int
    interrupted: bool
    attempts: int
    wall_s: float


def make_eval_task_mo(cfg: MOSurrogateConfig, eval_fn: Callable,
                      device="cuda"):
    """One vector-objective evaluation as a PyTask (the fingerprint
    discipline of the scalar ``make_eval_task``): the job seeds its own
    generator from (seed, round, slot) on ``device``, inside the job.
    ``eval_fn(generator, genomes (1, d)) -> (1, M)``."""
    from repro_torch.core.prototype import Val
    from repro_torch.core.task import PyTask
    dev = resolve_device(device)

    def fn(ctx):
        r, s = int(ctx["round"]), int(ctx["slot"])
        x = torch.tensor([list(ctx["x"])], dtype=torch.float32, device=dev)
        gen = make_generator(sur.derive_seed(cfg.seed, r, s), dev)
        out = eval_fn(gen, x)[0].to(torch.float32).cpu().numpy()
        return {"y": tuple(float(v) for v in out)}

    return PyTask("mo_propose_eval", fn,
                  inputs=(Val("round", int), Val("slot", int), Val("x")),
                  outputs=(Val("y"),))


def run_surrogate_mo(cfg: MOSurrogateConfig, eval_fn: Callable, *,
                     rounds: int, environment=None,
                     checkpoint_dir: str = None,
                     stop_after_rounds: Optional[int] = None, record=None,
                     progress: Callable[[int, int], None] = None,
                     device="cuda", settings: Optional[str] = None
                     ) -> MOSurrogateResult:
    """Drive the qEHVI ask/tell loop on ``device``: per round, ``ask()``
    fixes the batch, evaluations stream through the environment (or run
    inline, ``environment=None``) up to its capacity at a time in qEHVI-gain
    order, and the barrier ``tell`` feeds the archive. With
    ``checkpoint_dir`` the history commits every round and the run resumes
    from the newest commit; ``settings`` (a JSON string) is stored with each
    commit, and a resume from a commit of other settings raises. Per-slot
    TaskRecords carry mode "surrogate-mo". ``eval_fn(generator, genomes (n,
    d)) -> (n, M)`` raw objectives (all minimized)."""
    from repro_torch import checkpoint
    from repro_torch.core.cache import inputs_digest
    from repro_torch.core.prototype import Context
    from repro_torch.core.scheduler import TaskRecord

    t0 = time.monotonic()
    dev = resolve_device(device)
    task = make_eval_task_mo(cfg, eval_fn, dev)
    explorer = MOSurrogateExplorer(cfg, dev)
    q, d, m = cfg.q, cfg.dim, cfg.n_objectives

    resumed = 0
    if checkpoint_dir is not None:
        last = checkpoint.latest_step(checkpoint_dir)
        if last:
            like = {"x01": np.zeros((last * q, d), np.float32),
                    "y": np.zeros((last * q, m), np.float32),
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
                            environment="checkpoint", inputs_digest="",
                            started_s=0.0, wall_s=0.0, retries=0,
                            cache_hit=True, mode="cache"))

    attempts = 0
    n_rounds = max(rounds, resumed)
    stop_at = n_rounds if stop_after_rounds is None \
        else min(n_rounds, stop_after_rounds)
    env_name = environment.name if environment is not None else "inline"

    def note(r, s, ctx, meta):
        nonlocal attempts
        attempts += len(meta.get("attempts") or ()) or 1
        if record is not None:
            record.tasks.append(TaskRecord(
                task=task.name, capsule=r * q + s, environment=env_name,
                inputs_digest=inputs_digest(task, ctx),
                started_s=meta.get("t0", t0) - t0,
                wall_s=meta.get("wall_s", 0.0),
                retries=meta.get("retries", 0), cache_hit=False,
                mode="surrogate-mo",
                attempts=list(meta.get("attempts") or ()) or None))

    for r in range(explorer.round, stop_at):
        xq = explorer.ask()
        ctxs = [Context({"round": r, "slot": s,
                         "x": tuple(float(v) for v in xq[s])})
                for s in range(q)]
        ys: List[Optional[tuple]] = [None] * q
        if environment is None:
            for s in range(q):
                a_t0 = time.monotonic()
                out = task.run(ctxs[s])
                ys[s] = out["y"]
                note(r, s, ctxs[s], {"t0": a_t0, "retries": 0,
                                     "wall_s": time.monotonic() - a_t0})
        else:
            import concurrent.futures as cf
            cap = max(2, getattr(environment, "total_capacity", 2))
            queue = list(range(q))            # qEHVI-gain order
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
        explorer.tell(xq, np.asarray(ys, np.float32))
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
        return MOSurrogateResult(
            genomes=None, objectives=None, front_genomes=None,
            front_objectives=None, hv=None, rounds_done=explorer.round,
            rounds_total=n_rounds, resumed_rounds=resumed,
            interrupted=True, attempts=attempts, wall_s=wall)
    fg, fo = explorer.front()
    if cfg.ref_point is not None:
        ref = cfg.ref_point
    else:
        # observed nadir + 10% span; the floor keeps the box non-degenerate
        # when an objective saturates (constant across the whole history)
        nadir = explorer.y.max(axis=0)
        span = np.maximum(np.ptp(explorer.y, axis=0),
                          1e-3 * np.maximum(np.abs(nadir), 1.0))
        ref = tuple(float(v) for v in nadir + 0.1 * span)
    hv = hv_estimate(fo, ref, seed=cfg.seed, device=dev) if len(fo) else 0.0
    return MOSurrogateResult(
        genomes=explorer._lo + explorer.x01 * explorer._span,
        objectives=explorer.y.copy(), front_genomes=fg,
        front_objectives=fo, hv=hv, rounds_done=explorer.round,
        rounds_total=n_rounds, resumed_rounds=resumed, interrupted=False,
        attempts=attempts, wall_s=wall)
