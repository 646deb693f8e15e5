"""Bandit-allocated serving: route live generation traffic across competing
arm configurations, and close the loop into the surrogate explorer
(``repro.serve.bandit``).

- **Arms** are competing serving configurations: decode temperature and
  token budget (:class:`~repro_torch.serve.engine.ServeConfig`), int8 weight
  quantization (the :mod:`repro_torch.train.compression` round trip), or
  other architectures. Each arm carries a genome (a point in the
  exploration space) so the surrogate can reason about it.
- **BanditRouter** allocates each request with epsilon-greedy or UCB1 over
  per-arm mean reward. Selection is a pure function of (seed, request
  index, arm statistics): the exploration draws come from the sha256
  scheme of :mod:`repro_torch.core.faults`, so a replayed reward journal
  reproduces the routing decisions exactly.
- **Generation randomness** is a draw and an apply: an arm's
  ``generate_fn(prompts, seed)`` seeds a ``torch.Generator`` on its model's
  device with ``seed``, which the router derives as ``derive_seed(seed,
  request)`` where the reference folds the request index into its key. A
  replayed or resubmitted request regenerates the same tokens.
- **Reward** per request is ``quality - lat_weight * latency_per_token``
  (quality default :func:`token_diversity`). ``lat_weight=0`` makes the
  whole trajectory bit-reproducible.
- **Journal**: every pull/spawn/cull appends one JSON line, keys sorted,
  the reference's schema (a journal written by either package replays in
  the other). A restarted router replays it and resumes with the same arm
  statistics and routing; a torn tail line is ignored.
- **Service execution**: with ``service=`` each request becomes a
  ``PyTask`` firing through the port's
  :class:`~repro_torch.core.service.ExplorationService`: journaled queue,
  content-addressed idempotence, the fault-tolerant pool.
- **Surrogate loop** (:meth:`BanditRouter.sync_surrogate`): aggregated arm
  rewards feed ``SurrogateExplorer.tell`` (objective = negative mean
  reward, minimized), ``ask`` proposes the next arm genome to spawn, and
  the worst active arm by GP posterior mean is culled. On the card the
  explorer's fit runs the ``gp_sqdist`` kernel (B4).
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.faults import _unit
from repro_torch.core.prototype import Context, Val
from repro_torch.core.task import PyTask
from repro_torch.explore.surrogate import derive_seed
from repro_torch.models.common import tree_map
from repro_torch.runtime.device import make_generator
from repro_torch.serve.engine import ServeConfig, generate
from repro_torch.train.compression import dequantize_int8, quantize_int8

# (temperature, quantize-flag) box of the default arm genome: the space
# sync_surrogate explores. The flag dim is thresholded at 0.5 when a
# genome becomes an arm; the GP treats it as a (steep) continuous effect.
ARM_BOUNDS = ((0.0, 1.2), (0.0, 1.0))


# ---------------------------------------------------------------------------
# arms
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ArmStats:
    """Running reward statistics of one arm (restored by journal replay)."""
    pulls: int = 0
    reward_sum: float = 0.0
    reward_sq: float = 0.0

    @property
    def mean(self) -> float:
        return self.reward_sum / self.pulls if self.pulls else 0.0

    @property
    def var(self) -> float:
        if self.pulls < 2:
            return 0.0
        m = self.mean
        return max(self.reward_sq / self.pulls - m * m, 0.0)


class Arm:
    """One serving configuration under test.

    Args:
        name: journal/provenance identity (stable across restarts).
        generate_fn: ``(prompts (B, S) int32 numpy, seed int) -> (B, T)
            int32 numpy``; ``seed`` seeds the arm's sampling generator.
        genome: optional point in the exploration space (physical units,
            inside :data:`ARM_BOUNDS`-like bounds); arms without a genome
            are routed but invisible to the surrogate loop.
        meta: free-form description (arch, temperature, quantized, ...).
    """

    def __init__(self, name: str, generate_fn: Callable, *,
                 genome: Optional[np.ndarray] = None,
                 meta: Optional[dict] = None):
        self.name = name
        self.generate_fn = generate_fn
        self.genome = None if genome is None \
            else np.asarray(genome, np.float32)
        self.meta = dict(meta or {})
        self.stats = ArmStats()

    def __repr__(self):
        return (f"Arm({self.name}, pulls={self.stats.pulls}, "
                f"mean={self.stats.mean:.4f})")


@torch.no_grad()
def quantize_params_int8(params):
    """Round-trip every float leaf through the int8 block quantization of
    :mod:`repro_torch.train.compression`: the weight-quality effect of an
    int8 serving arm. The dequantized tensors run the unchanged compute
    path (no int8 kernels), so the arm measures quantization's quality
    cost, not its memory or bandwidth."""
    def leaf(p):
        if not p.is_floating_point():
            return p
        q, s = quantize_int8(p.float())
        return dequantize_int8(q, s, p.shape).to(p.dtype)
    return tree_map(leaf, params)


def make_model_arm(model, params, *, temperature: float = 0.0,
                   max_new_tokens: int = 16, quantize: bool = False,
                   name: Optional[str] = None,
                   seed_tag: str = "arm") -> Arm:
    """An arm over a shared (model, params) pair: one decode-variant
    ``ServeConfig`` (and optionally int8-round-tripped weights) per arm.
    The genome is ``(temperature, quantize)`` in :data:`ARM_BOUNDS`.
    Prompts go to the model's device; tokens come back as numpy int32."""
    p = quantize_params_int8(params) if quantize else params
    sc = ServeConfig(max_new_tokens=max_new_tokens, temperature=temperature)

    def gen(prompts, seed, _m=model, _p=p, _sc=sc):
        dev = _m.device
        toks = torch.as_tensor(np.asarray(prompts, np.int64), device=dev)
        out = generate(_m, _p, toks, _sc,
                       generator=make_generator(int(seed), dev))
        return out.cpu().numpy().astype(np.int32)

    nm = name or (f"{seed_tag}-t{temperature:g}" + ("-int8" if quantize
                                                    else ""))
    return Arm(nm, gen,
               genome=np.asarray([temperature, 1.0 if quantize else 0.0],
                                 np.float32),
               meta={"temperature": temperature, "quantize": quantize,
                     "max_new_tokens": max_new_tokens})


def token_diversity(tokens) -> float:
    """Default quality proxy: mean per-sequence unique-token fraction.
    Greedy decoding degenerates into repetition (on untrained weights,
    immediately); temperature arms score higher: a reference-free scalar
    with a real ordering between decode variants."""
    t = np.asarray(tokens)
    if t.size == 0:
        return 0.0
    rows = t.reshape(t.shape[0], -1)
    return float(np.mean([len(set(r.tolist())) / r.size for r in rows]))


# ---------------------------------------------------------------------------
# router
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class BanditConfig:
    """Allocation policy of the router.

    policy: "ucb" (UCB1 over mean reward) or "epsilon" (epsilon-greedy).
    epsilon: exploration rate of the epsilon policy (0 = pure exploit).
    ucb_c: confidence-width multiplier of the UCB bound.
    lat_weight: weight of the negative per-token latency term in the
        reward (0 makes the reward a pure function of the output tokens).
    min_pulls: warm start: every active arm is pulled this many times
        (round-robin, lowest index first) before the policy engages.
    seed: drives the exploration draws and the generation seeds (per
        request index).
    """
    policy: str = "ucb"
    epsilon: float = 0.1
    ucb_c: float = 2.0
    lat_weight: float = 1.0
    min_pulls: int = 1
    seed: int = 0


class RouteResult(NamedTuple):
    """Outcome of one routed request."""
    arm: str
    tokens: np.ndarray
    reward: float
    quality: float
    latency_s: float
    request: int


class BanditRouter:
    """Allocate generation requests across arms; learn from the rewards.

    Args:
        arms: initial arm list (order is part of the deterministic
            routing: ties and the round-robin warm start break by index).
        cfg: :class:`BanditConfig`.
        quality_fn: ``tokens -> float`` scalar quality proxy (default
            :func:`token_diversity`; None disables the term).
        journal: optional JSONL path. An existing file is replayed first
            (arm statistics, request counter, spawn/cull lifecycle), then
            appended to.
        spawn_fn: ``genome -> Arm`` used to rebuild journal-spawned arms
            on replay and by :meth:`sync_surrogate`.
        service: optional :class:`~repro_torch.core.service.
            ExplorationService`; requests then execute as journaled,
            cache-idempotent, fault-tolerant task firings on its pool.
        experiment_id: tenant id under the service.
    """

    def __init__(self, arms: Sequence[Arm], cfg: BanditConfig = None, *,
                 quality_fn: Optional[Callable] = token_diversity,
                 journal: Optional[str] = None,
                 spawn_fn: Optional[Callable] = None,
                 service=None, experiment_id: str = "bandit"):
        self.arms: List[Arm] = list(arms)
        self.cfg = cfg or BanditConfig()
        self.quality_fn = quality_fn
        self.spawn_fn = spawn_fn
        self.service = service
        self.experiment_id = experiment_id
        self.n_requests = 0
        self.history: List[tuple] = []     # (arm name, reward) per request
        self._culled: set = set()
        self._tasks: Dict[str, object] = {}
        self._journal_f = None
        if journal:
            os.makedirs(os.path.dirname(journal) or ".", exist_ok=True)
            if os.path.exists(journal):
                self._replay(journal)
            self._journal_f = open(journal, "a")

    # ------------------------------------------------------------- journaling
    def _replay(self, path: str) -> None:
        by_name = {a.name: a for a in self.arms}
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue               # torn tail write: ignore
                op = rec.get("op")
                if op == "pull":
                    a = by_name.get(rec.get("arm"))
                    self.n_requests = max(self.n_requests,
                                          int(rec.get("req", -1)) + 1)
                    if a is None:
                        continue           # arm we cannot rebuild: skip
                    r = float(rec["reward"])
                    a.stats.pulls += 1
                    a.stats.reward_sum += r
                    a.stats.reward_sq += r * r
                    self.history.append((a.name, r))
                elif op == "spawn":
                    nm = rec.get("arm")
                    if nm in by_name or self.spawn_fn is None:
                        continue
                    arm = self.spawn_fn(
                        np.asarray(rec.get("genome", ()), np.float32))
                    if arm is not None:
                        arm.name = nm      # stats re-attach by journal name
                        self.arms.append(arm)
                        by_name[nm] = arm
                elif op == "cull":
                    self._culled.add(rec.get("arm"))

    def _log(self, rec: dict) -> None:
        if self._journal_f is not None:
            self._journal_f.write(json.dumps(rec, sort_keys=True) + "\n")
            self._journal_f.flush()

    def close(self) -> None:
        if self._journal_f is not None:
            self._journal_f.close()
            self._journal_f = None

    def __enter__(self) -> "BanditRouter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -------------------------------------------------------------- selection
    def active(self) -> List[int]:
        """Indices of routable arms (not culled), in stable order."""
        return [i for i, a in enumerate(self.arms)
                if a.name not in self._culled]

    def _select(self) -> int:
        """Pure function of (seed, request index, arm stats)."""
        cfg = self.cfg
        active = self.active()
        if not active:
            raise RuntimeError("no active arms")
        cold = [i for i in active if self.arms[i].stats.pulls < cfg.min_pulls]
        if cold:
            return cold[0]
        req = str(self.n_requests)
        if cfg.policy == "epsilon":
            if (cfg.epsilon > 0.0
                    and _unit(cfg.seed, "explore", req, 0) < cfg.epsilon):
                j = int(_unit(cfg.seed, "pick", req, 0) * len(active))
                return active[min(j, len(active) - 1)]
            return max(active,
                       key=lambda i: (self.arms[i].stats.mean, -i))
        if cfg.policy != "ucb":
            raise ValueError(f"unknown policy {cfg.policy!r}")
        t = sum(self.arms[i].stats.pulls for i in active)
        return max(active, key=lambda i: (self.ucb_bound(i, t), -i))

    def ucb_bound(self, i: int, t: Optional[int] = None) -> float:
        """UCB1 index of arm i: mean + c sqrt(ln t / n_i)."""
        st = self.arms[i].stats
        if st.pulls == 0:
            return float("inf")
        if t is None:
            t = sum(self.arms[j].stats.pulls for j in self.active())
        return st.mean + self.cfg.ucb_c * math.sqrt(
            math.log(max(t, 2)) / st.pulls)

    # ---------------------------------------------------------------- routing
    def _task_for(self, arm: Arm):
        task = self._tasks.get(arm.name)
        if task is None:
            gen, seed = arm.generate_fn, self.cfg.seed

            def fn(ctx):
                prompts = np.asarray(ctx["prompts"], np.int32)
                return {"tokens": np.asarray(
                    gen(prompts, derive_seed(seed, int(ctx["req"]))),
                    np.int32)}

            task = PyTask(f"serve_{arm.name}", fn,
                          inputs=(Val("req", int), Val("prompts")),
                          outputs=(Val("tokens"),))
            self._tasks[arm.name] = task
        return task

    def route(self, prompts, *, seed: Optional[int] = None) -> RouteResult:
        """Route ONE request: select an arm, generate, score, record.

        ``prompts``: (B, S) int32. The generation seed defaults to
        ``derive_seed(cfg.seed, request_index)``: pure in the request
        index, so a journal-replayed or service-resubmitted request
        regenerates the same tokens. (On the service path a custom
        ``seed`` is ignored: the task derives it from the request index so
        the firing stays content-addressable.)
        """
        prompts = np.asarray(prompts, np.int32)
        i = self._select()
        arm = self.arms[i]
        req = self.n_requests
        gen_seed = seed if seed is not None \
            else derive_seed(self.cfg.seed, req)
        t0 = time.perf_counter()
        if self.service is not None:
            _tid, out = self.service.submit_and_wait(
                self.experiment_id, self._task_for(arm),
                Context({"req": req, "prompts": prompts}),
                priority=-float(req))   # FIFO across this tenant's requests
            tokens = np.asarray(out["tokens"], np.int32)
        else:
            tokens = np.asarray(arm.generate_fn(prompts, gen_seed), np.int32)
        latency_s = time.perf_counter() - t0
        n_new = int(tokens.size) or 1
        quality = (float(self.quality_fn(tokens))
                   if self.quality_fn is not None else 0.0)
        reward = quality - self.cfg.lat_weight * latency_s / n_new
        st = arm.stats
        st.pulls += 1
        st.reward_sum += reward
        st.reward_sq += reward * reward
        self.n_requests = req + 1
        self.history.append((arm.name, reward))
        self._log({"op": "pull", "req": req, "arm": arm.name,
                   "reward": reward, "quality": quality,
                   "latency_s": latency_s, "tokens": n_new})
        return RouteResult(arm=arm.name, tokens=tokens, reward=reward,
                           quality=quality, latency_s=latency_s, request=req)

    # ------------------------------------------------------------- inspection
    def arm_stats(self) -> Dict[str, dict]:
        """Per-arm summary (the reward-schema view)."""
        return {a.name: {"pulls": a.stats.pulls,
                         "mean_reward": a.stats.mean,
                         "var_reward": a.stats.var,
                         "active": a.name not in self._culled,
                         "genome": (None if a.genome is None
                                    else [float(v) for v in a.genome])}
                for a in self.arms}

    def oracle_arm(self) -> Optional[str]:
        """Best fixed arm in hindsight (highest empirical mean reward)."""
        pulled = [a for a in self.arms if a.stats.pulls > 0]
        if not pulled:
            return None
        return max(pulled, key=lambda a: a.stats.mean).name

    def regret_curve(self) -> np.ndarray:
        """Cumulative regret against the best fixed arm in hindsight: at
        step t, ``sum_{s<=t} (mu_star - reward_s)`` with mu_star the highest
        per-arm empirical mean over the whole horizon."""
        if not self.history:
            return np.zeros(0, np.float64)
        rewards = np.asarray([r for _, r in self.history], np.float64)
        names = np.asarray([n for n, _ in self.history])
        best = max(float(rewards[names == n].mean()) for n in set(names))
        return np.cumsum(best - rewards)

    # --------------------------------------------------------- surrogate loop
    def sync_surrogate(self, explorer, *, spawn: bool = True,
                       cull: bool = True, min_arms: int = 2,
                       min_pulls: int = 1) -> Optional[Arm]:
        """Feed aggregated arm rewards through ``SurrogateExplorer.tell``
        and act on the posterior: ``ask`` proposes the next arm genome
        (spawned via ``spawn_fn``), and the worst active genome-arm by GP
        posterior mean is culled (never below ``min_arms`` active arms,
        never the arm just spawned). Returns the spawned arm, if any.

        The objective handed to the surrogate is the NEGATIVE mean reward
        (the explorer minimizes); only arms with a genome and at least
        ``min_pulls`` observations participate.
        """
        armed = [a for a in self.arms
                 if a.name not in self._culled and a.genome is not None
                 and a.stats.pulls >= min_pulls]
        if len(armed) < 2:
            return None
        x = np.stack([a.genome for a in armed])
        y = np.asarray([-a.stats.mean for a in armed], np.float32)
        explorer.tell(x, y)
        new_arm = None
        if spawn and self.spawn_fn is not None:
            proposal = np.asarray(explorer.ask()[0], np.float32)
            new_arm = self.spawn_fn(proposal)
            if new_arm is not None:
                if any(a.name == new_arm.name for a in self.arms):
                    new_arm.name = f"{new_arm.name}#{self.n_requests}"
                self.arms.append(new_arm)
                self._log({"op": "spawn", "arm": new_arm.name,
                           "genome": [float(v) for v in proposal]})
        if cull:
            candidates = [a for a in armed if a is not new_arm]
            if len(self.active()) > min_arms and len(candidates) >= 2:
                mean, _std = explorer.predict(
                    np.stack([a.genome for a in candidates]))
                worst = candidates[int(np.argmax(mean))]
                self._culled.add(worst.name)
                self._log({"op": "cull", "arm": worst.name})
        return new_arm
