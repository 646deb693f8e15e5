"""Bandit-allocated serving driver: live traffic as the experiment
(``repro.launch.bandit_serve``).

Routes a stream of synthetic generation requests across competing arm
configurations (decode temperature variants and int8-round-tripped weights
of one ``--arch``) with the epsilon-greedy / UCB router, optionally
executing every request through the fault-tolerant
:class:`ExplorationService`, and periodically feeding aggregated arm
rewards through the GP surrogate (``tell`` from traffic, ``ask`` to spawn
the next arm, cull the worst by posterior mean).

    PYTHONPATH=src python -m repro_torch.launch.bandit_serve \\
        --arch smollm-135m --reduced --requests 24 --policy ucb \\
        --surrogate-every 8 --out /tmp/bandit

    # through the journaled service + chaos pool (35% injected failures):
    PYTHONPATH=src python -m repro_torch.launch.bandit_serve \\
        --arch smollm-135m --reduced --requests 24 --fault-rate 0.35 \\
        --lat-weight 0 --out /tmp/bandit_chaos

Runs on the card unless ``--device cpu`` is given. Writes
``bandit_result.json`` (per-arm statistics, the regret-against-oracle
summary, warm throughput), ``bandit_provenance.json`` under
``--fault-rate``, and, with ``--journal``, the replayable reward journal.
The weights come from a ``torch.Generator`` seeded 0 on the device; the
prompts from numpy, as in the reference. The arms run ``_sdpa``
(``use_flash_kernel=False``), as the reference's do; the surrogate's fit
runs the ``gp_sqdist`` kernel on the card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time

import numpy as np

from repro_torch.configs import get_config
from repro_torch.explore.surrogate import derive_seed
from repro_torch.models import build
from repro_torch.runtime.device import make_generator, resolve_device
from repro_torch.serve.bandit import (ARM_BOUNDS, BanditConfig,
                                      BanditRouter, make_model_arm,
                                      token_diversity)


def make_arm_set(arch: str, *, reduced: bool = True, new_tokens: int = 16,
                 dtype: str = "float32", device="cuda"):
    """One shared (model, params) pair and the three seed arms: greedy,
    temperature 0.8, greedy on int8-round-tripped weights; plus the
    genome -> arm spawner of the surrogate loop (it shares the weights, so
    spawning is cheap). Returns (cfg, arms, spawn_fn)."""
    dev = resolve_device(device)
    cfg = dataclasses.replace(get_config(arch, reduced=reduced), dtype=dtype,
                              use_flash_kernel=False)
    model = build(cfg, dev)
    params, _ = model.init(make_generator(0, dev))
    mk = lambda **kw: make_model_arm(  # noqa: E731
        model, params, max_new_tokens=new_tokens, seed_tag=arch, **kw)
    arms = [mk(temperature=0.0), mk(temperature=0.8),
            mk(temperature=0.0, quantize=True)]

    def spawn_fn(genome):
        return mk(temperature=float(np.clip(genome[0], *ARM_BOUNDS[0])),
                  quantize=bool(genome[1] > 0.5))

    return cfg, arms, spawn_fn


def run_bandit(*, arch: str = "smollm-135m", reduced: bool = True,
               requests: int = 24, batch: int = 2, prompt_len: int = 8,
               new_tokens: int = 12, policy: str = "ucb",
               epsilon: float = 0.1, ucb_c: float = 2.0,
               lat_weight: float = 1.0, seed: int = 0,
               fault_rate: float = 0.0, surrogate_every: int = 0,
               journal: str = None, out_dir: str = None,
               printer=print, device="cuda") -> dict:
    from repro_torch.core import ExplorationService
    from repro_torch.explore import SurrogateConfig, SurrogateExplorer
    from repro_torch.launch.explore import make_init_pool

    dev = resolve_device(device)
    out_dir = out_dir or os.path.join(tempfile.gettempdir(), "bandit")
    os.makedirs(out_dir, exist_ok=True)
    cfg, arms, spawn_fn = make_arm_set(arch, reduced=reduced,
                                       new_tokens=new_tokens, device=dev)
    bc = BanditConfig(policy=policy, epsilon=epsilon, ucb_c=ucb_c,
                      lat_weight=lat_weight, seed=seed)

    service = pool = None
    if fault_rate > 0.0:
        pool = make_init_pool(fault_rate, backoff_s=0.01, retries=12,
                              device=dev)
        service = ExplorationService(
            pool, journal=os.path.join(out_dir, "queue.jsonl"),
            name="bandit-serve")

    router = BanditRouter(arms, bc, quality_fn=token_diversity,
                          journal=journal, spawn_fn=spawn_fn,
                          service=service, experiment_id="bandit")
    explorer = None
    if surrogate_every > 0:
        explorer = SurrogateExplorer(SurrogateConfig(
            bounds=ARM_BOUNDS, q=1, n_init=2, seed=seed,
            lengthscales=(0.2,), n_starts=6, opt_steps=12, mc_samples=32),
            device=dev)

    def prompts_at(req: int) -> np.ndarray:
        rng = np.random.default_rng((seed << 20) + req)
        return rng.integers(0, cfg.vocab_size,
                            (batch, prompt_len)).astype(np.int32)

    # warm every seed arm outside the timed loop (the first calls pay the
    # allocator's growth; the routing reward must be the steady state)
    for a in list(router.arms):
        a.generate_fn(prompts_at(0), derive_seed(seed))

    t0 = time.perf_counter()
    done = router.n_requests        # a replayed journal resumes mid-stream
    while done < requests:
        res = router.route(prompts_at(done))
        done = router.n_requests
        if explorer is not None and done % surrogate_every == 0:
            spawned = router.sync_surrogate(explorer)
            if spawned is not None:
                spawned.generate_fn(prompts_at(done), derive_seed(seed))
        if done % max(1, requests // 8) == 0:
            printer(f"[bandit] {done}/{requests} -> {res.arm} "
                    f"reward {res.reward:.3f}")
    wall = time.perf_counter() - t0

    regret = router.regret_curve()
    h = len(regret) // 2
    result = {
        "arch": arch, "policy": policy, "requests": router.n_requests,
        "requests_per_s": router.n_requests / max(wall, 1e-9),
        "wall_s": wall,
        "arms": router.arm_stats(),
        "oracle_arm": router.oracle_arm(),
        "regret": {
            "cumulative": float(regret[-1]) if len(regret) else 0.0,
            "per_request_first_half": float(regret[h - 1] / h) if h else 0.0,
            "per_request_second_half":
                float((regret[-1] - regret[h - 1]) / (len(regret) - h))
                if h else 0.0,
        },
    }
    if service is not None:
        rec = service.record("bandit")
        rec.save(os.path.join(out_dir, "bandit_provenance.json"))
        result["pool_stats"] = pool.stats.snapshot()
        service.shutdown()
        pool.shutdown()
    router.close()
    with open(os.path.join(out_dir, "bandit_result.json"), "w") as f:
        json.dump(result, f, indent=2)
    printer(f"[bandit] {router.n_requests} requests in {wall:.2f}s "
            f"({result['requests_per_s']:.1f} req/s), oracle arm "
            f"{result['oracle_arm']}, cumulative regret "
            f"{result['regret']['cumulative']:.3f}")
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=12)
    ap.add_argument("--policy", choices=("ucb", "epsilon"), default="ucb")
    ap.add_argument("--epsilon", type=float, default=0.1)
    ap.add_argument("--ucb-c", type=float, default=2.0)
    ap.add_argument("--lat-weight", type=float, default=1.0,
                    help="weight of -latency/token in the reward (0 makes "
                         "the trajectory bit-reproducible)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fault-rate", type=float, default=0.0,
                    help=">0 routes every request through the journaled "
                         "ExplorationService on a chaos-injected pool")
    ap.add_argument("--surrogate-every", type=int, default=0,
                    help="every N requests: tell arm rewards to the GP, "
                         "spawn the proposed arm, cull the worst (0=off)")
    ap.add_argument("--journal", default=None,
                    help="reward journal path (replayed if it exists)")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "bandit"),
                    help="output directory (default: bandit under the "
                         "temporary directory)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    run_bandit(arch=args.arch, reduced=args.reduced, requests=args.requests,
               batch=args.batch, prompt_len=args.prompt_len,
               new_tokens=args.new_tokens, policy=args.policy,
               epsilon=args.epsilon, ucb_c=args.ucb_c,
               lat_weight=args.lat_weight, seed=args.seed,
               fault_rate=args.fault_rate,
               surrogate_every=args.surrogate_every, journal=args.journal,
               out_dir=args.out, device=args.device)


if __name__ == "__main__":
    main()
