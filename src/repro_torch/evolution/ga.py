"""Steady-state NSGA-II over a written-out island axis, ported from
``repro.evolution.ga``.

``eval_fn(generator, genomes (L, D)) -> objectives (L, M)`` is the fitness
task — e.g. ``explore.replication.replicated_batch`` over the ants
simulator. Where the reference vmaps one population's step over islands,
the port's state carries the island axis itself: one step ranks every
island in one grouped ``dominance_pass`` launch and evaluates every
island's children in one ``eval_fn`` call (8 islands x lam 16 x 5
replicates = 640 simulator lanes at the reference's defaults).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.evolution import nsga2
from repro_torch.evolution.nsga2 import NSGA2Config
from repro_torch.runtime.device import resolve_device


class GAState(NamedTuple):
    genomes: torch.Tensor      # (I, mu, D) f32
    objectives: torch.Tensor   # (I, mu, M) f32
    valid: torch.Tensor        # (I, mu) bool
    generation: torch.Tensor   # (I,) i32
    evaluations: torch.Tensor  # (I,) i32


def init_state(cfg: NSGA2Config, generator: torch.Generator, *,
               n_islands: int = 1, device="cuda") -> GAState:
    """Uniform random unevaluated populations within the bounds, on
    ``device`` (the card unless the caller asks for the CPU)."""
    device = resolve_device(device)
    lo, hi = cfg.lo(device), cfg.hi(device)
    genomes = torch.rand((n_islands, cfg.mu, cfg.genome_dim),
                         generator=generator, device=device) * (hi - lo) + lo
    zeros = torch.zeros((n_islands,), dtype=torch.int32, device=device)
    return GAState(
        genomes=genomes,
        objectives=torch.full((n_islands, cfg.mu, cfg.n_objectives),
                              nsga2.BIG, dtype=torch.float32, device=device),
        valid=torch.zeros((n_islands, cfg.mu), dtype=torch.bool,
                          device=device),
        generation=zeros,
        evaluations=zeros.clone(),
    )


def evaluate_initial(cfg: NSGA2Config, state: GAState, eval_fn: Callable,
                     generator: torch.Generator, islands=None) -> GAState:
    """Evaluate the whole population of each island in ``islands`` (a (I,)
    bool mask; default all) in one ``eval_fn`` call."""
    n_i, mu, d = state.genomes.shape
    if islands is None:
        islands = torch.ones((n_i,), dtype=torch.bool,
                             device=state.genomes.device)
    idx = islands.nonzero()[:, 0]
    obj = eval_fn(generator, state.genomes[idx].reshape(-1, d))
    objectives = state.objectives.clone()
    objectives[idx] = obj.reshape(len(idx), mu, -1).to(torch.float32)
    valid = state.valid.clone()
    valid[idx] = True
    return state._replace(objectives=objectives, valid=valid,
                          evaluations=state.evaluations
                          + mu * islands.to(torch.int32))


def make_step(cfg: NSGA2Config, eval_fn: Callable, lam: int) -> Callable:
    """step(state, generator) -> state: one (mu + lambda) NSGA-II
    generation on every island."""

    def step(state: GAState, generator: torch.Generator) -> GAState:
        n_i, mu, d = state.genomes.shape
        m = state.objectives.shape[-1]
        flat_o = state.objectives.reshape(n_i * mu, m)
        groups = nsga2.island_groups(n_i, mu, flat_o.device)
        ranks = nsga2.nondominated_ranks(flat_o, state.valid.reshape(-1),
                                         groups=groups)
        crowd = nsga2.crowding_distance(flat_o, ranks, groups=groups,
                                        n_groups=n_i)
        children, _ = nsga2.make_offspring(
            cfg, generator, state.genomes, ranks.reshape(n_i, mu),
            crowd.reshape(n_i, mu), lam)
        child_obj = eval_fn(generator, children.reshape(n_i * lam, d))
        pool_g = torch.cat([state.genomes, children], dim=1)
        pool_o = torch.cat([state.objectives,
                            child_obj.reshape(n_i, lam, m)], dim=1)
        pool_v = torch.cat([state.valid,
                            torch.ones((n_i, lam), dtype=torch.bool,
                                       device=flat_o.device)], dim=1)
        idx, _, _ = nsga2.select_mu(cfg, pool_g, pool_o, pool_v)
        return GAState(
            genomes=nsga2.take_rows(pool_g, idx),
            objectives=nsga2.take_rows(pool_o, idx),
            valid=nsga2.take_rows(pool_v, idx),
            generation=state.generation + 1,
            evaluations=state.evaluations + lam,
        )

    return step
