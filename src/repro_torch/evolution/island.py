"""The island model (paper §4.6 / Listing 5), ported from
``repro.evolution.island``: many independently evolving sub-populations,
periodically merged into a global Pareto archive, reseeded from it, and
repeated until the evaluation budget is spent.

Islands are the leading axis of every ``GAState`` tensor. One epoch =

    K steady-state NSGA-II steps on all islands (island-local)
    all-islands merge into the archive
    reseed islands from the archive

``run_islands`` runs either schedule of the reference:

- supersteps: ``epochs_per_superstep`` bulk-synchronous epochs between
  checkpoint boundaries (where the reference scans them into one device
  program, a superstep here is a loop of eager epochs); the snapshot of a
  boundary, an independent CPU copy, goes to the checkpoint callback after
  the next superstep has run;
- pipelined (``pipeline=True``): the reseed that feeds evolve(e+1) reads
  the archive of epoch e-1, so evolve(e+1) does not depend on merge(e).
  Both run on one stream here; the checkpoints hold the already reseeded
  islands, and the final state has every epoch merged.

The state keeps no random keys: one ``torch.Generator`` drives every draw.
The checkpoint callback therefore gets the generator's state of the
boundary beside the snapshot, ``checkpoint_fn(snapshot, rng_state)``, and a
run restarted from that snapshot with the generator set to ``rng_state``
continues bit for bit under either schedule.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.evolution import ga, nsga2
from repro_torch.evolution.archive import Archive, init_archive, merge
from repro_torch.evolution.nsga2 import NSGA2Config
from repro_torch.runtime.device import resolve_device


class IslandState(NamedTuple):
    islands: ga.GAState        # tensors with a leading (n_islands,) dim
    archive: Archive
    epoch: int
    total_evaluations: int


def init_island_state(cfg: NSGA2Config, generator: torch.Generator, *,
                      n_islands: int, archive_size: int,
                      device="cuda") -> IslandState:
    device = resolve_device(device)
    return IslandState(
        islands=ga.init_state(cfg, generator, n_islands=n_islands,
                              device=device),
        archive=init_archive(archive_size, cfg.genome_dim, cfg.n_objectives,
                             device),
        epoch=0,
        total_evaluations=0,
    )


def state_from_arrays(tree, device=None) -> IslandState:
    """An IslandState from the reference package's island state held as
    numpy arrays: ``tree`` has the attributes of ``repro``'s IslandState
    (``islands`` with genomes/objectives/valid/generation/evaluations — its
    PRNG keys are not read —, ``archive`` with genomes/objectives/valid,
    ``epoch``, ``total_evaluations``)."""
    def t(x, dtype):
        return torch.tensor(np.asarray(x), dtype=dtype, device=device)

    isl, arc = tree.islands, tree.archive
    return IslandState(
        islands=ga.GAState(
            genomes=t(isl.genomes, torch.float32),
            objectives=t(isl.objectives, torch.float32),
            valid=t(isl.valid, torch.bool),
            generation=t(isl.generation, torch.int32),
            evaluations=t(isl.evaluations, torch.int32)),
        archive=Archive(genomes=t(arc.genomes, torch.float32),
                        objectives=t(arc.objectives, torch.float32),
                        valid=t(arc.valid, torch.bool)),
        epoch=int(tree.epoch),
        total_evaluations=int(tree.total_evaluations),
    )


# ---------------------------------------------------------------------------
# Epoch stages
# ---------------------------------------------------------------------------
def make_evolve(cfg: NSGA2Config, eval_fn: Callable, *, lam: int,
                steps_per_epoch: int) -> Callable:
    """evolve(islands, generator) -> islands after K NSGA-II steps on every
    island (the evaluation-heavy stage; no cross-island communication).
    Islands that arrive unevaluated (the first epoch) are evaluated first."""
    step = ga.make_step(cfg, eval_fn, lam)

    def evolve(islands: ga.GAState, generator) -> ga.GAState:
        fresh = ~islands.valid.any(dim=1)
        if bool(fresh.any()):
            islands = ga.evaluate_initial(cfg, islands, eval_fn, generator,
                                          islands=fresh)
        for _ in range(steps_per_epoch):
            islands = step(islands, generator)
        return islands

    return evolve


def make_merge(cfg: NSGA2Config, *, merge_top_k: int = 0) -> Callable:
    """(archive, islands) -> archive — the selection-heavy stage and the only
    cross-island communication.

    merge_top_k > 0: each island contributes only its best k individuals
    (by rank, then crowding) instead of its whole population; the ranking
    of all islands' populations runs as ONE grouped dominance launch."""

    def merge_islands(archive: Archive, islands: ga.GAState) -> Archive:
        n_i, mu = islands.genomes.shape[:2]
        if merge_top_k and merge_top_k < mu:
            flat_o = islands.objectives.reshape(n_i * mu, -1)
            flat_v = islands.valid.reshape(n_i * mu)
            groups = nsga2.island_groups(n_i, mu, flat_o.device)
            ranks = nsga2.nondominated_ranks(flat_o, flat_v, groups=groups)
            crowd = nsga2.crowding_distance(flat_o, ranks, groups=groups,
                                            n_groups=n_i)
            key_val = nsga2.truncation_key(ranks, crowd, flat_v)
            idx = torch.argsort(key_val.reshape(n_i, mu), dim=1,
                                stable=True)[:, :merge_top_k]
            flat_g = nsga2.take_rows(islands.genomes, idx).reshape(
                n_i * merge_top_k, -1)
            flat_o = nsga2.take_rows(islands.objectives, idx).reshape(
                n_i * merge_top_k, -1)
            flat_v = nsga2.take_rows(islands.valid, idx).reshape(
                n_i * merge_top_k)
        else:
            flat_g = islands.genomes.reshape(n_i * mu, -1)
            flat_o = islands.objectives.reshape(n_i * mu, -1)
            flat_v = islands.valid.reshape(n_i * mu)
        return merge(archive, flat_g, flat_o, flat_v)

    return merge_islands


def reseed_apply(islands: ga.GAState, archive: Archive,
                 pick: torch.Tensor) -> ga.GAState:
    """Replace the last ``pick.shape[1]`` slots of each island with the
    archive members ``pick`` (I, n_replace) where those are valid."""
    mu = islands.genomes.shape[1]
    slots = mu - 1 - torch.arange(pick.shape[1], device=pick.device)
    ok = archive.valid[pick]                              # (I, n_replace)

    def put(x, src, mask):
        x = x.clone()
        x[:, slots] = torch.where(mask, src, x[:, slots])
        return x

    return islands._replace(
        genomes=put(islands.genomes, archive.genomes[pick], ok[..., None]),
        objectives=put(islands.objectives, archive.objectives[pick],
                       ok[..., None]),
        valid=put(islands.valid, torch.ones_like(ok), ok))


def make_reseed(cfg: NSGA2Config, *, reseed_frac: float = 0.5) -> Callable:
    """(islands, archive, generator) -> islands with a fraction of each
    population replaced by archive samples (the paper: "each island gets 50
    individuals sampled from the global population")."""

    def reseed_islands(islands: ga.GAState, archive: Archive,
                       generator) -> ga.GAState:
        n_i, mu = islands.genomes.shape[:2]
        n_replace = max(int(mu * reseed_frac), 1)
        pick = torch.randint(0, archive.genomes.shape[0], (n_i, n_replace),
                             generator=generator,
                             device=islands.genomes.device)
        return reseed_apply(islands, archive, pick)

    return reseed_islands


def make_epoch(cfg: NSGA2Config, eval_fn: Callable, *, lam: int,
               steps_per_epoch: int, reseed_frac: float = 0.5,
               merge_top_k: int = 0) -> Callable:
    """epoch(state, generator) -> state: evolve -> merge -> reseed."""
    evolve = make_evolve(cfg, eval_fn, lam=lam,
                         steps_per_epoch=steps_per_epoch)
    merge_islands = make_merge(cfg, merge_top_k=merge_top_k)
    reseed_islands = make_reseed(cfg, reseed_frac=reseed_frac)

    def epoch(state: IslandState, generator) -> IslandState:
        islands = evolve(state.islands, generator)
        n_i = islands.genomes.shape[0]
        archive = merge_islands(state.archive, islands)
        islands = reseed_islands(islands, archive, generator)
        evals = state.total_evaluations + n_i * (
            steps_per_epoch * lam + (state.epoch == 0) * cfg.mu)
        return IslandState(islands, archive, state.epoch + 1, evals)

    return epoch


def host_snapshot(state: IslandState) -> IslandState:
    """An independent CPU copy of ``state`` for checkpointing: it shares no
    storage with the live state, which the next epochs go on to replace."""
    def cpu(tree):
        return type(tree)(*(t.detach().to("cpu", copy=True) for t in tree))

    return IslandState(cpu(state.islands), cpu(state.archive), state.epoch,
                       state.total_evaluations)


def run_islands(cfg: NSGA2Config, eval_fn, generator: torch.Generator, *,
                n_islands: int, lam: int, steps_per_epoch: int, epochs: int,
                archive_size: int = 1024, checkpoint_fn=None,
                merge_top_k: int = 0, reseed_frac: float = 0.5,
                pipeline: bool = False, epochs_per_superstep: int = 0,
                start_state: IslandState = None,
                device="cuda") -> IslandState:
    """Host loop over epochs up to ``epochs``. ``start_state`` resumes (the
    caller restores the generator). A fresh state is made on ``device``:
    the card unless the caller asks for the CPU.

    pipeline=False: supersteps of ``epochs_per_superstep`` epochs; 0 picks
    the natural grain, every remaining epoch without a ``checkpoint_fn``,
    else 1. The snapshot of boundary s goes to ``checkpoint_fn`` after
    superstep s+1 has run.
    pipeline=True: the double-buffered schedule (module docstring); the
    archive trails the synchronous schedule's by one epoch.

    ``checkpoint_fn(snapshot, rng_state)``: ``snapshot`` is a CPU copy
    (``host_snapshot``) of the state at a boundary, ``rng_state`` the
    generator's state there (``generator.get_state()``)."""
    device = resolve_device(device)
    state = start_state if start_state is not None else init_island_state(
        cfg, generator, n_islands=n_islands, archive_size=archive_size,
        device=device)
    e0 = state.epoch
    if e0 >= epochs:
        return state

    if not pipeline:
        epoch = make_epoch(cfg, eval_fn, lam=lam,
                           steps_per_epoch=steps_per_epoch,
                           reseed_frac=reseed_frac, merge_top_k=merge_top_k)
        grain = epochs_per_superstep or (
            1 if checkpoint_fn is not None else epochs - e0)
        pending = None
        for s in range(e0, epochs, grain):
            for _ in range(min(grain, epochs - s)):
                state = epoch(state, generator)
            if checkpoint_fn is not None:
                if pending is not None:
                    checkpoint_fn(*pending)
                pending = (host_snapshot(state), generator.get_state())
        if pending is not None:
            checkpoint_fn(*pending)
        return state

    evolve = make_evolve(cfg, eval_fn, lam=lam,
                         steps_per_epoch=steps_per_epoch)
    merge_islands = make_merge(cfg, merge_top_k=merge_top_k)
    reseed_islands = make_reseed(cfg, reseed_frac=reseed_frac)
    n_i = state.islands.genomes.shape[0]     # honour start_state's count
    per_epoch = n_i * steps_per_epoch * lam
    archive = state.archive
    total = state.total_evaluations
    evolved = evolve(state.islands, generator)
    for e in range(e0, epochs):
        total += per_epoch + (e == 0) * n_i * cfg.mu
        new_archive = merge_islands(archive, evolved)     # selection, e
        last = e + 1 == epochs
        # reseed from the stale archive: evolve(e+1) does not wait for
        # merge(e)
        seeded = evolved if last else reseed_islands(evolved, archive,
                                                     generator)
        rng = generator.get_state()   # a resume evolves `seeded` from here
        next_evolved = None if last else evolve(seeded, generator)
        archive = new_archive
        state = IslandState(seeded, archive, e + 1, total)
        if checkpoint_fn is not None:
            checkpoint_fn(host_snapshot(state), rng)
        evolved = next_evolved
    return state
