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

With a ``mesh`` of several ranks (``launch.mesh``), each rank holds a
contiguous block of islands when the island count divides by the ranks
(else every rank holds all of them, the reference's replicate fallback);
the archive and the scalars are replicated. An epoch then evolves the
rank's block, ``all_gather``s every island's emigrants in island order,
merges them into the archive on every rank through the row-sharded
dominance sweep, and reseeds the block. Every rank keeps the run's
generator, seeded alike, and draws each random tensor at the one-rank
run's full island shape, keeping its block's rows: the run is the one-rank
run bit for bit, whatever the mesh.

The state keeps no random keys: one ``torch.Generator`` drives every draw.
The checkpoint callback therefore gets the generator's state of the
boundary beside the snapshot, ``checkpoint_fn(snapshot, rng_state)``, and a
run restarted from that snapshot with the generator set to ``rng_state``
continues bit for bit under either schedule.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.evolution import ga, nsga2
from repro_torch.evolution.archive import Archive, init_archive, merge
from repro_torch.evolution.nsga2 import NSGA2Config
from repro_torch.runtime.device import resolve_device
from repro_torch.runtime.sharding import all_gather_rows, mesh_group


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
# Islands over the ranks of a mesh
# ---------------------------------------------------------------------------
class Shard(NamedTuple):
    """This rank's part of an island run: ``islands`` (a ``ga.Rows``) are
    the islands it holds; ``mesh`` the run's mesh (the archive merge
    shards over its ranks); ``group`` the process group whose ranks hold
    the other blocks, None when this rank holds every island."""
    islands: ga.Rows
    mesh: Any
    group: Any


def island_shard(mesh, n_islands: int) -> Shard:
    """A contiguous block of islands per rank when ``n_islands`` divides by
    the mesh's ranks, else every island on every rank."""
    group, ranks, rank = mesh_group(mesh)
    if ranks > 1 and n_islands % ranks == 0:
        b = n_islands // ranks
        return Shard(ga.Rows(rank * b, (rank + 1) * b, n_islands), mesh,
                     group)
    return Shard(ga.Rows(0, n_islands, n_islands), mesh, None)


def place_island_state(state: IslandState, mesh=None) -> IslandState:
    """``state`` (every island) as this rank holds it on ``mesh``: its block
    of islands (``island_shard``), the archive and scalars replicated, all
    on the mesh's device. The state itself without a mesh."""
    if mesh is None:
        return state
    shard = island_shard(mesh, state.islands.genomes.shape[0])
    dev = getattr(mesh, "device", None)

    def to(t):
        return t if dev is None else t.to(dev)

    return IslandState(
        islands=ga.GAState(*(to(shard.islands.take(t))
                             for t in state.islands)),
        archive=Archive(*(to(t) for t in state.archive)),
        epoch=state.epoch, total_evaluations=state.total_evaluations)


def gather_islands(islands: ga.GAState, shard: Shard = None) -> ga.GAState:
    """Every island, from every rank's block (collective over the blocks'
    group); ``islands`` itself when this rank holds them all."""
    if shard is None or shard.group is None:
        return islands
    return ga.GAState(*(all_gather_rows(t, shard.group) for t in islands))


# ---------------------------------------------------------------------------
# Epoch stages
# ---------------------------------------------------------------------------
def make_evolve(cfg: NSGA2Config, eval_fn: Callable, *, lam: int,
                steps_per_epoch: int) -> Callable:
    """evolve(islands, generator, shard=None) -> islands after K NSGA-II
    steps on every island (the evaluation-heavy stage; no cross-island
    communication but the fresh-island mask). Islands that arrive
    unevaluated (the first epoch) are evaluated first. With a ``shard``
    that holds a block, ``islands`` are the block and every draw is made
    for all islands (``ga.Rows``); ``eval_fn`` must then take ``rows=``."""
    step = ga.make_step(cfg, eval_fn, lam)

    def evolve(islands: ga.GAState, generator,
               shard: Shard = None) -> ga.GAState:
        fresh = ~islands.valid.any(dim=1)
        block = rows = None
        if shard is not None and shard.group is not None:
            block = shard.islands
            every = all_gather_rows(fresh, shard.group)
            before = int(every[:block.start].sum())
            rows = ga.Rows(before, before + int(fresh.sum()),
                           int(every.sum())).times(islands.genomes.shape[1])
            any_fresh = rows.total > 0
        else:
            any_fresh = bool(fresh.any())
        if any_fresh:
            islands = ga.evaluate_initial(cfg, islands, eval_fn, generator,
                                          islands=fresh, rows=rows)
        for _ in range(steps_per_epoch):
            islands = step(islands, generator, block)
        return islands

    return evolve


def make_merge(cfg: NSGA2Config, *, merge_top_k: int = 0) -> Callable:
    """(archive, islands, shard=None) -> archive — the selection-heavy stage
    and the only cross-island communication.

    merge_top_k > 0: each island contributes only its best k individuals
    (by rank, then crowding) instead of its whole population; the ranking
    of all islands' populations runs as ONE grouped dominance launch.
    With a ``shard``, the block's emigrants are ``all_gather``ed in island
    order and every rank merges them into its replica of the archive
    through the sweep sharded over the mesh's ranks."""

    def merge_islands(archive: Archive, islands: ga.GAState,
                      shard: Shard = None) -> Archive:
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
        if shard is None:
            return merge(archive, flat_g, flat_o, flat_v)
        if shard.group is not None:
            flat_g, flat_o, flat_v = (all_gather_rows(t, shard.group)
                                      for t in (flat_g, flat_o, flat_v))
        return merge(archive, flat_g, flat_o, flat_v, mesh=shard.mesh)

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
    """(islands, archive, generator, shard=None) -> islands with a fraction
    of each population replaced by archive samples (the paper: "each
    island gets 50 individuals sampled from the global population"). With
    a ``shard`` the picks are drawn for every island and the block's
    kept."""

    def reseed_islands(islands: ga.GAState, archive: Archive,
                       generator, shard: Shard = None) -> ga.GAState:
        n_i, mu = islands.genomes.shape[:2]
        whole = shard.islands.total if shard is not None else n_i
        n_replace = max(int(mu * reseed_frac), 1)
        pick = torch.randint(0, archive.genomes.shape[0],
                             (whole, n_replace), generator=generator,
                             device=islands.genomes.device)
        if shard is not None:
            pick = shard.islands.take(pick)
        return reseed_apply(islands, archive, pick)

    return reseed_islands


def make_epoch(cfg: NSGA2Config, eval_fn: Callable, *, lam: int,
               steps_per_epoch: int, reseed_frac: float = 0.5,
               merge_top_k: int = 0) -> Callable:
    """epoch(state, generator, shard=None) -> state: evolve -> merge ->
    reseed (with a ``shard``: of this rank's part of the run)."""
    evolve = make_evolve(cfg, eval_fn, lam=lam,
                         steps_per_epoch=steps_per_epoch)
    merge_islands = make_merge(cfg, merge_top_k=merge_top_k)
    reseed_islands = make_reseed(cfg, reseed_frac=reseed_frac)

    def epoch(state: IslandState, generator,
              shard: Shard = None) -> IslandState:
        islands = evolve(state.islands, generator, shard)
        n_i = (shard.islands.total if shard is not None
               else islands.genomes.shape[0])
        archive = merge_islands(state.archive, islands, shard)
        islands = reseed_islands(islands, archive, generator, shard)
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
                start_state: IslandState = None, device="cuda",
                mesh=None) -> IslandState:
    """Host loop over epochs up to ``epochs``. ``start_state`` (every
    island) resumes (the caller restores the generator). A fresh state is
    made on ``device``: the card unless the caller asks for the CPU.

    pipeline=False: supersteps of ``epochs_per_superstep`` epochs; 0 picks
    the natural grain, every remaining epoch without a ``checkpoint_fn``,
    else 1. The snapshot of boundary s goes to ``checkpoint_fn`` after
    superstep s+1 has run.
    pipeline=True: the double-buffered schedule (module docstring); the
    archive trails the synchronous schedule's by one epoch.

    ``checkpoint_fn(snapshot, rng_state)``: ``snapshot`` is a CPU copy
    (``host_snapshot``) of the state at a boundary, ``rng_state`` the
    generator's state there (``generator.get_state()``).

    ``mesh`` (a ``runtime.sharding.Mesh``; ``launch.mesh``): every rank of
    it calls ``run_islands`` alike, on the mesh's device, and holds its
    share of the islands (``place_island_state``). At a checkpoint every
    rank gathers the blocks, rank 0 alone calls ``checkpoint_fn``, then all
    ranks meet at a barrier. Every rank returns the whole final state, the
    one-rank run's bit for bit."""
    if mesh is not None and getattr(mesh, "device", None) is not None:
        device = mesh.device
    device = resolve_device(device)
    state = start_state if start_state is not None else init_island_state(
        cfg, generator, n_islands=n_islands, archive_size=archive_size,
        device=device)
    e0 = state.epoch
    if e0 >= epochs:
        return state
    n_i = state.islands.genomes.shape[0]     # honour start_state's count
    shard = None
    group, _, rank = mesh_group(mesh)
    if mesh is not None:
        shard = island_shard(mesh, n_i)
        state = place_island_state(state, mesh)

    def snapshot(st: IslandState) -> IslandState:
        return host_snapshot(st._replace(
            islands=gather_islands(st.islands, shard)))

    def flush(pending) -> None:
        if rank == 0:
            checkpoint_fn(*pending)
        if group is not None:
            dist.barrier(group=group)

    if not pipeline:
        epoch = make_epoch(cfg, eval_fn, lam=lam,
                           steps_per_epoch=steps_per_epoch,
                           reseed_frac=reseed_frac, merge_top_k=merge_top_k)
        grain = epochs_per_superstep or (
            1 if checkpoint_fn is not None else epochs - e0)
        pending = None
        for s in range(e0, epochs, grain):
            for _ in range(min(grain, epochs - s)):
                state = epoch(state, generator, shard)
            if checkpoint_fn is not None:
                if pending is not None:
                    flush(pending)
                pending = (snapshot(state), generator.get_state())
        if pending is not None:
            flush(pending)
        return state._replace(islands=gather_islands(state.islands, shard))

    evolve = make_evolve(cfg, eval_fn, lam=lam,
                         steps_per_epoch=steps_per_epoch)
    merge_islands = make_merge(cfg, merge_top_k=merge_top_k)
    reseed_islands = make_reseed(cfg, reseed_frac=reseed_frac)
    per_epoch = n_i * steps_per_epoch * lam
    archive = state.archive
    total = state.total_evaluations
    evolved = evolve(state.islands, generator, shard)
    for e in range(e0, epochs):
        total += per_epoch + (e == 0) * n_i * cfg.mu
        new_archive = merge_islands(archive, evolved, shard)  # selection, e
        last = e + 1 == epochs
        # reseed from the stale archive: evolve(e+1) does not wait for
        # merge(e)
        seeded = evolved if last else reseed_islands(evolved, archive,
                                                     generator, shard)
        rng = generator.get_state()   # a resume evolves `seeded` from here
        next_evolved = None if last else evolve(seeded, generator, shard)
        archive = new_archive
        state = IslandState(seeded, archive, e + 1, total)
        if checkpoint_fn is not None:
            flush((snapshot(state), rng))
        evolved = next_evolved
    return state._replace(islands=gather_islands(state.islands, shard))
