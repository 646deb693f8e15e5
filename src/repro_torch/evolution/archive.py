"""Global Pareto archive — the island model's merge target (paper §4.6:
"When an island is finished, its final population is merged back into a
global archive"), ported from ``repro.evolution.archive``."""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.evolution import nsga2
from repro_torch.runtime.sharding import sharded_dominance_pass


class Archive(NamedTuple):
    genomes: torch.Tensor      # (A, D) f32
    objectives: torch.Tensor   # (A, M) f32
    valid: torch.Tensor        # (A,) bool


def init_archive(size, genome_dim, n_objectives, device=None) -> Archive:
    return Archive(
        genomes=torch.zeros((size, genome_dim), dtype=torch.float32,
                            device=device),
        objectives=torch.full((size, n_objectives), nsga2.BIG,
                              dtype=torch.float32, device=device),
        valid=torch.zeros((size,), dtype=torch.bool, device=device),
    )


def merge(archive: Archive, genomes, objectives, valid=None, *,
          mesh=None) -> Archive:
    """Truncate (archive + incoming) to archive size by (rank, -crowding).

    The pool-wide non-dominated sort runs through the row-sharded sweep
    over ``mesh``'s ranks (``sharded_dominance_pass``; every rank calls
    ``merge`` with the same replicated pool and gets the same archive), as
    the reference's does. Without a mesh, or with one rank, that is one
    fused dominance sweep."""
    a = archive.genomes.shape[0]
    if valid is None:
        valid = torch.ones((genomes.shape[0],), dtype=torch.bool,
                           device=genomes.device)
    pool_g = torch.cat([archive.genomes, genomes.to(torch.float32)])
    pool_o = torch.cat([archive.objectives, objectives.to(torch.float32)])
    pool_v = torch.cat([archive.valid, valid])
    ranks = nsga2.nondominated_ranks(
        pool_o, pool_v,
        pass_fn=functools.partial(sharded_dominance_pass, mesh=mesh))
    crowd = nsga2.crowding_distance(pool_o, ranks)
    key_val = nsga2.truncation_key(ranks, crowd, pool_v)
    order = torch.argsort(key_val, stable=True)[:a]
    return Archive(pool_g[order], pool_o[order], pool_v[order])


def pareto_front(archive: Archive) -> torch.Tensor:
    """Boolean mask of rank-0 members (host-side readout helper)."""
    ranks = nsga2.nondominated_ranks(archive.objectives, archive.valid)
    return archive.valid & (ranks == 0)
