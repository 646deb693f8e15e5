"""Global Pareto archive — the island model's merge target (paper §4.6:
"When an island is finished, its final population is merged back into a
global archive"), ported from ``repro.evolution.archive``."""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.evolution import nsga2


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


def merge(archive: Archive, genomes, objectives, valid=None) -> Archive:
    """Truncate (archive + incoming) to archive size by (rank, -crowding).

    The pool-wide non-dominated sort is one fused dominance sweep on the
    card (the reference's mesh-sharded sweep falls back to exactly this
    launch on one device)."""
    a = archive.genomes.shape[0]
    if valid is None:
        valid = torch.ones((genomes.shape[0],), dtype=torch.bool,
                           device=genomes.device)
    pool_g = torch.cat([archive.genomes, genomes.to(torch.float32)])
    pool_o = torch.cat([archive.objectives, objectives.to(torch.float32)])
    pool_v = torch.cat([archive.valid, valid])
    ranks = nsga2.nondominated_ranks(pool_o, pool_v)
    crowd = nsga2.crowding_distance(pool_o, ranks)
    key_val = nsga2.truncation_key(ranks, crowd, pool_v)
    order = torch.argsort(key_val, stable=True)[:a]
    return Archive(pool_g[order], pool_o[order], pool_v[order])


def pareto_front(archive: Archive) -> torch.Tensor:
    """Boolean mask of rank-0 members (host-side readout helper)."""
    ranks = nsga2.nondominated_ranks(archive.objectives, archive.valid)
    return archive.valid & (ranks == 0)
