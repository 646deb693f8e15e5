"""Replication (paper §4.4): run a stochastic model several times with
independent random draws and aggregate with a simple statistical descriptor.
Ported from ``repro.explore.replication``.

Three forms:
- ``Replicate(capsule, seed_sampling, statistic_capsule)`` — the workflow
  construct (exploration + aggregation transitions), Listing 3 one-to-one.
- ``replicated(eval_fn, n)`` — a per-genome ``eval_fn`` run ``n`` times a
  genome, reduced per genome.
- ``replicated_batch(batch_eval_fn, n)`` — the fused device-side form used
  inside GA fitness: replicates become extra lanes of one natively batched
  call, reduced per genome after it.

The reference gives each replicate a key of its own; here every draw comes
from the caller's ``torch.Generator``, in genome-major, replicate-minor
order.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.dsl import Puzzle, aggregate, explore
from repro_torch.core.task import PyTask
from repro_torch.core.workflow import Capsule
from repro_torch.runtime.device import resolve_device


def median(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Median along ``dim`` that averages the middle pair for an even count,
    as ``jnp.median`` does: ``(lo + hi) * 0.5``. (``torch.median`` returns
    the lower of the pair.)"""
    s = x.sort(dim=dim).values
    k = x.shape[dim]
    lo = s.select(dim, (k - 1) // 2)
    hi = s.select(dim, k // 2)
    return (lo + hi) * 0.5


def replicated_batch(batch_eval_fn: Callable, n_replicates: int,
                     reducer: Callable = median) -> Callable:
    """Lift a natively batched ``batch_eval_fn(generator, genomes (L, D)) ->
    (L, M)`` to ``(generator, genomes (N, D)) -> (N, M)`` where each genome
    runs ``n_replicates`` times as adjacent lanes of one flat call, reduced
    with ``reducer(objs, dim=1)``. The high-throughput path for the ants
    simulator.

    ``rows`` (a ``ga.Rows``): the genomes are those rows of a larger batch
    whose draws the generator makes; ``batch_eval_fn`` then gets the same
    rows of the flat lanes, ``rows.times(n_replicates)``, as ``rows=``."""

    def replicated_eval(generator, genomes, rows=None):
        n = genomes.shape[0]
        flat_genomes = genomes.repeat_interleave(n_replicates, dim=0)
        if rows is None:
            objs = batch_eval_fn(generator, flat_genomes)
        else:
            objs = batch_eval_fn(generator, flat_genomes,
                                 rows=rows.times(n_replicates))
        return reducer(objs.reshape(n, n_replicates, -1), dim=1)

    return replicated_eval


def Replicate(model_capsule, seed_sampling, statistic_capsule):
    """model runs once per seed; outputs aggregate into the statistic task.
    Returns the Puzzle ``head >> explore(seeds) >> model >> aggregate() >>
    statistic``."""
    p = Puzzle.from_capsule(_identity_head(model_capsule))
    return (p >> explore(seed_sampling) >> model_capsule
            >> aggregate() >> statistic_capsule)


def _identity_head(model_capsule):
    return Capsule(PyTask(f"{model_capsule.task.name}_head", lambda ctx: {}))


def replicated(eval_fn: Callable, n_replicates: int,
               reducer: Callable = median, device="cuda") -> Callable:
    """Lift ``eval_fn(generator, genome (D,)) -> (M,)`` to ``(generator,
    genomes (N, D)) -> (N, M)`` on ``device`` (the card unless the caller
    asks for the CPU): each genome runs ``n_replicates`` times and the runs
    are reduced with ``reducer(objs, dim=1)``."""
    dev = resolve_device(device)

    def replicated_eval(generator, genomes):
        genomes = genomes.to(dev)
        objs = torch.stack([
            torch.stack([eval_fn(generator, g) for _ in range(n_replicates)])
            for g in genomes])
        return reducer(objs, dim=1)

    return replicated_eval
