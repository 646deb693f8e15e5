"""Replication (paper §4.4): run a stochastic model several times with
independent random draws and aggregate with a simple statistical descriptor.

``replicated_batch`` is the fused device-side form used inside GA fitness:
replicates become extra lanes of one natively batched call, reduced per
genome after it.
"""
from __future__ import annotations

from typing import Callable

import torch


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
    simulator."""

    def replicated_eval(generator, genomes):
        n = genomes.shape[0]
        flat_genomes = genomes.repeat_interleave(n_replicates, dim=0)
        objs = batch_eval_fn(generator, flat_genomes)
        return reducer(objs.reshape(n, n_replicates, -1), dim=1)

    return replicated_eval
