"""StatisticTask (paper Listing 3): reduce replicated stochastic outputs to
statistical descriptors (median/mean/std/quantiles). Ported from
``repro.explore.statistics``.

Each reducer takes ``(a, axis=0)``. A host array takes the reference's numpy
path; a tensor (the aggregation of a ``torch`` task's outputs, stacked on
its device) is reduced there, with numpy's definitions: the median averages
the middle pair, the standard deviation divides by n, the quantile
interpolates linearly, and integer tensors reduce in float64 as numpy's
integer arrays do.
"""
from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.prototype import Context, Val
from repro_torch.core.task import PyTask, Task
from repro_torch.explore import replication


def _floating(a: torch.Tensor) -> torch.Tensor:
    return a if a.is_floating_point() else a.to(torch.float64)


def median(a, axis=0):
    if isinstance(a, torch.Tensor):
        return replication.median(_floating(a), dim=axis)
    return np.median(a, axis=axis)


def mean(a, axis=0):
    if isinstance(a, torch.Tensor):
        return _floating(a).mean(dim=axis)
    return np.mean(a, axis=axis)


def std(a, axis=0):
    if isinstance(a, torch.Tensor):
        return _floating(a).std(dim=axis, correction=0)
    return np.std(a, axis=axis)


def q(p: float) -> Callable:
    def quantile(a, axis=0):
        if isinstance(a, torch.Tensor):
            return torch.quantile(_floating(a), p, dim=axis)
        return np.quantile(a, p, axis=axis)

    return quantile


def StatisticTask(name: str = "statistic",
                  statistics: Sequence[Tuple[Val, Val, Callable]] = ()) -> Task:
    """statistics: (input val holding stacked replicates, output val,
    reducer) — mirrors `statistics += (food1, medNumberFood1, median)`.
    A host input gives a float (1-d) or an array, as in the reference; a
    tensor input gives a tensor on its device."""

    stats = tuple(statistics)

    def fn(ctx: Context) -> Dict[str, object]:
        out = {}
        for src, dst, red in stats:
            value = ctx[src.name]
            if isinstance(value, torch.Tensor):
                out[dst.name] = red(value, axis=0)
                continue
            arr = np.asarray(value)
            out[dst.name] = float(red(arr, axis=0)) if arr.ndim <= 1 \
                else np.asarray(red(arr, axis=0))
        return out

    return PyTask(name, fn,
                  inputs=tuple(s[0] for s in stats),
                  outputs=tuple(s[1] for s in stats))
