"""Sources inject data into the dataflow before a capsule runs (paper §2.1:
"OpenMOLE exposes several facilities to inject data in the dataflow
(sources)"). Copied from ``repro.core.source``: host values, as there."""
from __future__ import annotations

import csv
from typing import Any, Callable, Dict

import numpy as np

from repro_torch.core.prototype import Context, Val


class Source:
    def __call__(self, context: Context) -> Context:
        raise NotImplementedError


class ConstantSource(Source):
    def __init__(self, **values):
        self.values = values

    def __call__(self, context: Context) -> Context:
        return context.merged(self.values)


class CSVSource(Source):
    """Reads columns of a CSV into array Vals."""

    def __init__(self, path: str, columns: Dict[str, Val]):
        self.path = path
        self.columns = columns

    def __call__(self, context: Context) -> Context:
        with open(self.path, newline="") as f:
            rows = list(csv.DictReader(f))
        out = Context(context)
        for col, val in self.columns.items():
            out[val.name] = np.array(
                [float(r[col]) for r in rows], np.float32)
        return out


class FunctionSource(Source):
    def __init__(self, fn: Callable[[Context], Dict[str, Any]]):
        self.fn = fn

    def __call__(self, context: Context) -> Context:
        return context.merged(self.fn(context))
