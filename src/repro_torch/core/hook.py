"""Hooks — "Tasks are mute pieces of software ... OpenMOLE introduces a
mechanism called Hooks to save or display results generated on remote
environments" (paper §4.3). Hooks run host-side after a capsule completes.
Ported from ``repro.core.hook``.

Under the async dataflow scheduler (core/scheduler.py) a hook attached to
several capsules can fire from concurrent worker threads, so hooks that
append to shared files or counters guard their critical section with a
lock. Within one capsule, hooks still fire sequentially in context order.

A tensor is shown and written as the reference shows and writes the host
array it stands for: hooks see ``value.cpu().numpy()``.
"""
from __future__ import annotations

import csv
import json
import os
import threading
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch.core.prototype import Context, Val


def _host(value: Any) -> Any:
    """A tensor as a numpy array on the host; anything else as it is."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return value


class Hook:
    """Host-side observer: called with every merged output Context of the
    capsule it is attached to."""

    def __call__(self, context: Context) -> None:
        raise NotImplementedError


class ToStringHook(Hook):
    """Paper Listing 2: display selected output values."""

    def __init__(self, *vals: Val, printer: Callable = print):
        self.vals = vals
        self.printer = printer
        self.seen = []

    def __call__(self, context: Context) -> None:
        msg = ", ".join(f"{v.name}={_host(context.get(v.name))}"
                        for v in self.vals)
        self.seen.append(msg)
        self.printer(msg)


class DisplayHook(Hook):
    """Paper Listing 4: DisplayHook("Generation ${generation}")."""

    def __init__(self, template: str, printer: Callable = print):
        self.template = template
        self.printer = printer

    def __call__(self, context: Context) -> None:
        out = self.template
        for k, v in context.items():
            out = out.replace("${" + k + "}", str(_host(v)))
        self.printer(out)


class CSVHook(Hook):
    """Append selected vals as a CSV row (AppendToCSVFileHook analogue)."""

    def __init__(self, path: str, vals: Sequence[Val]):
        self.path = path
        self.vals = vals
        self._lock = threading.Lock()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        if not os.path.exists(path):
            with open(path, "w", newline="") as f:
                csv.writer(f).writerow([v.name for v in vals])

    def __call__(self, context: Context) -> None:
        row = [np.asarray(_host(context[v.name])).tolist()
               for v in self.vals]
        with self._lock, open(self.path, "a", newline="") as f:
            csv.writer(f).writerow(row)


class SavePopulationHook(Hook):
    """Paper Listings 4/5: persist the GA population/Pareto archive each
    generation under a directory (one CSV per generation + latest.json)."""

    def __init__(self, directory: str):
        self.directory = directory
        self._lock = threading.Lock()
        os.makedirs(directory, exist_ok=True)
        self.generations_saved = 0

    def __call__(self, context: Context) -> None:
        with self._lock:
            self._save(context)

    def _save(self, context: Context) -> None:
        gen = int(np.asarray(_host(context.get("generation",
                                                self.generations_saved))))
        genomes = np.asarray(_host(context["genomes"]))
        objectives = np.asarray(_host(context["objectives"]))
        path = os.path.join(self.directory, f"population_{gen}.csv")
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow([f"g{i}" for i in range(genomes.shape[1])]
                       + [f"o{i}" for i in range(objectives.shape[1])])
            for g, o in zip(genomes, objectives):
                w.writerow(list(g) + list(o))
        with open(os.path.join(self.directory, "latest.json"), "w") as f:
            json.dump({"generation": gen, "path": path}, f)
        self.generations_saved += 1


class CheckpointHook(Hook):
    """Persist an arbitrary tree val through repro_torch.checkpoint."""

    def __init__(self, directory: str, val: Val, every: int = 1):
        from repro_torch import checkpoint
        self._ckpt = checkpoint
        self.directory = directory
        self.val = val
        self.every = every
        self.calls = 0
        self._lock = threading.Lock()

    def __call__(self, context: Context) -> None:
        with self._lock:
            if self.calls % self.every == 0:
                self._ckpt.save(self.directory, self.calls,
                                context[self.val.name])
            self.calls += 1
