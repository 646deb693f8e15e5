"""Hooks — "Tasks are mute pieces of software ... OpenMOLE introduces a
mechanism called Hooks to save or display results generated on remote
environments" (paper §4.3). The part of ``repro.core.hook`` that the island
calibration uses, copied."""
from __future__ import annotations

import csv
import json
import os
import threading

import numpy as np

from repro_torch.core.prototype import Context


class Hook:
    """Host-side observer: called with every merged output Context of the
    capsule it is attached to."""

    def __call__(self, context: Context) -> None:
        raise NotImplementedError


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
        gen = int(np.asarray(context.get("generation", self.generations_saved)))
        genomes = np.asarray(context["genomes"])
        objectives = np.asarray(context["objectives"])
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
