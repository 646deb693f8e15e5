"""Provenance records of task firings — ``TaskRecord``/``RunRecord`` copied
from ``repro.core.scheduler``, with the same JSON schema
(``repro-run-record/v1``), so the port's ``provenance.json`` reads like the
reference's."""
from __future__ import annotations

import dataclasses
import datetime
import json
import os
from typing import Any, Dict, List, Optional


@dataclasses.dataclass
class TaskRecord:
    """Provenance of one task firing (one input context through one task)."""
    task: str                      # task name
    capsule: int                   # capsule id (scheduling slot)
    environment: str               # environment name it ran on
    inputs_digest: str             # sha256 of the effective input context
    started_s: float               # offset from run start (monotonic)
    wall_s: float                  # execution wall time (0.0 for cache hits)
    retries: int                   # transient-failure retries consumed
    cache_hit: bool                # True when served from the memo cache
    mode: str                      # "submit" | "lanes" | "cache"
    cache_key: Optional[str] = None  # content address (None when cache off)
    attempts: Optional[List[Dict[str, Any]]] = None


@dataclasses.dataclass
class RunRecord:
    """Provenance of one workflow run — WfCommons-informed JSON export."""
    workflow: str
    scheduler: str
    environment: str
    started_at: str                            # ISO-8601 UTC
    makespan_s: float = 0.0
    cache_hits: int = 0
    cache_misses: int = 0
    tasks: List[TaskRecord] = dataclasses.field(default_factory=list)

    def finalize(self, makespan_s: float) -> "RunRecord":
        self.makespan_s = makespan_s
        self.cache_hits = sum(1 for t in self.tasks if t.cache_hit)
        self.cache_misses = sum(1 for t in self.tasks if not t.cache_hit)
        return self

    def to_dict(self) -> Dict[str, Any]:
        return {
            "schema": "repro-run-record/v1",
            "workflow": self.workflow,
            "scheduler": self.scheduler,
            "environment": self.environment,
            "started_at": self.started_at,
            "makespan_s": self.makespan_s,
            "cache": {"hits": self.cache_hits, "misses": self.cache_misses},
            "tasks": [dataclasses.asdict(t) for t in self.tasks],
        }

    def save(self, path: str) -> None:
        """Write the record as JSON (directories created as needed)."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)


def _utcnow() -> str:
    return datetime.datetime.now(datetime.timezone.utc).isoformat()
