"""Workflow DAG + execution engine, ported from ``repro.core.workflow``.

"A workflow is a set of tasks linked with each other through transitions ...
Each task produces outputs returned to the dataflow and transmitted to the
input of consecutive tasks" (paper §2.1).

Semantics implemented:
- Capsule: scheduling slot around a Task, with hooks and an optional
  per-capsule environment override (``on``) — Listing 5's ``island on env``.
- Transitions: simple (1 context -> 1), exploration (1 -> N via a Sampling),
  aggregation (N -> 1 with stacked values).
- Execution: delegated to the dataflow schedulers in core/scheduler.py.
  The default ``scheduler="async"`` fires capsules as soon as their input
  contexts arrive (independent branches overlap on a thread pool);
  ``scheduler="serial"`` is the paper-faithful topological loop kept for
  bit-exact comparison. Fan-outs of a ``torch`` task are delegated to
  ``environment.map_explore`` (lanes); everything else runs through
  ``environment.submit_async``/``submit`` (with retry/speculation).
- Memoization: pass ``cache=`` to skip already-computed (task, inputs)
  points via the content-addressed TaskCache (core/cache.py).
- Output contexts are the union of input and task outputs (dataflow
  propagation).
- Aggregation stacks tensors with ``torch.stack`` on their device, and host
  values with numpy, as the reference does.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.environment import Environment, LocalEnvironment
from repro_torch.core.hook import Hook
from repro_torch.core.prototype import Context
from repro_torch.core.task import Task


class Capsule:
    """Scheduling slot around a Task: hooks plus an optional per-capsule
    environment override (Listing 5's ``island on env``).

    The same Task can be wrapped by several Capsules (it then occupies
    several slots in the DAG); each capsule is what the scheduler fires.

    Args:
        task: the Task this capsule executes.
        hooks: host-side observers called with every merged output Context.
        environment: overrides the workflow-level environment for this
            capsule only (None = inherit).
    """

    _ids = itertools.count()

    def __init__(self, task: Task, hooks: Sequence[Hook] = (),
                 environment: Optional[Environment] = None):
        self.task = task
        self.hooks = list(hooks)
        self.environment = environment
        self.id = next(Capsule._ids)

    def hook(self, h: Hook) -> "Capsule":
        """Attach a Hook; returns self for chaining (``capsule hook h``)."""
        self.hooks.append(h)
        return self

    def on(self, env: Environment) -> "Capsule":
        """Pin this capsule to a specific environment; returns self
        (``capsule on env`` in the paper's DSL)."""
        self.environment = env
        return self

    def __repr__(self):
        return f"Capsule({self.task.name})"

    # DSL: a >> b adds a simple transition inside an implicit Puzzle
    def __rshift__(self, other):
        from repro_torch.core.dsl import Puzzle
        return Puzzle.from_capsule(self) >> other


@dataclasses.dataclass
class Transition:
    src: Capsule
    dst: Capsule
    kind: str = "simple"              # simple | exploration | aggregation
    sampling: Any = None              # explore.sampling.Sampling
    condition: Optional[Callable[[Context], bool]] = None


class Workflow:
    """A DAG of Capsules linked by Transitions, plus the run entry point.

    Args:
        name: label used in provenance records and error messages.

    Attributes:
        capsules: all scheduling slots in the DAG.
        transitions: directed edges (simple / exploration / aggregation).
        last_record: the RunRecord of the most recent :meth:`run` (None
            before the first run) — per-task provenance and cache stats.
    """

    def __init__(self, name: str = "workflow"):
        self.name = name
        self.capsules: List[Capsule] = []
        self.transitions: List[Transition] = []
        self.last_record = None

    def add(self, capsule: Capsule) -> Capsule:
        """Register a capsule (idempotent); returns it for chaining."""
        if capsule not in self.capsules:
            self.capsules.append(capsule)
        return capsule

    def connect(self, src: Capsule, dst: Capsule, kind: str = "simple",
                sampling=None, condition=None) -> None:
        """Add a transition from ``src`` to ``dst``.

        Args:
            src: upstream capsule (auto-registered).
            dst: downstream capsule (auto-registered).
            kind: "simple" (1->1), "exploration" (1->N via ``sampling``),
                or "aggregation" (N->1, values stacked).
            sampling: an explore.sampling.Sampling (exploration only).
            condition: optional predicate Context -> bool; contexts failing
                it do not flow through this transition.
        """
        self.add(src)
        self.add(dst)
        self.transitions.append(Transition(src, dst, kind, sampling,
                                           condition))

    # ------------------------------------------------------------------ dag
    def _topo_order(self) -> List[Capsule]:
        indeg = {c: 0 for c in self.capsules}
        for t in self.transitions:
            indeg[t.dst] += 1
        order, frontier = [], [c for c, d in indeg.items() if d == 0]
        while frontier:
            c = frontier.pop(0)
            order.append(c)
            for t in self.transitions:
                if t.src is c:
                    indeg[t.dst] -= 1
                    if indeg[t.dst] == 0:
                        frontier.append(t.dst)
        if len(order) != len(self.capsules):
            raise ValueError(f"workflow {self.name}: cycle detected")
        return order

    def validate(self) -> List[str]:
        """Static wiring check: every declared input must be satisfiable by
        an upstream output, a default, a sampling, or the initial context.
        Returns a list of warnings (empty = clean)."""
        warnings = []
        producers: Dict[str, List[str]] = {}
        for t in self.transitions:
            for v in t.src.task.outputs:
                producers.setdefault(v.name, []).append(t.src.task.name)
            if t.sampling is not None:
                for v in t.sampling.provides():
                    producers.setdefault(v.name, []).append("sampling")
        roots = {c for c in self.capsules
                 if not any(t.dst is c for t in self.transitions)}
        for c in self.capsules:
            if c in roots:
                continue
            for v in c.task.inputs:
                if v.name not in producers and v.name not in c.task.defaults:
                    warnings.append(
                        f"{c.task.name}: input {v.name} has no producer")
        return warnings

    # ------------------------------------------------------------------ run
    def run(self, initial: Optional[Context] = None,
            environment: Optional[Environment] = None, *,
            scheduler: str = "async", cache=None,
            provenance_path: Optional[str] = None,
            max_workers: Optional[int] = None
            ) -> Dict[Capsule, List[Context]]:
        """Execute the workflow and return per-capsule output contexts.

        Args:
            initial: seed values delivered to every root capsule.
            environment: default execution environment (LocalEnvironment
                when omitted); per-capsule ``.on(env)`` overrides win.
            scheduler: "async" (default) fires capsules as soon as their
                inputs arrive — independent branches run concurrently;
                "serial" is the reference topological loop. Both produce
                identical results for pure tasks.
            cache: task memoization — None/False off, True for the
                process-global cache, a directory path for a disk-backed
                cache (restart-safe), or a TaskCache instance.
            provenance_path: when given, the run's provenance record
                (per-task wall time, retries, cache hit/miss, input
                digests) is written there as JSON.
            max_workers: async scheduler thread-pool width.

        Returns:
            Dict mapping each Capsule to the list of merged output
            Contexts it produced (inputs unioned with task outputs).
            The full provenance is available as ``self.last_record``.
        """
        from repro_torch.core.scheduler import run_workflow
        env = environment or LocalEnvironment()
        results, record = run_workflow(
            self, Context(initial or {}), env, scheduler=scheduler,
            cache=cache, max_workers=max_workers)
        self.last_record = record
        if provenance_path:
            record.save(provenance_path)
        return results


def _aggregate(contexts: Sequence[Context]) -> Context:
    """N contexts -> 1 with each value stacked (left to StatisticTask to
    reduce): tensors with ``torch.stack`` on their device, host values with
    ``np.stack``; values that do not stack stay a list, as in the
    reference."""
    if not contexts:
        return Context()
    keys = set(contexts[0])
    for c in contexts[1:]:
        keys &= set(c)
    out = Context()
    for k in keys:
        vals = [c[k] for c in contexts]
        tensors = [isinstance(v, torch.Tensor) for v in vals]
        try:
            if all(tensors):
                out[k] = torch.stack(vals)
            elif not any(tensors):
                out[k] = np.stack([np.asarray(v) for v in vals])
            else:
                out[k] = vals
        except Exception:
            out[k] = vals
    return out
