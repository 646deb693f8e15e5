"""The workflow DSL — OpenMOLE's Scala operators mapped to Python, ported
from ``repro.core.dsl``.

OpenMOLE                      ->  here
---------------------------------------------------------------
val ants = NetLogo5Task(...)      ants = TorchTask("ants", fn, ...)
ants -- statistic                 ants_c >> stat_c           (Puzzle)
Replicate(model, seed x 5, stat)  replicate(model, seeds, stat)
exploration -< task               explore(sampling) >> task
task >- aggregate                 aggregate() >> task
capsule on env                    capsule.on(env)
capsule hook h                    capsule.hook(h)
(puzzle + puzzle) start           puzzle.run(initial, env)

A Puzzle is a partial workflow with dangling tails; ``>>`` extends it, ``+``
unions two puzzles, ``run`` seals and executes.
"""
from __future__ import annotations

from typing import List, Optional, Union

from repro_torch.core.environment import Environment
from repro_torch.core.prototype import Context
from repro_torch.core.task import Task
from repro_torch.core.workflow import Capsule, Workflow


def _as_capsule(x) -> Capsule:
    if isinstance(x, Capsule):
        return x
    if isinstance(x, Task):
        return Capsule(x)
    raise TypeError(f"cannot convert {x!r} to a Capsule")


class _Explore:
    def __init__(self, sampling):
        self.sampling = sampling


class _Aggregate:
    pass


def explore(sampling) -> "_Explore":
    """Marks the next transition as an exploration (fan-out)."""
    return _Explore(sampling)


def aggregate() -> "_Aggregate":
    """Marks the next transition as an aggregation (fan-in)."""
    return _Aggregate()


class Puzzle:
    def __init__(self, workflow: Workflow, tails: List[Capsule],
                 pending: Optional[Union[_Explore, _Aggregate]] = None):
        self.workflow = workflow
        self.tails = tails
        self.pending = pending

    @classmethod
    def from_capsule(cls, c) -> "Puzzle":
        wf = Workflow()
        cap = _as_capsule(c)
        wf.add(cap)
        return cls(wf, [cap])

    def __rshift__(self, other) -> "Puzzle":
        if isinstance(other, (_Explore, _Aggregate)):
            return Puzzle(self.workflow, self.tails, other)
        cap = _as_capsule(other)
        kind, sampling = "simple", None
        if isinstance(self.pending, _Explore):
            kind, sampling = "exploration", self.pending.sampling
        elif isinstance(self.pending, _Aggregate):
            kind = "aggregation"
        for t in self.tails:
            self.workflow.connect(t, cap, kind=kind, sampling=sampling)
        return Puzzle(self.workflow, [cap])

    def __add__(self, other: "Puzzle") -> "Puzzle":
        """Union of two puzzles into one workflow (Listing 5's +)."""
        wf = self.workflow
        for c in other.workflow.capsules:
            wf.add(c)
        wf.transitions.extend(other.workflow.transitions)
        return Puzzle(wf, self.tails + other.tails)

    def run(self, initial=None, environment: Optional[Environment] = None,
            **kwargs):
        """Seal the puzzle and execute its workflow.

        Args:
            initial: seed Context for root capsules.
            environment: default Environment for all capsules.
            **kwargs: forwarded to :meth:`Workflow.run` — ``scheduler=``,
                ``cache=``, ``provenance_path=``, ``max_workers=``.

        Returns:
            Dict of Capsule -> list of merged output Contexts.
        """
        return self.workflow.run(Context(initial or {}), environment,
                                 **kwargs)

    # paper spelling: `val ex = workflow start`
    start = run


def puzzle(c) -> Puzzle:
    return Puzzle.from_capsule(c)
