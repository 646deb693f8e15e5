"""Tasks — "mute pieces of software ... compute some output data from their
input data. That's what guarantees that their execution can be delegated to
other machines" (paper §4.3). Copied from ``repro.core.task``.

- ``Task``: declared inputs/outputs (Vals) + defaults + a pure function
  Context -> dict. The engine enforces that outputs match the declaration
  (task purity is checked, not assumed).
- ``TorchTask``: the counterpart of the reference's ``JaxTask``: a function
  of tensors run on one device (the card unless the caller asks for the
  CPU); a fan-out of one goes to ``environment.map_explore`` as lanes.
- ``PyTask``: host-side Python, eligible for speculative resubmission on
  environments that support it. A task may launch work on the card from its
  function (the surrogate's evaluation jobs do).
- ``StatisticTask`` lives in repro_torch.explore.statistics.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.core.prototype import Context, Val
from repro_torch.runtime.device import resolve_device


class TaskError(RuntimeError):
    pass


@dataclasses.dataclass
class Task:
    """A pure unit of computation in the dataflow.

    Attributes:
        name: unique label (appears in errors and provenance records).
        fn: the computation, ``Context -> dict`` of declared outputs.
        inputs: Vals the task consumes; missing ones raise at ``prepare``.
        outputs: Vals the task must produce; checked after every run.
        defaults: fallback values overlaid under the flowing context.
        kind: "py" (host-side, eligible for speculation/threading) or
            "torch" (device-side, eligible for batched lanes).

    Purity contract: ``fn`` must depend only on its input Context — that is
    what makes delegation to other environments sound.
    """

    name: str
    fn: Callable[[Context], Dict[str, Any]]
    inputs: Tuple[Val, ...] = ()
    outputs: Tuple[Val, ...] = ()
    defaults: Dict[str, Any] = dataclasses.field(default_factory=dict)
    kind: str = "py"                 # py | torch

    def prepare(self, context: Context) -> Context:
        """Overlay ``context`` on the defaults and check declared inputs.
        Raises TaskError if any declared input Val is absent."""
        ctx = Context(self.defaults)
        ctx.update(context)
        missing = [v.name for v in self.inputs if v.name not in ctx]
        if missing:
            raise TaskError(f"task {self.name}: missing inputs {missing}")
        return ctx

    def validate_outputs(self, out: Dict[str, Any]) -> Context:
        """Check ``fn``'s return value against the output declaration.
        Raises TaskError if ``out`` is not a dict, a declared output is
        missing, or a value fails its Val type check."""
        if not isinstance(out, dict):
            raise TaskError(f"task {self.name}: fn must return a dict")
        missing = [v.name for v in self.outputs if v.name not in out]
        if missing:
            raise TaskError(f"task {self.name}: missing outputs {missing}")
        for v in self.outputs:
            if not v.check(out[v.name]):
                raise TaskError(
                    f"task {self.name}: output {v.name} failed type check "
                    f"({type(out[v.name])} vs {v.dtype})")
        return Context(out)

    def run(self, context: Context) -> Context:
        """Prepare inputs, execute ``fn``, validate outputs; returns the
        validated output Context (outputs only)."""
        ctx = self.prepare(context)
        return self.validate_outputs(self.fn(ctx))

    def set(self, **defaults) -> "Task":
        """A copy with extra default values (the paper's ``set`` DSL)."""
        d = dict(self.defaults)
        d.update(defaults)
        return dataclasses.replace(self, defaults=d)


def PyTask(name, fn, inputs=(), outputs=(), defaults=None) -> Task:
    return Task(name=name, fn=fn, inputs=tuple(inputs), outputs=tuple(outputs),
                defaults=dict(defaults or {}), kind="py")


def TorchTask(name, fn, inputs=(), outputs=(), defaults=None,
              device="cuda") -> Task:
    """The counterpart of the reference's ``JaxTask``: ``fn(**inputs)``,
    called with keyword arguments named after the declared inputs, returns
    a dict of outputs, or one value when the task has a single output.

    ``device`` (the card unless the caller asks for the CPU) is resolved
    here, so a task made for the card on a machine without one raises at
    once. Tensor inputs are moved to it before ``fn`` runs; ``fn`` makes
    its own tensors there. A task that draws random numbers builds its
    generator inside ``fn`` from an input (a ``seed`` Val), on every call:
    a generator shared across the scheduler's threads would make the
    results depend on the schedule, and the cache would be unsound."""
    dev = resolve_device(device)
    input_names = tuple(v.name for v in inputs)
    output_names = tuple(v.name for v in outputs)

    def wrapper(ctx: Context) -> Dict[str, Any]:
        args = {n: ctx[n].to(dev) if isinstance(ctx[n], torch.Tensor)
                else ctx[n] for n in input_names}
        out = fn(**args)
        if not isinstance(out, dict):
            if len(output_names) != 1:
                raise TaskError(f"task {name}: fn returned non-dict for "
                                f"{len(output_names)} outputs")
            out = {output_names[0]: out}
        return out

    return Task(name=name, fn=wrapper, inputs=tuple(inputs),
                outputs=tuple(outputs), defaults=dict(defaults or {}),
                kind="torch")
