"""Hermetic task packaging — the CARE/CDE analogue (paper §3), ported from
``repro.core.packaging`` (``jax.export``) to ``torch.export``.

CARE ships a syscall-complete archive so a job re-executes bit-identically
on any grid node. Here the hermetic unit is the traced program: a task's
function is exported at example inputs into an ATen graph, saved as
``computation.pt2`` beside a ``manifest.json``, and re-executed from the
bundle alone:

- re-execution needs no task code, only the bundle and the op library
  (``repro_torch.kernels``, which registers B1 and B2 as custom ops, so a
  graph can hold a kernel launch);
- the program is pinned op for op: the same inputs give the same bits on
  the same device type;
- tensors the function makes are made on the device it was exported on
  (the manifest's ``device``): a bundle exported on the card runs there.

A task that draws random numbers is packaged in its apply form (its draws
are inputs, e.g. ``simulate_batch(cfg, d, e, noise=...)``): a generator is
not part of a graph.
"""
from __future__ import annotations

import json
import os
from typing import Any, Callable, Sequence

import torch

OPS_NAMESPACE = "repro_torch"


class _Fn(torch.nn.Module):
    """``fn`` as the module ``torch.export`` takes."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _spec(t) -> str:
    return f"{str(t.dtype).replace('torch.', '')}{list(t.shape)}"


def _custom_ops(program) -> list:
    """The ``repro_torch::`` ops the graph calls, by name."""
    return sorted({n.target.name().split(".")[0]
                   for n in program.graph.nodes
                   if isinstance(n.target, torch._ops.OpOverload)
                   and n.target.namespace == OPS_NAMESPACE})


def package(fn: Callable, example_args: Sequence[Any], path: str,
            *, name: str = "task") -> str:
    """Export ``fn`` at ``example_args`` (tensors, or meta tensors for a
    function that makes none of its own) and write the bundle directory
    ``path``: ``computation.pt2`` and ``manifest.json`` (the reference's
    ``name``, input and output specs and ``nbytes``, plus the device type
    and the custom ops the graph calls)."""
    os.makedirs(path, exist_ok=True)
    program = torch.export.export(_Fn(fn), tuple(example_args))
    program.example_inputs = None     # the bundle holds no input data
    blob = os.path.join(path, "computation.pt2")
    torch.export.save(program, blob)
    outs = [n for n in program.graph.nodes if n.op == "output"][0].args[0]
    devices = sorted({t.device.type for t in example_args
                      if isinstance(t, torch.Tensor)})
    meta = {
        "name": name,
        "in_specs": [_spec(t) for t in example_args],
        "out_specs": [_spec(n.meta["val"]) for n in outs],
        "device": devices[0] if len(devices) == 1 else devices,
        "custom_ops": _custom_ops(program),
        "nbytes": os.path.getsize(blob),
    }
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(meta, f, indent=2)
    return path


def load(path: str) -> Callable:
    """Rehydrate a packaged task as a callable (no task code needed): the
    op library is imported first, so the graph's custom ops resolve."""
    import repro_torch.kernels  # noqa: F401  (registers the custom ops)
    program = torch.export.load(os.path.join(path, "computation.pt2"))
    return program.module()


def manifest(path: str) -> dict:
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)
