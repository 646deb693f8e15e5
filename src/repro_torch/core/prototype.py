"""The dataflow context, copied from ``repro.core.prototype``: tasks and hooks
read inputs from and write outputs to Contexts."""
from __future__ import annotations


class Context(dict):
    """The dataflow context: {val_name: value}. Tasks read inputs from and
    write outputs to Contexts; transitions move Contexts between capsules."""

    def restrict(self, vals) -> "Context":
        return Context({v.name: self[v.name] for v in vals})

    def merged(self, other) -> "Context":
        out = Context(self)
        out.update(other)
        return out

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e
