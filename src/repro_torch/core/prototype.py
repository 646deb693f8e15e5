"""Typed dataflow variables and the dataflow context, copied from
``repro.core.prototype``: a ``Val`` names a slot in the Context; tasks and
hooks read inputs from and write outputs to Contexts."""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Val:
    name: str
    dtype: Optional[type] = None      # python/numpy scalar type or None (any)
    shape: Optional[Tuple[int, ...]] = None

    def __repr__(self):
        t = f":{self.dtype.__name__}" if self.dtype else ""
        return f"Val({self.name}{t})"

    def check(self, value: Any) -> bool:
        if self.dtype is None:
            return True
        if self.dtype in (int, float, bool, str):
            try:
                if self.dtype is float:
                    return not isinstance(value, (str, bytes))
                return isinstance(value, self.dtype) or (
                    hasattr(value, "dtype") and value.shape == ())
            except Exception:
                return False
        return isinstance(value, self.dtype)


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
