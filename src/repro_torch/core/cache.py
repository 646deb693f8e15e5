"""Stable content hashing of dataflow values and task firings — the part of
``repro.core.cache`` the port uses, copied: config digests in provenance
records, the inputs digest of each evaluation job, task fingerprints, and the
output fingerprints that catch in-transit corruption. Tensors hash like
arrays: by dtype, shape and bytes, pulled to the host first."""
from __future__ import annotations

import hashlib
import re
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core.prototype import Context
from repro_torch.core.task import Task

_ADDR_RE = re.compile(r"0x[0-9a-fA-F]+")


def _update_value(h, value: Any, seen: Optional[set] = None) -> None:
    """Feed one dataflow value into a hash, canonically: arrays by
    dtype/shape/bytes, containers recursively with sorted dict keys,
    scalars by type+repr, other objects by structure with memory addresses
    stripped (digests must be stable across processes)."""
    if seen is None:
        seen = set()
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().numpy()
    if hasattr(value, "__array__") or isinstance(value, np.ndarray):
        arr = np.asarray(value)
        h.update(b"arr")
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(np.ascontiguousarray(arr).tobytes())
    elif isinstance(value, dict):
        h.update(b"dict")
        for k in sorted(value, key=str):
            h.update(str(k).encode())
            _update_value(h, value[k], seen)
    elif isinstance(value, (list, tuple)):
        h.update(b"seq")
        for v in value:
            _update_value(h, v, seen)
    elif isinstance(value, bytes):
        h.update(b"bytes")
        h.update(value)
    elif isinstance(value, (int, float, bool, str, complex, type(None))):
        h.update(type(value).__name__.encode())
        h.update(repr(value).encode())
    else:
        h.update(type(value).__name__.encode())
        if id(value) in seen:          # object graphs may cycle
            h.update(b"cycle")
            return
        seen.add(id(value))
        if type(value).__repr__ is object.__repr__:
            # default repr is just an address: hash structure instead
            _update_value(h, getattr(value, "__dict__", {}), seen)
        else:
            h.update(_ADDR_RE.sub("0x?", repr(value)).encode())


def hash_value(value: Any) -> str:
    """Stable hex digest of a single dataflow value."""
    h = hashlib.sha256()
    _update_value(h, value)
    return h.hexdigest()


def hash_context(context: Dict[str, Any]) -> str:
    """Stable hex digest of a Context (order-independent over keys)."""
    h = hashlib.sha256()
    _update_value(h, dict(context))
    return h.hexdigest()


def _update_code(h, fn, seen) -> None:
    """Hash a function by bytecode + consts + closure, recursively, never
    by its address-bearing repr (fingerprints must be stable across
    processes)."""
    import functools
    import types
    if id(fn) in seen:
        return
    seen.add(id(fn))
    code = getattr(fn, "__code__", None)
    if code is None:
        # builtins, functools.partial, callables: identify structurally
        h.update(getattr(fn, "__qualname__", type(fn).__name__).encode())
        if isinstance(fn, functools.partial):
            _update_value(h, fn.args)
            _update_value(h, fn.keywords)
            _update_code(h, fn.func, seen)
            return
        if not isinstance(fn, (types.BuiltinFunctionType,
                               types.BuiltinMethodType)):
            # callable object: its instance state is part of its identity
            _update_value(h, getattr(fn, "__dict__", {}))
        inner = getattr(fn, "func", None) or getattr(fn, "__call__", None)
        if inner is not fn and getattr(inner, "__code__", None) is not None:
            _update_code(h, inner, seen)
        return
    _update_value(h, fn.__defaults__ or ())
    _update_value(h, fn.__kwdefaults__ or {})
    h.update(code.co_code)
    h.update(str(code.co_names).encode())
    h.update(str(code.co_varnames).encode())
    for const in code.co_consts:
        if isinstance(const, types.CodeType):
            h.update(const.co_code)
        else:
            h.update(repr(const).encode())
    for cell in fn.__closure__ or ():
        try:
            contents = cell.cell_contents
        except ValueError:          # unfilled cell
            continue
        if callable(contents):
            _update_code(h, contents, seen)
        else:
            _update_value(h, contents)


def fingerprint_task(task: Task) -> str:
    """Content fingerprint of a task: name, kind, I/O declaration, defaults,
    and function bytecode (closures included). Two tasks with the same
    fingerprint compute the same outputs from the same inputs."""
    h = hashlib.sha256()
    h.update(task.name.encode())
    h.update(task.kind.encode())
    h.update(str([v.name for v in task.inputs]).encode())
    h.update(str([v.name for v in task.outputs]).encode())
    _update_value(h, task.defaults)
    _update_code(h, task.fn, set())
    return h.hexdigest()


def inputs_digest(task: Task, context: Context) -> str:
    """Digest of the *effective* inputs of a task firing: defaults overlaid
    by the flowing context (``Task.prepare`` without the presence check, so
    it can be computed before execution)."""
    eff = dict(task.defaults)
    eff.update(context)
    return hash_context(eff)
