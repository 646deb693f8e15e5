"""Content-addressed task memoization, ported from ``repro.core.cache``.

Tasks are "mute pieces of software" (paper §4.3): pure functions from input
Context to output dict. Purity is what makes delegation to remote
environments sound, and it is equally what makes memoization sound. A task
execution is fully determined by

  (task fingerprint, inputs digest)

where the fingerprint covers the task's identity (name, kind, declared
inputs/outputs, defaults, and the bytecode of its function, recursing
through closures) and the inputs digest is a stable hash of the prepared
input Context (defaults overlaid by the flowing context). Tensors hash like
arrays: by dtype, shape and bytes, pulled to the host first, so a tensor and
the numpy array of its values hash alike whatever device holds it.

``TaskCache`` stores output Contexts under that key, in memory and, when
given a directory, on disk, so repeated explorations and restarted runs
skip already-computed points. The same hashes give config digests in
provenance records, the inputs digest of each evaluation job, and the
output fingerprints that catch in-transit corruption.

Stochastic tasks are cache-safe as long as their randomness flows through
the dataflow (a ``seed`` Val, as in Listing 3's replication): the task
builds its generator from that seed inside its function, so different seeds
give different digests and a hit returns what a run would. Caching is
opt-in at ``Workflow.run`` (``cache=`` argument).
"""
from __future__ import annotations

import hashlib
import os
import pickle
import re
import threading
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


def cache_key(task_fingerprint: str, digest: str) -> str:
    """Combine (task fingerprint, inputs digest) into one content address."""
    return hashlib.sha256(
        (task_fingerprint + ":" + digest).encode()).hexdigest()


class TaskCache:
    """Content-addressed store of task output Contexts.

    Args:
        directory: optional path; when given, entries are also pickled to
            ``<directory>/<key>.pkl`` so a restarted run warm-starts from
            disk. In-memory entries always take precedence.

    A hit returns the stored values themselves: a tensor comes back on the
    device and in the dtype the task made it in. The disk copy pickles the
    output as it is, tensors with their device: an entry holding CUDA
    tensors loads only where CUDA is available (elsewhere it reads as a
    miss). Thread-safe: the async scheduler reads and writes from capsule
    worker threads concurrently.
    """

    def __init__(self, directory: Optional[str] = None):
        self.directory = directory
        self._mem: Dict[str, Context] = {}
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        if directory:
            os.makedirs(directory, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.directory, key + ".pkl")

    def get(self, key: str) -> Optional[Context]:
        """Return the memoized output Context for ``key``, or None.
        Updates hit/miss counters (one firing = one lookup)."""
        with self._lock:
            if key in self._mem:
                self.hits += 1
                return Context(self._mem[key])
        if self.directory:
            path = self._path(key)
            if os.path.exists(path):
                try:
                    with open(path, "rb") as f:
                        out = Context(pickle.load(f))
                except Exception:
                    out = None
                if out is not None:
                    with self._lock:
                        self._mem[key] = Context(out)
                        self.hits += 1
                    return out
        with self._lock:
            self.misses += 1
        return None

    def put(self, key: str, output: Context) -> None:
        """Store an output Context under its content address."""
        with self._lock:
            self._mem[key] = Context(output)
        if self.directory:
            tmp = self._path(key) + ".tmp"
            try:
                with open(tmp, "wb") as f:
                    pickle.dump(dict(output), f)
                os.replace(tmp, self._path(key))
            except Exception:
                # disk persistence is best-effort; memory entry stands
                if os.path.exists(tmp):
                    os.remove(tmp)

    def __len__(self) -> int:
        return len(self._mem)

    def clear(self) -> None:
        with self._lock:
            self._mem.clear()
            self.hits = self.misses = 0

    def __repr__(self):
        where = f"dir={self.directory!r}" if self.directory else "memory"
        return (f"TaskCache({where}, entries={len(self._mem)}, "
                f"hits={self.hits}, misses={self.misses})")


# Process-global default cache: ``Workflow.run(cache=True)`` uses this, so
# two identical runs in one process share memoized results.
DEFAULT_CACHE = TaskCache()


def resolve_cache(cache) -> Optional[TaskCache]:
    """Normalize the ``Workflow.run(cache=...)`` argument.

    None/False -> no memoization; True -> process-global DEFAULT_CACHE;
    str -> disk-backed TaskCache at that path; TaskCache -> itself.
    """
    if cache is None or cache is False:
        return None
    if cache is True:
        return DEFAULT_CACHE
    if isinstance(cache, str):
        return TaskCache(directory=cache)
    if isinstance(cache, TaskCache):
        return cache
    raise TypeError(f"cache must be None, bool, str, or TaskCache: {cache!r}")
