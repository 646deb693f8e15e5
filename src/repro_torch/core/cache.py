"""Stable content hashing of dataflow values — the part of
``repro.core.cache`` that the island calibration uses (its config digest in
the provenance record), copied. Tensors hash like arrays: by dtype, shape
and bytes, pulled to the host first."""
from __future__ import annotations

import hashlib
import re
from typing import Any, Optional

import numpy as np
import torch

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
