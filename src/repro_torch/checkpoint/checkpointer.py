"""Checkpoints of nested NamedTuples/dicts of tensors: one npz + a JSON
manifest per step, committed by atomic rename. Ported from
``repro.checkpoint.checkpointer``.

Layout:
  <dir>/step_<n>/manifest.json       leaf paths, dtypes, kinds
  <dir>/step_<n>/arrays.npz          {leaf path: ndarray}
  <dir>/step_<n>/.complete           commit marker

Trees are nested NamedTuples and dicts; leaves are tensors (restored to a
given device; bfloat16 ones are stored as their int16 bits), numpy arrays,
or Python ints. A ``torch.Generator`` is saved
through its ``get_state()`` bytes, so a resumed run draws exactly the
numbers the uninterrupted run would have.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch


def _flatten(tree, prefix=""):
    """{dotted path: leaf} of a nested NamedTuple/dict of leaves."""
    if hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, dict):
        items = sorted(tree.items())
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def _unflatten(like, leaves: Dict[str, Any], prefix=""):
    def path(k):
        return f"{prefix}.{k}" if prefix else str(k)

    if hasattr(like, "_fields"):
        return type(like)(*(_unflatten(v, leaves, path(k))
                            for k, v in zip(like._fields, like)))
    if isinstance(like, dict):
        return {k: _unflatten(v, leaves, path(k)) for k, v in like.items()}
    return leaves[prefix]


def save(directory: str, step: int, tree: Any) -> None:
    """Atomically persist a tree of tensors/arrays/ints as step ``step``."""
    flat = _flatten(tree)
    arrays, kinds = {}, {}
    for k, v in flat.items():
        if isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16:
            # numpy has no bfloat16: its bits, as int16
            arrays[k] = v.detach().cpu().view(torch.int16).numpy()
            kinds[k] = "bfloat16"
        elif isinstance(v, torch.Tensor):
            arrays[k], kinds[k] = v.detach().cpu().numpy(), "tensor"
        elif isinstance(v, int):
            arrays[k], kinds[k] = np.asarray(v, np.int64), "int"
        else:
            arrays[k], kinds[k] = np.asarray(v), "array"
    meta = {"step": step, "kinds": kinds,
            "shapes": {k: list(a.shape) for k, a in arrays.items()},
            "dtypes": {k: str(a.dtype) for k, a in arrays.items()}}
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + f".tmp{os.getpid()}_{threading.get_ident()}"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(meta, f)
    open(os.path.join(tmp, ".complete"), "w").close()
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(name.split("_")[1]) for name in os.listdir(directory)
             if name.startswith("step_") and ".tmp" not in name
             and os.path.exists(os.path.join(directory, name, ".complete"))]
    return max(steps) if steps else None


def saved_leaves(directory: str, step: int) -> list:
    """The dotted leaf paths that step ``step`` holds (from its manifest):
    what a caller needs to build the ``like`` tree of ``restore`` when the
    saved tree's shape depends on settings."""
    path = os.path.join(directory, f"step_{step:08d}", "manifest.json")
    with open(path) as f:
        return sorted(json.load(f)["kinds"])


def restore(directory: str, step: int, like: Any, device=None):
    """Restore step ``step`` into the structure of ``like`` (any tree with
    the saved structure; only its structure and leaf shapes are read).
    Tensor leaves land on ``device``."""
    path = os.path.join(directory, f"step_{step:08d}")
    if not os.path.exists(os.path.join(path, ".complete")):
        raise FileNotFoundError(f"incomplete or missing checkpoint: {path}")
    with open(os.path.join(path, "manifest.json")) as f:
        meta = json.load(f)
    expect = _flatten(like)
    if set(expect) != set(meta["kinds"]):
        raise ValueError(f"checkpoint {path} holds leaves "
                         f"{sorted(meta['kinds'])}, expected {sorted(expect)}")
    leaves = {}
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for k, kind in meta["kinds"].items():
            a = data[k]
            shape = getattr(expect[k], "shape", None)
            if shape is not None and tuple(shape) != a.shape:
                raise ValueError(f"{path}: leaf {k} has shape {a.shape}, "
                                 f"expected {tuple(shape)}")
            if kind == "tensor":
                leaves[k] = torch.from_numpy(a).to(device)
            elif kind == "bfloat16":
                leaves[k] = torch.from_numpy(a).view(torch.bfloat16).to(
                    device)
            elif kind == "int":
                leaves[k] = int(a)
            else:
                leaves[k] = a
    return _unflatten(like, leaves)


def require_settings(directory: str, saved: str, settings: str) -> None:
    """Refuse to resume a run whose checkpoint holds other settings:
    ``saved`` and ``settings`` are JSON objects (strings); raises
    ``ValueError`` naming the keys that differ."""
    if saved == settings:
        return
    was, now = json.loads(saved), json.loads(settings)
    differ = sorted(k for k in now | was if now.get(k) != was.get(k))
    raise ValueError(f"{directory} holds a run with other settings "
                     f"(differing: {', '.join(differ)}); give another "
                     f"out_dir")


def prune(directory: str, keep: int = 3) -> None:
    """Keep the newest ``keep`` complete checkpoints (bounded disk)."""
    if not os.path.isdir(directory):
        return
    steps = sorted(
        int(n.split("_")[1]) for n in os.listdir(directory)
        if n.startswith("step_") and ".tmp" not in n
        and os.path.exists(os.path.join(directory, n, ".complete")))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"))
