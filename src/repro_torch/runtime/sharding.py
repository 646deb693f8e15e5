"""Logical-axis sharding over the ranks a run spans, and the row-sharded
Pareto-dominance sweep over them, ported from ``repro.runtime.sharding``.

A ``Mesh`` names the ranks of a ``torch.distributed`` process group by axis
(``("data",)`` or ``("pod", "data")``, built by ``launch.mesh``; the
production meshes add ``"model"``) and this rank's device. A ``Mesh`` with
more than one rank and no ``device_mesh`` is abstract (``abstract_mesh``):
it serves the resolver, as the reference's ``AbstractMesh`` does, and has
no process group.

The logical-axis resolver: every parameter, activation or cache dim
carries a *logical* axis name (``models/common.py``), and
``logical_to_spec`` maps the names onto mesh axes with

- a priority list of candidate mesh axes per logical name (``RULES``),
- divisibility guards: a candidate is skipped unless the dim size is a
  multiple of the product of its mesh axes' sizes (this is what lets
  smollm's 9 heads or minicpm's 122753 vocab fall back),
- one mesh axis per spec: an axis is never used twice,
- a tensor-parallel fallback: a >= 2-D weight that ends up without the
  "model" axis tries its "embed" dim (off under the ``__no_tp_fallback__``
  override),
- an FSDP pass (``fsdp``): the largest still-free dim of a param of at
  least 2**20 elements is sharded over ("pod", "data") or ("data",).

A ``Spec`` is the reference's ``PartitionSpec``: one entry a dim, None, a
mesh axis name, or a tuple of names. ``spec_to_placements`` turns it into
``torch.distributed.tensor`` placements, one a mesh dim. ``use_mesh``
installs a mesh and per-arch rule overrides for ``constrain`` (per thread).

The dominance sweep takes its mesh (or a process group) as an argument.
Its collectives are ``all_reduce``, ``all_gather``, ``broadcast`` and
``barrier`` only: gloo takes CUDA tensors for all four, so two ranks on one
card (gloo) run the same code as one rank per card (NCCL).
"""
from __future__ import annotations

import dataclasses
import math
import threading
from typing import Any, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.kernels import ops as kops

BIG = 3.0e38        # the reference's pad value (repro.kernels.dominance.BIG)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``axes`` ((name, size), ...) over the ranks of the default process
    group, row-major, rank r at flat position r; ``device`` is this rank's
    device; ``device_mesh`` the torch ``DeviceMesh`` over those ranks. None
    for the one-rank mesh of a process without a process group, and for an
    abstract mesh (``abstract_mesh``), which only the resolver reads."""
    axes: Tuple[Tuple[str, int], ...]
    device: torch.device
    device_mesh: Any = None

    @property
    def shape(self) -> dict:
        return dict(self.axes)

    @property
    def size(self) -> int:
        return math.prod(s for _, s in self.axes)

    @property
    def rank(self) -> int:
        return dist.get_rank() if self.device_mesh is not None else 0

    @property
    def group(self):
        """The process group of all the mesh's ranks (None for one rank).
        An abstract mesh has none and raises."""
        if self.size <= 1:
            return None
        if self.device_mesh is None:
            raise ValueError(
                f"the mesh {self.shape} is abstract (no device_mesh): it "
                f"serves the sharding resolver and has no process group; "
                f"build it with launch.mesh under a process group of "
                f"{self.size} ranks to run on it")
        if len(self.axes) == 1:
            return self.device_mesh.get_group()
        return dist.group.WORLD


def abstract_mesh(sizes: Sequence[int], names: Sequence[str]) -> Mesh:
    """A mesh of ``sizes`` ranks along ``names`` with no process group and
    no device: the resolver's counterpart of the reference's
    ``abstract_mesh``."""
    return Mesh(tuple(zip(names, sizes)), torch.device("meta"))


# --------------------------------------------------------------------------
# The logical-axis resolver
# --------------------------------------------------------------------------
# Candidate mesh axes per logical axis name, in priority order. Each
# candidate is a tuple of mesh axis names (jointly assigned to the dim).
RULES: dict = {
    "batch":     [("pod", "data"), ("data",), ("pod",)],
    "island":    [("pod", "data"), ("data",), ("pod",)],
    "vocab":     [("model",)],
    "mlp":       [("model",)],
    "heads":     [("model",)],
    "kv_heads":  [("model",)],
    "expert":    [("model",)],
    "ssm_inner": [("model",)],
    "ssm_heads": [("model",)],
    "kv_seq":    [("model",)],     # decode KV caches: flash-decoding layout
    # replicated by default:
    "embed": [], "head_dim": [], "seq": [], "lora": [], "rope_dim": [],
    "ssm_state": [], "conv_k": [], "expert_in": [], "ssm_groups": [],
    "layers": [], "enc_seq": [], "stats": [],
}

# logical dims eligible for the tensor-parallel fallback
_TP_FALLBACK = ("embed",)
_FSDP_CANDIDATES = [("pod", "data"), ("data",), ("pod",)]
_FSDP_MIN_SIZE = 1 << 20    # params smaller than 1M elements stay replicated


class Spec(tuple):
    """One entry a tensor dim: None (replicated), a mesh axis name, or a
    tuple of names sharding the dim jointly, major to minor (the
    reference's ``PartitionSpec``)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"Spec{tuple.__repr__(self)}"


def _axes_fit(mesh: Mesh, cand: Tuple[str, ...], dim: int,
              used: set) -> bool:
    if any(a not in mesh.shape or a in used for a in cand):
        return False
    prod = math.prod(mesh.shape[a] for a in cand)
    return prod > 1 and dim % prod == 0


def logical_to_spec(axes: Sequence[Optional[str]], shape: Sequence[int],
                    mesh: Mesh, fsdp: bool = False) -> Spec:
    """The spec of a tensor of ``shape`` whose dims carry the logical names
    ``axes``, on ``mesh``, under the active overrides (``use_mesh``)."""
    if len(axes) != len(shape):
        raise ValueError(f"axes {tuple(axes)} and shape {tuple(shape)} "
                         f"differ in rank")
    overrides = dict(active_overrides())
    rules = {**RULES, **overrides}
    used: set = set()
    assignment: list = [None] * len(axes)
    for i, (name, dim) in enumerate(zip(axes, shape)):
        if name is None:
            continue
        for cand in rules.get(name, []):
            if _axes_fit(mesh, cand, dim, used):
                assignment[i] = cand if len(cand) > 1 else cand[0]
                used.update(cand)
                break
    # tensor-parallel fallback: big weight with no model axis -> shard embed
    # (suppressed when an override disables TP, e.g. pure-DP small models)
    if not overrides.get("__no_tp_fallback__") and "model" in mesh.shape \
            and "model" not in used and len(shape) >= 2:
        for i, (name, dim) in enumerate(zip(axes, shape)):
            if name in _TP_FALLBACK and assignment[i] is None \
                    and _axes_fit(mesh, ("model",), dim, used):
                assignment[i] = "model"
                used.add("model")
                break
    # FSDP pass: shard the largest remaining dim over the data axes
    if fsdp and math.prod(shape) >= _FSDP_MIN_SIZE:
        for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
            if assignment[i] is not None or axes[i] == "layers":
                continue
            cand = next((c for c in _FSDP_CANDIDATES
                         if _axes_fit(mesh, c, shape[i], used)), None)
            if cand is not None:
                assignment[i] = cand if len(cand) > 1 else cand[0]
                used.update(cand)
                break
    return Spec(*assignment)


def spec_to_placements(spec: Sequence, mesh: Mesh) -> tuple:
    """``spec`` as ``torch.distributed.tensor`` placements, one a mesh dim:
    ``Shard(i)`` on each mesh dim that tensor dim i is split over, else
    ``Replicate()``. A tuple entry shards its dim over several mesh dims;
    DTensor splits a dim over its mesh dims in mesh order, major first, so
    the tuple must name them in that order, as JAX's major-to-minor tuples
    do."""
    from torch.distributed.tensor import Replicate, Shard
    names = [name for name, _ in mesh.axes]
    out: list = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        group = (entry,) if isinstance(entry, str) else tuple(entry)
        if any(a not in names for a in group):
            raise ValueError(f"spec {tuple(spec)} names an axis not in the "
                             f"mesh {mesh.shape}")
        idx = [names.index(a) for a in group]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in the mesh's "
                             f"major-to-minor order {tuple(names)}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"spec {tuple(spec)} uses mesh axis "
                                 f"{names[i]!r} twice")
            out[i] = Shard(dim)
    return tuple(out)


def _is_shape(x) -> bool:
    return isinstance(x, torch.Size) or (
        type(x) is tuple and all(isinstance(d, int) for d in x))


def _map_leaves(fn, tree, axes):
    """``fn(leaf, axes)`` over a tree of tensors or shapes (dicts, lists,
    NamedTuples, tuples) and its logical-axes tree; None leaves stay
    None."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor) or _is_shape(tree):
        return fn(tree, axes)
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v, None if axes is None else axes[k])
                for k, v in tree.items()}
    subs = [_map_leaves(fn, t, None if axes is None else a)
            for t, a in zip(tree, axes if axes is not None
                            else [None] * len(tree))]
    return type(tree)(*subs) if hasattr(tree, "_fields") \
        else type(tree)(subs)


def tree_shardings(tree, axes_tree, mesh: Mesh, fsdp: bool = False):
    """(tree of meta tensors or shapes, logical-axes tree) -> the tree of
    each leaf's placements on ``mesh``. A leaf without axes (None, or ()
    on a tensor of rank > 0) is replicated."""
    def f(leaf, axes):
        shape = tuple(leaf.shape) if isinstance(leaf, torch.Tensor) \
            else tuple(leaf)
        if axes is None or (tuple(axes) == () and shape):
            axes = (None,) * len(shape)
        return spec_to_placements(logical_to_spec(axes, shape, mesh, fsdp),
                                  mesh)
    return _map_leaves(f, tree, axes_tree)


# --------------------------------------------------------------------------
# Activation constraints via an ambient mesh (+ per-arch rule overrides)
# --------------------------------------------------------------------------
_AMBIENT = threading.local()


def _stack() -> list:
    if not hasattr(_AMBIENT, "stack"):
        _AMBIENT.stack = [(None, ())]
    return _AMBIENT.stack


class use_mesh:
    """Context manager installing a mesh (and optional per-arch
    logical-rule overrides, e.g. smollm's pure-DP mapping) for
    ``logical_to_spec`` and ``constrain``. The ambient mesh is per thread:
    the scheduler's threads do not see each other's."""

    def __init__(self, mesh: Optional[Mesh], overrides=()):
        self.mesh = mesh
        self.overrides = tuple(overrides)

    def __enter__(self):
        _stack().append((self.mesh, self.overrides))
        return self.mesh

    def __exit__(self, *exc):
        _stack().pop()


def active_mesh() -> Optional[Mesh]:
    return _stack()[-1][0]


def active_overrides():
    return _stack()[-1][1]


def constrain(x, logical_axes: Sequence[Optional[str]]):
    """Redistribute a ``DTensor`` on the active mesh to the placements its
    logical axes resolve to. A plain tensor (each rank's whole copy) comes
    back unchanged, and so does anything under no mesh or a one-rank mesh:
    the reference's constraint is a no-op there."""
    mesh = active_mesh()
    if mesh is None or mesh.size <= 1:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    if mesh.device_mesh is None or x.device_mesh != mesh.device_mesh:
        raise ValueError(f"constrain: the DTensor lives on "
                         f"{x.device_mesh}, the active mesh is {mesh.shape}")
    return x.redistribute(mesh.device_mesh, spec_to_placements(
        logical_to_spec(logical_axes, x.shape, mesh), mesh))


def mesh_group(mesh) -> Tuple[Optional[Any], int, int]:
    """(group, ranks, this rank's index) of a ``Mesh``, a process group or
    None; None and one-rank meshes give (None, 1, 0)."""
    if mesh is None:
        return None, 1, 0
    group = mesh.group if isinstance(mesh, Mesh) else mesh
    if group is None:
        return None, 1, 0
    n = dist.get_world_size(group)
    return (group, n, dist.get_rank(group)) if n > 1 else (None, 1, 0)


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) concatenated along dim 0 in rank
    order. Bool tensors travel as uint8."""
    n = dist.get_world_size(group)
    src = x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()
    out = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(out, src, group=group)
    cat = torch.cat(out)
    return cat.to(torch.bool) if x.dtype == torch.bool else cat


class RowBlock(NamedTuple):
    """One rank's rows of a row-sharded dominance bitmap: ``words`` are rows
    ``row0 .. row0 + len(words)`` of the (N, W) bitmap; ``group`` is the
    process group whose ranks hold the other blocks."""
    words: torch.Tensor
    row0: int
    group: Any


def _ceil_to(n: int, mult: int) -> int:
    return -(-n // mult) * mult


def sharded_dominance_pass(objectives, groups=None, *, mesh=None):
    """Row-block-parallel fused dominance sweep over the ranks of ``mesh``
    (a ``Mesh``, a process group, or None).

    Each rank runs B2 on a contiguous block of rows against every row
    (objectives replicated, so the O(N^2) work splits evenly), then:

    - counts: each rank scatters its block's counts into a zero-padded
      full-length vector, and an ``all_reduce(SUM)`` leaves the whole
      counts on every rank (front peeling needs them whole);
    - bitmap: stays sharded by rows, returned as this rank's ``RowBlock``;
      ``nsga2.nondominated_ranks`` peels fronts shard-wise from it.

    Any N shards: N pads to the next multiple of ``ranks * 32`` with +BIG
    rows in group -1, which never dominate a real row nor set one of its
    bits, and the outputs slice back to N. With no process group or one
    rank this is exactly ``ops.dominance_pass`` (counts and a plain
    bitmap): a drop-in ``pass_fn`` for ``nondominated_ranks`` either way.
    """
    group, n_shards, shard = mesh_group(mesh)
    if n_shards <= 1 or objectives.dim() != 2:
        return kops.dominance_pass(objectives, groups=groups)
    n = objectives.shape[0]
    dev = objectives.device
    g = (groups if groups is not None
         else torch.zeros((n,), dtype=torch.int32, device=dev)
         ).to(torch.int32)
    obj = objectives.to(torch.float32)
    n_p = _ceil_to(n, n_shards * 32)
    if n_p != n:
        obj = torch.cat([obj, obj.new_full((n_p - n, obj.shape[1]), BIG)])
        g = torch.cat([g, g.new_full((n_p - n,), -1)])
    rows = n_p // n_shards
    row0 = shard * rows
    cnt, bm = kops.dominance_pass(obj[row0:row0 + rows], obj,
                                  groups=g[row0:row0 + rows], groups_cols=g)
    full = torch.zeros((n_p,), dtype=torch.int32, device=dev)
    full[row0:row0 + rows] = cnt
    dist.all_reduce(full, op=dist.ReduceOp.SUM, group=group)
    # pad columns land in the sliced-off words or as zero bits of the last
    # kept word; pad rows are dropped
    kept = max(0, min(rows, n - row0))
    words = bm[:kept, :_ceil_to(n, 32) // 32]
    return full[:n], RowBlock(words, row0, group)

