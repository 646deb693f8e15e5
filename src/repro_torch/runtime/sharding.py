"""The ranks a run spans, and the row-sharded Pareto-dominance sweep over
them, ported from ``repro.runtime.sharding`` (``sharded_dominance_pass``).

A ``Mesh`` names the ranks of a ``torch.distributed`` process group by axis
(``("data",)`` or ``("pod", "data")``, built by ``launch.mesh``) and this
rank's device. Every function that spreads work over ranks takes the mesh
(or a process group) as an argument: there is no ambient mesh. The
reference's logical-axis resolver (``RULES``, ``logical_to_spec``,
``tree_shardings``, ``constrain``) and its ambient ``use_mesh`` serve the
LM zoo and are not ported here.

Collectives are ``all_reduce``, ``all_gather``, ``broadcast`` and
``barrier`` only: gloo takes CUDA tensors for all four, so two ranks on one
card (gloo) run the same code as one rank per card (NCCL).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.kernels import ops as kops

BIG = 3.0e38        # the reference's pad value (repro.kernels.dominance.BIG)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``axes`` ((name, size), ...) over the ranks of the default process
    group, row-major, rank r at flat position r; ``device`` is this rank's
    device; ``device_mesh`` the torch ``DeviceMesh`` over those ranks, None
    for the one-rank mesh of a process without a process group."""
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
        """The process group of all the mesh's ranks (None for one rank)."""
        if self.size <= 1:
            return None
        if len(self.axes) == 1:
            return self.device_mesh.get_group()
        return dist.group.WORLD


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

