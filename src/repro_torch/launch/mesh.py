"""Process groups and meshes for runs that span several ranks, ported from
``repro.launch.mesh``.

Functions, not module constants: importing this module touches no device
and no process group.

    # one process per card under torchrun (NCCL)
    torchrun --nproc-per-node 4 -m repro_torch.launch.explore \\
        --distributed --mesh data=4 --out /tmp/ants_mesh

A mesh's axes are ``("data",)`` or ``("pod", "data")`` over the ranks of the
default process group; rank r runs on ``cuda:{local rank % cards}`` (on the
CPU: ``cpu``). Without a process group the mesh has one rank and the run is
the single-device run. The production meshes (``make_production_mesh``)
add a ``"model"`` axis: 16 x 16 ranks, or 2 x 16 x 16 over two pods; a
one-process check of their layouts runs them on the ``"fake"`` backend
(``torch.testing._internal.distributed.fake_pg.FakeStore``).
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from repro_torch.runtime.device import resolve_device
from repro_torch.runtime.sharding import Mesh


def init_distributed(*, coordinator: str = None, num_processes: int = None,
                     process_id: int = None, force: bool = False,
                     backend: str = None) -> bool:
    """``torch.distributed.init_process_group`` for the multi-process entry
    path (``launch/explore.py --distributed``). At ``tcp://{coordinator}``
    with ``num_processes`` ranks, this one ``process_id``; with ``force``
    and no other argument, through ``env://`` (the variables ``torchrun``
    sets). A no-op returning False when no argument is given and ``force``
    is not set, so single-process launchers call it unconditionally.
    ``backend`` defaults to NCCL where CUDA is available and gloo where it
    is not; a caller that wants gloo on the card (two ranks on one card)
    passes it."""
    if not force and coordinator is None and num_processes is None \
            and process_id is None:
        return False
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if coordinator is None and num_processes is None and process_id is None:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator}",
            world_size=num_processes, rank=process_id)
    return True


def local_device(device="cuda") -> torch.device:
    """This rank's device. Without a process group, ``device`` as given
    (``cuda:1`` stays card 1, the current device is left alone). In one,
    ``cuda:{local rank % cards}`` (the local rank from ``LOCAL_RANK``, else
    the global rank), made the current CUDA device; a ``device`` naming
    another card raises. ``cpu`` for a CPU run."""
    dev = resolve_device(device)
    if dev.type != "cuda" or not dist.is_initialized():
        return dev
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    mine = torch.device("cuda", local % torch.cuda.device_count())
    if dev.index is not None and dev.index != mine.index:
        raise ValueError(f"device {device!r}, but this rank (local rank "
                         f"{local}) runs on {mine}")
    torch.cuda.set_device(mine)
    return mine


def _mesh(shape, names, device) -> Mesh:
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = 1
    for s in shape:
        n *= s
    if n != world:
        hint = (f"start {n} ranks (torchrun --nproc-per-node {n} ... "
                f"--distributed, or --distributed --coordinator HOST:PORT "
                f"--num-processes {n} --process-id I)")
        raise ValueError(
            f"a mesh of {dict(zip(names, shape))} needs {n} ranks, this "
            f"process group has {world}: {hint}")
    dev = local_device(device)
    if not dist.is_initialized():
        return Mesh(tuple(zip(names, shape)), dev)
    from torch.distributed.device_mesh import init_device_mesh
    dm = init_device_mesh(dev.type, tuple(shape), mesh_dim_names=names)
    return Mesh(tuple(zip(names, shape)), dev, dm)


def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> Mesh:
    """``("data", "model")`` over 16 x 16 ranks, or ``("pod", "data",
    "model")`` over 2 x 16 x 16 with ``multi_pod``; raises, with the hint
    of how to start them, in a process group of another size."""
    if multi_pod:
        return _mesh((2, 16, 16), ("pod", "data", "model"), device)
    return _mesh((16, 16), ("data", "model"), device)


def make_host_mesh(device="cuda") -> Mesh:
    """Every rank of the process group (one without one) as a 1-D
    ``"data"`` mesh."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    return _mesh((world,), ("data",), device)


def make_island_mesh(pod: int = 1, data: int = 0, device="cuda") -> Mesh:
    """The island-evolution mesh: ``("data",)``, or ``("pod", "data")`` when
    ``pod > 1``. ``data=0`` spreads every rank over the data axis (after
    ``pod`` of them); ``pod * data`` must be the process group's size."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    pod = max(pod, 1)
    if data <= 0:
        if world % pod:
            raise ValueError(f"pod={pod} does not divide {world} ranks")
        data = world // pod
    if pod > 1:
        return _mesh((pod, data), ("pod", "data"), device)
    return _mesh((data,), ("data",), device)


# NVIDIA H100 80GB HBM3 (SXM) at a 700 W power limit, as nvidia-smi prints
# it ("NVIDIA H100 80GB HBM3, 700.00 W"): the roofline denominators of one
# card. A card set below 700 W runs slower under load.
PEAK_FLOPS_BF16 = 989e12        # dense tensor-core FLOP/s (data sheet)
HBM_BW = 3.35e12                # bytes/s of device memory (data sheet)
NVLINK_BW = 900e9               # bytes/s to the other cards of the host,
                                # both directions together (data sheet)
HBM_BYTES = 85_017_493_504      # torch.cuda.get_device_properties(0)
                                # .total_memory on such a card
