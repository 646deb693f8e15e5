"""Python wrappers of the Pareto-dominance CUDA kernels
(``csrc/dominance.cu``): the fused ``dominance_pass`` (counts + packed
bitmap, with same-group masking) and the counts-only ``dominated_counts``.

The wrappers take CUDA tensors only and launch their kernel or raise; the CPU
path is ``ref.dominance_pass_ref`` / ``ref.dominated_counts_ref``, chosen by
``kernels.ops``. Each wrapper counts its launches in ``<fn>.launches``.
The bitmap is int32 words carrying the reference's u32 bits (see ref.py).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

_ARGTYPES = {
    "dominance_pass_launch": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                             + [ctypes.c_void_p] * 3,
    "dominated_counts_launch": [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                ctypes.c_void_p, ctypes.c_void_p],
}


@functools.cache
def _launcher(name):
    lib = build.load("dominance")
    fn = getattr(lib, name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return lib, fn


def _check_objectives(name, x, device, m=None):
    if x.device != device or x.dtype != torch.float32 or x.dim() != 2 \
            or not x.is_contiguous() or (m is not None and x.shape[1] != m):
        raise ValueError(f"{name} must be contiguous f32 (N, M) on {device}, "
                         f"got {x.dtype} {tuple(x.shape)} on {x.device}")


def _check_groups(name, g, n, device):
    if g is None:
        return 0
    if g.device != device or g.dtype != torch.int32 or tuple(g.shape) != (n,) \
            or not g.is_contiguous():
        raise ValueError(f"{name} must be contiguous int32 ({n},) on "
                         f"{device}, got {g.dtype} {tuple(g.shape)} on "
                         f"{g.device}")
    return g.data_ptr()


def _require_cuda(x, what):
    if x.device.type != "cuda":
        raise ValueError(f"{what} kernel needs CUDA tensors, got {x.device}")


def dominance_pass(rows, cols=None, groups=None, groups_cols=None):
    """One fused O(Ni*Nj) sweep of ``rows`` (candidates) against ``cols``
    (potential dominators); ``cols=None`` is the square self-sweep. Group
    ids (int32) restrict dominance to same-group pairs; a missing side is
    group 0. Returns (counts (Ni,) i32, bitmap (Ni, ceil(Nj/32)) int32)."""
    _require_cuda(rows, "dominance_pass")
    if cols is None:
        cols, groups_cols = rows, groups
    dev = rows.device
    _check_objectives("rows", rows, dev)
    _check_objectives("cols", cols, dev, rows.shape[1])
    ni, m = rows.shape
    nj = cols.shape[0]
    g_rows = _check_groups("groups", groups, ni, dev)
    g_cols = _check_groups("groups_cols", groups_cols, nj, dev)
    counts = torch.empty((ni,), dtype=torch.int32, device=dev)
    bitmap = torch.empty((ni, -(-nj // 32)), dtype=torch.int32, device=dev)
    lib, fn = _launcher("dominance_pass_launch")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(rows.data_ptr(), cols.data_ptr(), g_rows, g_cols, ni, nj, m,
                 counts.data_ptr(), bitmap.data_ptr(), stream)
    build.check(lib, err, "dominance_pass launch")
    build.count_launch(dominance_pass)
    return counts, bitmap


def dominated_counts(objectives):
    """(N, M) f32 CUDA (inactive rows pre-masked to +BIG) -> (N,) i32
    dominated counts."""
    _require_cuda(objectives, "dominated_counts")
    _check_objectives("objectives", objectives, objectives.device)
    n, m = objectives.shape
    counts = torch.empty((n,), dtype=torch.int32, device=objectives.device)
    lib, fn = _launcher("dominated_counts_launch")
    with torch.cuda.device(objectives.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(objectives.data_ptr(), n, m, counts.data_ptr(), stream)
    build.check(lib, err, "dominated_counts launch")
    build.count_launch(dominated_counts)
    return counts


dominance_pass.launches = 0
dominated_counts.launches = 0
