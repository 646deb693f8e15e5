"""Python wrapper of the blocked triangular-solve CUDA kernels
(``csrc/trisolve.cu``): the diagonal-tile inverses, then the forward
(L X = B) or backward (L^T X = B) solve.

The wrapper takes CUDA tensors only and launches the kernels or raises; the
CPU path is ``ref.tri_solve_blocked_ref``, chosen by ``kernels.ops``, which
also pads to the reference's tile multiples. ``tri_solve_blocked.launches``
counts the calls that launched.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

TILE = 64            # the kernel's internal tile edge


@functools.cache
def _launcher():
    lib = build.load("trisolve")
    fn = lib.tri_solve_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    return lib, fn


def tri_solve_blocked(l: torch.Tensor, b: torch.Tensor, *,
                      trans: bool = False) -> torch.Tensor:
    """L (n_p, n_p) lower triangular, B (n_p, m_p), contiguous f32 CUDA with
    n_p and m_p multiples of 64 -> X (n_p, m_p) with L X = B, or L^T X = B
    when ``trans``."""
    if l.device.type != "cuda":
        raise ValueError(f"tri_solve kernel needs CUDA tensors, got "
                         f"{l.device}")
    n = l.shape[0]
    if l.dim() != 2 or l.shape[1] != n or b.dim() != 2 or b.shape[0] != n \
            or n % TILE or b.shape[1] % TILE:
        raise ValueError(f"need L (n, n) and B (n, m) with n, m multiples "
                         f"of {TILE}, got {tuple(l.shape)} and "
                         f"{tuple(b.shape)}")
    for name, t in (("L", l), ("B", b)):
        if t.dtype != torch.float32 or not t.is_contiguous() \
                or t.device != l.device:
            raise ValueError(f"{name} must be contiguous f32 on {l.device}, "
                             f"got {t.dtype} on {t.device} with strides "
                             f"{t.stride()}")
    m = b.shape[1]
    linv = torch.empty((n // TILE, TILE, TILE), dtype=torch.float32,
                       device=l.device)
    x = torch.empty_like(b)
    lib, fn = _launcher()
    with torch.cuda.device(l.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(l.data_ptr(), b.data_ptr(), n, m, int(bool(trans)),
                 linv.data_ptr(), x.data_ptr(), stream)
    build.check(lib, err, "tri_solve launch")
    build.count_launch(tri_solve_blocked)
    return x


tri_solve_blocked.launches = 0
