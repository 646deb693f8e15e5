"""Python wrappers of the GP covariance-assembly CUDA kernel
(``csrc/gp.cu``): ``gp_sqdist`` (squared distances) and ``gp_matrix``
(distances mapped through the Matérn-5/2 or RBF covariance for fixed
hyper-parameters), one kernel with three epilogues.

The wrappers take CUDA tensors only and launch the kernel or raise; the CPU
path is ``ref.gp_sqdist_ref`` / ``ref.gp_matrix_ref``, chosen by
``kernels.ops``. Each wrapper counts its launches in ``<fn>.launches``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

MAX_DIM = 32                     # feature dims a tile stages (genome dims)
KINDS = {"sqdist": 0, "matern52": 1, "rbf": 2}


@functools.cache
def _launcher():
    lib = build.load("gp")
    fn = lib.gp_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 4 \
        + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def _launch(x1, x2, kind, lengthscale, variance, what):
    if x1.device.type != "cuda":
        raise ValueError(f"{what} kernel needs CUDA tensors, got {x1.device}")
    for name, x in (("x1", x1), ("x2", x2)):
        if x.dtype != torch.float32 or x.dim() != 2 \
                or not x.is_contiguous() or x.device != x1.device \
                or x.shape[1] != x1.shape[1]:
            raise ValueError(f"{name} must be contiguous f32 (N, D) on "
                             f"{x1.device} with x1's D, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    n1, d = x1.shape
    n2 = x2.shape[0]
    if not 1 <= d <= MAX_DIM:
        raise ValueError(f"feature dim {d} outside 1..{MAX_DIM}")
    out = torch.empty((n1, n2), dtype=torch.float32, device=x1.device)
    lib, fn = _launcher()
    with torch.cuda.device(x1.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x1.data_ptr(), x2.data_ptr(), n1, n2, d, KINDS[kind],
                 float(lengthscale), float(variance), out.data_ptr(), stream)
    build.check(lib, err, f"{what} launch")
    return out


def gp_sqdist(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """x1 (N1, D), x2 (N2, D) contiguous f32 CUDA -> (N1, N2) f32 squared
    distances, bitwise equal to ``ref.gp_sqdist_ref`` on the card."""
    out = _launch(x1, x2, "sqdist", 1.0, 1.0, "gp_sqdist")
    build.count_launch(gp_sqdist)
    return out


def gp_matrix(x1: torch.Tensor, x2: torch.Tensor, *, kind="matern52",
              lengthscale=0.2, variance=1.0) -> torch.Tensor:
    """Fused covariance assembly: K[i, j] = k(x1[i], x2[j]) for fixed
    (float) hyper-parameters, ``kind`` "matern52" or "rbf"."""
    if kind not in ("matern52", "rbf"):
        raise ValueError(f"unknown GP kernel kind: {kind}")
    out = _launch(x1, x2, kind, lengthscale, variance, "gp_matrix")
    build.count_launch(gp_matrix)
    return out


gp_sqdist.launches = 0
gp_matrix.launches = 0
