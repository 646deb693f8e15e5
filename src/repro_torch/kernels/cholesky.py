"""Python wrappers of the blocked Cholesky CUDA kernels: the blocked
factorization (``chol_blocked``, B5) and the same factorization with the GP
covariance assembled inside it (``gp_chol_blocked``, B6), both in
``csrc/cholesky.cu``; and the blocked triangular solve
(``tri_solve_blocked``, B7, ``csrc/trisolve.cu``): the diagonal-tile
inverses, then the forward (L X = B) or backward (L^T X = B) solve.

The wrappers take CUDA tensors only and launch the kernels or raise; the CPU
path is ``ref.chol_blocked_ref`` / ``ref.gp_chol_blocked_ref`` /
``ref.tri_solve_blocked_ref``, chosen by ``kernels.ops``, which also pads to
the reference's tile multiples. Each wrapper counts the calls that launched
in ``<fn>.launches`` (one per call, however many kernels the call runs).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.gp import KINDS, MAX_DIM

TILE = 64            # the kernels' internal tile edge


@functools.cache
def _launcher():
    lib = build.load("trisolve")
    fn = lib.tri_solve_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    return lib, fn


@functools.cache
def _chol_launchers():
    lib = build.load("cholesky")
    chol = lib.chol_launch
    chol.argtypes = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
    chol.restype = ctypes.c_int
    gp_chol = lib.gp_chol_launch
    gp_chol.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4 \
        + [ctypes.c_float] * 2 + [ctypes.c_void_p] * 3
    gp_chol.restype = ctypes.c_int
    return lib, chol, gp_chol


def _check_input(name, t, rows, cols):
    """Raise unless ``t`` is a contiguous f32 CUDA (rows, cols) tensor with
    ``rows`` a multiple of the tile edge (``cols`` None: any width)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} kernel needs CUDA tensors, got {t.device}")
    if t.dtype != torch.float32 or not t.is_contiguous() or t.dim() != 2 \
            or t.shape[0] != rows or (cols is not None and t.shape[1] != cols):
        raise ValueError(f"{name} needs a contiguous f32 ({rows}, "
                         f"{cols or 'd'}) tensor, got {t.dtype} "
                         f"{tuple(t.shape)} with strides {t.stride()}")
    if rows % TILE:
        raise ValueError(f"{name} needs n_p a multiple of {TILE}, got {rows}")


def _factor_buffers(n_p, device):
    out = torch.empty((n_p, n_p), dtype=torch.float32, device=device)
    linv = torch.empty((TILE, TILE), dtype=torch.float32, device=device)
    return out, linv


def chol_blocked(a: torch.Tensor) -> torch.Tensor:
    """a (n_p, n_p) contiguous f32 CUDA, symmetric positive definite (only
    its lower triangle is read), n_p a multiple of 64, identity-padded past
    the true size -> its lower Cholesky factor L (n_p, n_p), upper triangle
    zero. A pivot at or below 1e-30 is taken as 1e-30, as the plain
    version does: no error for a matrix that is not positive definite."""
    n_p = a.shape[0] if a.dim() == 2 else -1
    _check_input("chol_blocked", a, n_p, n_p)
    out, linv = _factor_buffers(n_p, a.device)
    lib, fn, _ = _chol_launchers()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(a.data_ptr(), n_p, out.data_ptr(), linv.data_ptr(), stream)
    build.check(lib, err, "chol_blocked launch")
    build.count_launch(chol_blocked)
    return out


def gp_chol_blocked(x: torch.Tensor, n: int, *, kind: str,
                    lengthscale: float, nugget: float) -> torch.Tensor:
    """Fused covariance assembly and factorization: x (n_p, d) contiguous
    f32 CUDA points (rows past the true count ``n`` zero), n_p a multiple of
    64, d <= 32 -> the lower Cholesky factor of K(x, x) + nugget I (``kind``
    "matern52" or "rbf", variance 1) with identity past n. The unfactored K
    is never written to device memory."""
    n_p = x.shape[0] if x.dim() == 2 else -1
    _check_input("gp_chol_blocked", x, n_p, None)
    d = x.shape[1]
    if not 1 <= d <= MAX_DIM:
        raise ValueError(f"feature dim {d} outside 1..{MAX_DIM}")
    if not 0 <= n <= n_p:
        raise ValueError(f"true size n = {n} outside 0..{n_p}")
    if kind not in ("matern52", "rbf"):
        raise ValueError(f"unknown GP kernel kind: {kind}")
    out, linv = _factor_buffers(n_p, x.device)
    lib, _, fn = _chol_launchers()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), n_p, int(n), d, KINDS[kind],
                 float(lengthscale), float(nugget), out.data_ptr(),
                 linv.data_ptr(), stream)
    build.check(lib, err, "gp_chol_blocked launch")
    build.count_launch(gp_chol_blocked)
    return out


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


chol_blocked.launches = 0
gp_chol_blocked.launches = 0
tri_solve_blocked.launches = 0
