"""Python wrappers of the blocked Cholesky CUDA kernels: the blocked
factorization (``chol_blocked``, B5) and the same factorization with the GP
covariance assembled inside it (``gp_chol_blocked``, B6), both in
``csrc/cholesky.cu``; and the blocked triangular solve
(``tri_solve_blocked``, B7, ``csrc/trisolve.cu``): L's operands packed with
the diagonal-tile inverses, then the forward (L X = B) or backward
(L^T X = B) solve in strips of B's columns (``solve_strip``).

The wrappers take CUDA tensors only and launch the kernels or raise; the CPU
path is ``ref.chol_blocked_ref`` / ``ref.gp_chol_blocked_ref`` /
``ref.tri_solve_blocked_ref``, chosen by ``kernels.ops``, which also pads to
the reference's tile multiples. Each wrapper counts the calls that launched
in ``<fn>.launches`` (one per call, however many kernels the call runs);
``tri_solve_blocked.launches`` counts the forward solves and
``tri_solve_blocked.backward.launches`` the backward ones.

The factorizations run on the caller's current stream and on a stream of
their own made per call (the step kernels run ahead of the trailing
updates); the caller's stream waits for both before the call returns, so
the result is used on that stream like any other output.
"""
from __future__ import annotations

import ctypes
import functools
import types

import torch

from repro_torch.kernels import build
from repro_torch.kernels.gp import KINDS, MAX_DIM

TILE = 64            # the kernels' internal tile edge
STRIPS = (64, 16)            # csrc/trisolve.cu's strip widths, widest first
SOLVE_STAGES = 3             # its ring of packed 64 x 64 tiles
SOLVE_BAR_BYTES = 128


def solve_smem_bytes(strip: int, resident: int) -> int:
    """Dynamic shared memory of ``csrc/trisolve.cu``'s solve kernel: its
    ring, the B - acc tile, a tile of partial sums or read-back X, and
    ``resident`` solved row blocks of the strip."""
    return SOLVE_BAR_BYTES + 4 * (SOLVE_STAGES * TILE * TILE
                                  + (2 + resident) * TILE * strip)


def solve_resident(n_p: int, strip: int) -> int:
    """Solved row blocks of a strip that shared memory holds, at most all
    n_p / 64 of them."""
    room = build.SMEM_PER_BLOCK - solve_smem_bytes(strip, 0)
    return min(n_p // TILE, room // (4 * TILE * strip))


def solve_strip(n_p: int, m_p: int, sms: int) -> int:
    """Columns of B a block of the solve owns: 64 where that gives every SM
    a strip (m_p / 64 >= sms) and keeps the whole solved panel in shared
    memory; else 16, the most strips."""
    for strip in STRIPS:
        if m_p // strip >= sms and solve_resident(n_p, strip) == n_p // TILE:
            return strip
    return STRIPS[-1]


def pack_tiles(n_p: int) -> int:
    """64 x 64 tiles the solve reads from L: the blocks below the diagonal
    and the diagonal tiles' inverses."""
    nb = n_p // TILE
    return nb * (nb + 1) // 2


@functools.cache
def _launcher():
    lib = build.load("trisolve")
    fn = lib.tri_solve_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 5 \
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


def fast_path_check(device) -> dict:
    """Run ``csrc/cholesky.cu``'s check of its written-out square root and
    division against ``__fsqrt_rn`` and ``__fdiv_rn`` on ``device`` (a CUDA
    device): every non-negative float through the root, 2^26 random pairs
    through the division. -> counts of inputs on each fast path, of those
    unequal to the intrinsic, and of inputs sent to the slow paths."""
    if torch.device(device).type != "cuda":
        raise ValueError(f"fast_path_check runs on a CUDA device, got "
                         f"{device}")
    counts = torch.zeros(6, dtype=torch.int64, device=device)
    lib, _, _ = _chol_launchers()
    lib.chol_fast_path_check.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.chol_fast_path_check.restype = ctypes.c_int
    with torch.cuda.device(counts.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.chol_fast_path_check(counts.data_ptr(), stream)
    build.check(lib, err, "chol_fast_path_check launch")
    keys = ("sqrt_fast", "sqrt_unequal", "div_fast", "div_unequal",
            "sqrt_slow", "div_slow")
    return dict(zip(keys, counts.tolist()))


def chol_phase_cycles(a: torch.Tensor) -> list:
    """``chol_blocked``'s factor of ``a`` with block 0 of each step kernel
    recording its clock (``csrc/cholesky.cu``'s chol_launch_traced) -> per
    step, the SM cycles of its phases: "update" (the diagonal tile's update
    from the step before), "factor" (the diagonal tile's factor, beside
    which warps 4 .. 7 update the panel tile), "panel" (the panel rows'
    substitution), "out" (writing L). A measurement, not counted in
    ``chol_blocked.launches``."""
    n_p = a.shape[0] if a.dim() == 2 else -1
    _check_input("chol_phase_cycles", a, n_p, n_p)
    out, lkk = _factor_buffers(n_p, a.device)
    trace = torch.zeros((n_p // TILE, 8), dtype=torch.int64, device=a.device)
    lib, _, _ = _chol_launchers()
    fn = lib.chol_launch_traced
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(a.data_ptr(), n_p, out.data_ptr(), lkk.data_ptr(),
                 trace.data_ptr(), stream)
    build.check(lib, err, "chol_launch_traced launch")
    t = trace.cpu()
    return [{name: int(t[k, i + 1] - t[k, i])
             for i, name in enumerate(("update", "factor", "panel", "out"))}
            for k in range(t.shape[0])]


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
    """The factor and the 64 x 64 scratch tile that holds a step's
    diagonal factor until the next step moves it into place."""
    out = torch.empty((n_p, n_p), dtype=torch.float32, device=device)
    lkk = torch.empty((TILE, TILE), dtype=torch.float32, device=device)
    return out, lkk


def chol_blocked(a: torch.Tensor) -> torch.Tensor:
    """a (n_p, n_p) contiguous f32 CUDA, symmetric positive definite (only
    its lower triangle is read), n_p a multiple of 64, identity-padded past
    the true size -> its lower Cholesky factor L (n_p, n_p), upper triangle
    zero. A pivot at or below 1e-30 is taken as 1e-30, as the plain
    version does: no error for a matrix that is not positive definite."""
    n_p = a.shape[0] if a.dim() == 2 else -1
    _check_input("chol_blocked", a, n_p, n_p)
    out, lkk = _factor_buffers(n_p, a.device)
    lib, fn, _ = _chol_launchers()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(a.data_ptr(), n_p, out.data_ptr(), lkk.data_ptr(), stream)
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
    out, lkk = _factor_buffers(n_p, x.device)
    lib, _, fn = _chol_launchers()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), n_p, int(n), d, KINDS[kind],
                 float(lengthscale), float(nugget), out.data_ptr(),
                 lkk.data_ptr(), stream)
    build.check(lib, err, "gp_chol_blocked launch")
    build.count_launch(gp_chol_blocked)
    return out


def tri_solve_blocked(l: torch.Tensor, b: torch.Tensor, *,
                      trans: bool = False) -> torch.Tensor:
    """L (n_p, n_p) lower triangular, B (n_p, m_p), contiguous f32 CUDA with
    n_p and m_p multiples of 64 -> X (n_p, m_p) with L X = B, or L^T X = B
    when ``trans``. A B that does not start on a 16-byte boundary (a view
    into a larger tensor) is copied first: the kernel moves 16 bytes at a
    time."""
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
    if b.data_ptr() % 16:
        b = b.clone()
    strip = solve_strip(n, m, build.sm_count(l.device.index))
    pack = torch.empty((pack_tiles(n), TILE, TILE), dtype=torch.float32,
                       device=l.device)
    x = torch.empty_like(b)
    lib, fn = _launcher()
    with torch.cuda.device(l.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(l.data_ptr(), b.data_ptr(), n, m, int(bool(trans)), strip,
                 solve_resident(n, strip), pack.data_ptr(), x.data_ptr(),
                 stream)
    build.check(lib, err, "tri_solve launch")
    build.count_launch(tri_solve_blocked.backward if trans
                       else tri_solve_blocked)
    return x


chol_blocked.launches = 0
gp_chol_blocked.launches = 0
tri_solve_blocked.launches = 0
tri_solve_blocked.backward = types.SimpleNamespace(launches=0)
