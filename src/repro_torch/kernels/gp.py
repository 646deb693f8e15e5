"""Python wrappers of the GP covariance-assembly CUDA kernel
(``csrc/gp.cu``): ``gp_sqdist`` (squared distances) and ``gp_matrix``
(distances mapped through the Matérn-5/2 or RBF covariance for fixed
hyper-parameters), one kernel with three epilogues.

The wrappers take CUDA tensors only and launch the kernel or raise; the CPU
path is ``ref.gp_sqdist_ref`` / ``ref.gp_matrix_ref``, chosen by
``kernels.ops``. Each wrapper counts its launches in ``<fn>.launches``.

A block writes ``TILE_COLS`` columns (4 adjacent ones a thread) of up to
``MAX_ROWS`` rows; ``launch_config`` chooses the rows a block takes from the
shape, the card's SM count and the kernel's occupancy (queried once per
kernel and device).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import re

import torch

from repro_torch.kernels import build

MAX_DIM = 32                     # feature dims a tile stages (genome dims)
KINDS = {"sqdist": 0, "matern52": 1, "rbf": 2}
THREADS = 128                    # csrc/gp.cu: kGpThreads
VEC = 4                          # adjacent output columns a thread
TILE_COLS = THREADS * VEC        # output columns a block
MAX_ROWS = 64                    # output rows a block at most
REGISTER_DIMS = (2, 8)           # feature dims whose kernels keep x2 in
                                 # registers; any other d the generic one
ROW_COST = 2                     # a block's fixed cost (staging its rows and
                                 # norms), in rows of its loop


@dataclasses.dataclass(frozen=True)
class LaunchConfig:
    col_tiles: int     # blocks along the columns (grid x)
    row_groups: int    # blocks along the rows (grid y)
    rows: int          # rows a block takes (the last group may take fewer)

    @property
    def grid(self) -> tuple:
        return (self.col_tiles, self.row_groups)


@functools.lru_cache(maxsize=1024)
def launch_config(n1: int, n2: int, sms: int, per_sm: int) -> LaunchConfig:
    """The launch of an (n1, n2) assembly on a card of ``sms`` SMs that
    holds ``per_sm`` blocks of the kernel an SM: the rows a block takes
    minimise (waves of the grid) x (rows + ROW_COST); ties go to more rows
    a block (fewer blocks)."""
    col_tiles = -(-n2 // TILE_COLS)
    if n1 <= 0 or n2 <= 0:
        return LaunchConfig(col_tiles, 0, 1)
    slots = max(1, sms * per_sm)
    best = None
    for rows in range(1, min(MAX_ROWS, n1) + 1):
        groups = -(-n1 // rows)
        cost = -(-col_tiles * groups // slots) * (rows + ROW_COST)
        if best is None or cost <= best[0]:
            best = (cost, rows, groups)
    _, rows, groups = best
    return LaunchConfig(col_tiles, groups, rows)


@functools.cache
def _library():
    lib = build.load("gp")
    lib.gp_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p] \
        + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_float,
                                ctypes.c_void_p, ctypes.c_void_p]
    lib.gp_launch.restype = ctypes.c_int
    lib.gp_blocks_per_sm.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.gp_blocks_per_sm.restype = ctypes.c_int
    return lib


@functools.cache
def blocks_per_sm(index: int, d: int, kind: int, vec: bool) -> int:
    """Blocks of the kernel that (d, kind, n2 % 4 == 0) launches resident
    on one SM of CUDA device ``index`` (the runtime's occupancy query, made
    once per kernel and device)."""
    lib = _library()
    blocks = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = lib.gp_blocks_per_sm(d, kind, int(vec),
                                   ctypes.addressof(blocks))
    build.check(lib, err, "gp occupancy query")
    return blocks.value


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
    index = x1.device.index
    cfg = launch_config(n1, n2, build.sm_count(index),
                        blocks_per_sm(index, d, KINDS[kind], n2 % VEC == 0))
    lib = _library()
    with torch.cuda.device(x1.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gp_launch(x1.data_ptr(), x2.data_ptr(), n1, n2, d,
                            KINDS[kind], cfg.rows, float(lengthscale),
                            float(variance), out.data_ptr(), stream)
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


def kernel_name(mangled: str):
    """``gp_kernel<D,kind,store>`` of a mangled kernel name of gp.cu (D
    "any" for the generic kernel; store "vec4" or "scalar"), or None."""
    m = re.search(r"gp_kernelILi(\d+)ELi(\d)ELb([01])E", mangled)
    if m is None:
        return None
    kind = {v: k for k, v in KINDS.items()}[int(m.group(2))]
    d = "any" if m.group(1) == "0" else m.group(1)
    return f"gp_kernel<{d},{kind},{'vec4' if m.group(3) == '1' else 'scalar'}>"


def kernel_name_for(d: int, kind: str, n2: int) -> str:
    """The name (as ``kernel_name`` gives it) of the kernel that a call
    with feature dim ``d``, epilogue ``kind`` and ``n2`` columns runs."""
    if d not in REGISTER_DIMS:
        return f"gp_kernel<any,{kind},scalar>"
    return f"gp_kernel<{d},{kind},{'vec4' if n2 % VEC == 0 else 'scalar'}>"


KERNEL_NAMES = frozenset(
    f"gp_kernel<{d},{kind},{store}>" for kind in KINDS
    for d, store in [(str(d), s) for d in REGISTER_DIMS
                     for s in ("vec4", "scalar")] + [("any", "scalar")])


def row_loop_instructions(sass_text: str) -> dict:
    """{mangled kernel name: SASS instructions of its row loop} from a
    ``cuobjdump -sass`` listing: the span of the widest backward branch of
    each function (the loop's back edge to its head), both ends included.
    One trip of the loop writes 4 outputs a thread, so a quarter of the
    count is the instructions a thread issues an output at most: the span
    also holds the IEEE division's and square root's calls to their slow
    paths, which the common case branches over."""
    out = {}
    name, instrs = None, []

    def finish():
        spans = [(addr - target, target, addr) for addr, target in
                 ((a, t) for a, t in instrs if t is not None and t < a)]
        if name is not None and spans:
            _, lo, hi = max(spans)
            out[name] = sum(1 for a, _ in instrs if lo <= a <= hi)

    for line in sass_text.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            finish()
            name, instrs = m.group(1), []
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m and name is not None:
            br = re.search(r"\bBRA(?:\.\w+)*\s+(?:`?\(?)(0x[0-9a-f]+)",
                           m.group(2))
            instrs.append((int(m.group(1), 16),
                           int(br.group(1), 16) if br else None))
    finish()
    return out


gp_sqdist.launches = 0
gp_matrix.launches = 0
