"""Python wrapper of the fused diffuse+evaporate CUDA kernel
(``csrc/diffusion.cu``), the per-tick hot spot of the ants model.

The wrapper takes CUDA tensors only and launches the kernel or raises; the
CPU path is ``ref.diffuse_evaporate_ref``, chosen by ``kernels.ops``.
``diffuse_evaporate.launches`` counts the launches.

The kernel runs persistent blocks that walk the lanes through a ring of
worlds in shared memory; ``launch_config`` chooses its shape from the
world's size and the card's SM count, and ``route`` how a world moves.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import build

MAX_WORLD = 238      # W*W*4 B must fit one block's 227 KB of shared memory

BAR_BYTES = 128              # csrc/diffusion.cu's kBarBytes
STENCIL_THREADS = 288        # about this many threads walk the stencil
ROUTES = {"bulk": 0, "cp_async": 1}


@dataclasses.dataclass(frozen=True)
class LaunchConfig:
    ring: bool         # two lane worlds and a share buffer, else one world
    bands: int         # bands of rows, one thread per column of each
    threads: int
    smem_bytes: int
    blocks_per_sm: int
    grid: int


def launch_config(n: int, w: int, sms: int) -> LaunchConfig:
    """The persistent launch for ``n`` lanes of (w, w) worlds on a card of
    ``sms`` SMs: a ring of two worlds beside a share buffer where one
    block's shared memory holds the three, else one world; ``bands`` x w
    threads walk the stencil, rounded up to whole warps; as many blocks as
    the SMs hold at once, and no more than there are lanes."""
    if not 1 <= w <= MAX_WORLD:
        raise ValueError(f"world {w}x{w} outside 1..{MAX_WORLD}")
    ring = BAR_BYTES + 3 * w * w * 4 <= build.SMEM_PER_BLOCK
    smem = BAR_BYTES + (3 if ring else 1) * w * w * 4
    bands = max(1, min(w, STENCIL_THREADS // w))
    threads = -(-w * bands // 32) * 32
    per_sm = min(build.SMEM_PER_SM // (smem + build.SMEM_RESERVED),
                 2048 // threads, 32)
    return LaunchConfig(ring, bands, threads, smem, per_sm,
                        min(n, sms * per_sm))


def route(chem: torch.Tensor) -> str:
    """"bulk" when every lane's world is a whole number of 16-byte chunks on
    a 16-byte boundary (W even, the field aligned), else "cp_async"."""
    w = chem.shape[-1]
    return "bulk" if (w * w) % 4 == 0 and chem.data_ptr() % 16 == 0 \
        else "cp_async"


@functools.cache
def _launcher():
    lib = build.load("diffusion")
    fn = lib.diffuse_evaporate_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def diffuse_evaporate(chem: torch.Tensor, rate: torch.Tensor,
                      evap: torch.Tensor) -> torch.Tensor:
    """chem: (N, W, W) f32 CUDA; rate/evap: (N,) f32 fractions in [0, 1]
    on the same device. Returns a new (N, W, W) f32 field."""
    if chem.device.type != "cuda":
        raise ValueError(f"diffuse_evaporate kernel needs CUDA tensors, got "
                         f"{chem.device}")
    if chem.dim() != 3 or chem.shape[1] != chem.shape[2]:
        raise ValueError(f"chem must be (N, W, W), got {tuple(chem.shape)}")
    n, w, _ = chem.shape
    if w > MAX_WORLD:
        raise ValueError(f"world {w}x{w} exceeds one block's shared memory")
    for name, t, shape in (("chem", chem, (n, w, w)), ("rate", rate, (n,)),
                           ("evap", evap, (n,))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape \
                or not t.is_contiguous() or t.device != chem.device:
            raise ValueError(f"{name} must be contiguous f32 {shape} on "
                             f"{chem.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    out = torch.empty_like(chem)
    lib, fn = _launcher()
    cfg = launch_config(n, w, build.sm_count(chem.device.index))
    with torch.cuda.device(chem.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(chem.data_ptr(), rate.data_ptr(), evap.data_ptr(),
                 out.data_ptr(), n, w, ROUTES[route(chem)], int(cfg.ring),
                 cfg.bands, cfg.threads, cfg.grid, stream)
    build.check(lib, err, "diffuse_evaporate launch")
    build.count_launch(diffuse_evaporate)
    return out


diffuse_evaporate.launches = 0
