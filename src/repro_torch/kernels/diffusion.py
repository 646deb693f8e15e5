"""Python wrapper of the fused diffuse+evaporate CUDA kernel
(``csrc/diffusion.cu``), the per-tick hot spot of the ants model.

The wrapper takes CUDA tensors only and launches the kernel or raises; the
CPU path is ``ref.diffuse_evaporate_ref``, chosen by ``kernels.ops``.
``diffuse_evaporate.launches`` counts the launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

MAX_WORLD = 238      # W*W*4 B must fit one block's 227 KB of shared memory

@functools.cache
def _launcher():
    lib = build.load("diffusion")
    fn = lib.diffuse_evaporate_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
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
    with torch.cuda.device(chem.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(chem.data_ptr(), rate.data_ptr(), evap.data_ptr(),
                 out.data_ptr(), n, w, stream)
    build.check(lib, err, "diffuse_evaporate launch")
    build.count_launch(diffuse_evaporate)
    return out


diffuse_evaporate.launches = 0
