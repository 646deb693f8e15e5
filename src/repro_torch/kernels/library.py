"""B1 and B2 as ``torch.library`` operators, so that a program traced by
``torch.export`` (``core/packaging.py``) or run on fake tensors can hold
them: a ctypes launch is opaque to tracing, an operator with a fake
implementation is not.

- ``repro_torch::diffuse_evaporate(chem, rate, evap) -> chem'``: the CUDA
  implementation is the launcher ``diffusion.diffuse_evaporate`` (B1), the
  CPU one the plain ``ref.diffuse_evaporate_ref``.
- ``repro_torch::dominance_pass(rows, cols?, groups?, groups_cols?) ->
  (counts, bitmap)``: the launcher ``dominance.dominance_pass`` (B2) on
  CUDA, ``ref.dominance_pass_ref`` on the CPU; the bitmap is int32 words
  holding the u32 bits.

The dispatcher picks the implementation by the inputs' device type; a
device with neither (not CPU, not CUDA) raises. The launchers count their
launches as before. The operators are defined with ``Library.define`` and
``impl``, not ``torch.library.custom_op``: on an H100's host the
``custom_op`` wrapper added ~24 µs to every call and ~8 s of imports to
the first (PERF.md). ``kernels.ops`` calls these operators, and
``import repro_torch.kernels`` registers them (what ``packaging.load``
needs).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import diffusion, dominance, ref

_LIB = torch.library.Library("repro_torch", "DEF")   # lives with the module

_LIB.define("diffuse_evaporate(Tensor chem, Tensor rate, Tensor evap) "
            "-> Tensor")
_LIB.impl("diffuse_evaporate", ref.diffuse_evaporate_ref, "CPU")
_LIB.impl("diffuse_evaporate", diffusion.diffuse_evaporate, "CUDA")


@torch.library.register_fake("repro_torch::diffuse_evaporate", lib=_LIB)
def _(chem, rate, evap):
    return torch.empty_like(chem)


_LIB.define("dominance_pass(Tensor rows, Tensor? cols=None, "
            "Tensor? groups=None, Tensor? groups_cols=None) "
            "-> (Tensor, Tensor)")
_LIB.impl("dominance_pass", ref.dominance_pass_ref, "CPU")
_LIB.impl("dominance_pass", dominance.dominance_pass, "CUDA")


@torch.library.register_fake("repro_torch::dominance_pass", lib=_LIB)
def _(rows, cols=None, groups=None, groups_cols=None):
    nj = (rows if cols is None else cols).shape[0]
    return (rows.new_empty((rows.shape[0],), dtype=torch.int32),
            rows.new_empty((rows.shape[0], (nj + 31) // 32),
                           dtype=torch.int32))


# chem (N, W, W) f32, rate/evap (N,) f32 -> a new (N, W, W) field
diffuse_evaporate = torch.ops.repro_torch.diffuse_evaporate.default
# rows (Ni, M) f32, cols (Nj, M) f32 or None (the self-sweep), int32 group
# ids or None -> (counts (Ni,) i32, bitmap (Ni, ceil(Nj/32)) i32)
dominance_pass = torch.ops.repro_torch.dominance_pass.default
