"""Routing between the hand-written CUDA kernels and their plain versions.

A tensor on the CPU goes to the plain PyTorch version in ``ref``; any other
tensor goes to the kernel wrapper, which launches the CUDA kernel or raises.
There is no fall-back from a CUDA tensor to the plain code.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import diffusion as _diffusion
from repro_torch.kernels import dominance as _dominance
from repro_torch.kernels import ref

KERNELS = {
    "diffuse_evaporate": _diffusion.diffuse_evaporate,
    "dominance_pass": _dominance.dominance_pass,
    "dominated_counts": _dominance.dominated_counts,
}


def kernel_launch_counts() -> dict:
    """{kernel name: launches since the last reset}."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_kernel_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def _on_cpu(x: torch.Tensor) -> bool:
    return x.device.type == "cpu"


# --------------------------------------------------------------------------
# Ants diffusion
# --------------------------------------------------------------------------
def diffuse_evaporate(chem, rate, evap):
    """chem (N, W, W) f32; rate/evap (N,) fractions in [0, 1]."""
    rate = rate.to(torch.float32).contiguous()
    evap = evap.to(torch.float32).contiguous()
    if _on_cpu(chem):
        return ref.diffuse_evaporate_ref(chem, rate, evap)
    return _diffusion.diffuse_evaporate(chem.contiguous(), rate, evap)


# --------------------------------------------------------------------------
# NSGA-II dominance
# --------------------------------------------------------------------------
# Pairwise-pass accounting: every full O(Ni*Nj) dominance sweep bumps this
# counter when its wrapper is entered. The single-pass selection engine must
# cost exactly ONE pass per nondominated_ranks call; the peeling baseline
# costs one per front — tests assert both through this counter.
_PAIRWISE_PASSES = [0]


def reset_pairwise_pass_count() -> None:
    _PAIRWISE_PASSES[0] = 0


def pairwise_pass_count() -> int:
    return _PAIRWISE_PASSES[0]


def _groups(g):
    return None if g is None else g.to(torch.int32).contiguous()


def dominated_counts(objectives):
    """(N, M) (inactive rows pre-masked to +BIG) -> (N,) i32 counts."""
    _PAIRWISE_PASSES[0] += 1
    objectives = objectives.to(torch.float32).contiguous()
    if _on_cpu(objectives):
        return ref.dominated_counts_ref(objectives)
    return _dominance.dominated_counts(objectives)


def dominance_pass(rows, cols=None, groups=None, groups_cols=None):
    """Fused single-pass sweep -> (counts (Ni,) i32, bitmap (Ni, W) int32
    words holding the u32 bits)."""
    _PAIRWISE_PASSES[0] += 1
    rows = rows.to(torch.float32).contiguous()
    if cols is not None:
        cols = cols.to(torch.float32).contiguous()
    groups, groups_cols = _groups(groups), _groups(groups_cols)
    if _on_cpu(rows):
        return ref.dominance_pass_ref(rows, cols, groups, groups_cols)
    return _dominance.dominance_pass(rows, cols, groups, groups_cols)
