"""Plain PyTorch versions of the port's kernels — the CPU path and the
on-card oracles the CUDA kernels are held to.

Bit words: the dominance bitmap keeps the reference layout, ``(Ni,
ceil(Nj/32))`` 32-bit words with bit ``j % 32`` of word ``j // 32`` set iff
``cols[j]`` dominates ``rows[i]``. Torch's uint32 supports few operations
(no ``<<``, no popcount on the CPU), so the port carries each word as an
int32 with the same 32 bits; ``tensor.numpy().view(np.uint32)`` recovers the
unsigned words. Packing runs in int64 with multiplies; popcount is the SWAR
bit count in int64.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

# (di, dj) neighbour order of the diffusion stencil: the order in which the
# eight neighbour shares are summed, shared with csrc/diffusion.cu.
NEIGHBOURS = tuple((di, dj) for di in (-1, 0, 1) for dj in (-1, 0, 1)
                   if (di, dj) != (0, 0))


def neighbor_counts(w: int, device=None) -> torch.Tensor:
    """(W, W) f32 number of in-bounds neighbours (8 interior, 5 edge,
    3 corner)."""
    ones = F.pad(torch.ones((w, w), device=device), (1, 1, 1, 1))
    count = torch.zeros((w, w), device=device)
    for di, dj in NEIGHBOURS:
        count = count + ones[1 - di:1 - di + w, 1 - dj:1 - dj + w]
    return count


def diffuse_evaporate_ref(chem, rate, evap):
    """chem: (N, W, W) f32; rate/evap: (N,) f32 fractions in [0, 1].

    NetLogo bounded-world ``diffuse`` then evaporation, in the float order
    of the TPU kernel body (``repro.kernels.diffusion._diffuse_kernel``):
    ``share = chem*rate*(1/8)``; the eight shares ``share[i-di, j-dj]``
    summed from zero in ``NEIGHBOURS`` order (off-world terms add 0);
    ``kept = chem - share*ncount``; ``(kept + acc)*(1 - evap)``. Each step is
    its own rounded operation, so the CUDA kernel (built without FMA
    contraction) is bitwise equal to this function on the card."""
    n, w, _ = chem.shape
    share = chem * rate[:, None, None] * 0.125
    padded = F.pad(share, (1, 1, 1, 1))
    acc = torch.zeros_like(chem)
    for di, dj in NEIGHBOURS:
        acc = acc + padded[:, 1 - di:1 - di + w, 1 - dj:1 - dj + w]
    kept = chem - share * neighbor_counts(w, chem.device)
    return (kept + acc) * (1.0 - evap[:, None, None])


def _dominates(rows, cols):
    """(Ni, Nj) bool: cols[j] dominates rows[i] (all <=, any <; minimize)."""
    le = (cols[None, :, :] <= rows[:, None, :]).all(-1)
    lt = (cols[None, :, :] < rows[:, None, :]).any(-1)
    return le & lt


def dominated_counts_ref(objectives):
    """(N, M) f32 -> (N,) i32 minimization dominance counts."""
    return _dominates(objectives, objectives).sum(dim=1, dtype=torch.int32)


def pack_words_u32(bits):
    """(..., W, 32) bool -> (..., W) int32 words, bit k of word w =
    bits[..., w, k] — the one bit convention of the dominance bitmap."""
    weights = torch.pow(2, torch.arange(32, dtype=torch.int64,
                                        device=bits.device))
    words = (bits.to(torch.int64) * weights).sum(-1)
    return torch.where(words >= 1 << 31, words - (1 << 32),
                       words).to(torch.int32)


def popcount_rows(words):
    """(..., W) int32 words -> (...,) i32 total set bits per row (SWAR bit
    count on the unsigned 32-bit value, in int64)."""
    x = words.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = ((x * 0x01010101) & 0xFFFFFFFF) >> 24
    return x.sum(-1, dtype=torch.int32)


def dominance_pass_ref(rows, cols=None, groups=None, groups_cols=None):
    """Oracle for the fused sweep: (counts (Ni,) i32, bitmap (Ni, W) int32)
    with bit (j%32) of bitmap[i, j//32] set iff cols[j] dominates rows[i]
    (within the same group when group ids are given; a side without ids is
    group 0). W = ceil(Nj/32)."""
    if cols is None:
        cols = rows
        groups_cols = groups
    ni, nj = rows.shape[0], cols.shape[0]
    dom = _dominates(rows, cols)                        # (Ni, Nj)
    if groups is not None or groups_cols is not None:
        zeros = torch.zeros((), dtype=torch.int32, device=rows.device)
        gi = zeros.expand(ni) if groups is None else groups.to(torch.int32)
        gj = zeros.expand(nj) if groups_cols is None \
            else groups_cols.to(torch.int32)
        dom = dom & (gj[None, :] == gi[:, None])
    counts = dom.sum(dim=1, dtype=torch.int32)
    w = -(-nj // 32)
    padded = F.pad(dom, (0, w * 32 - nj))
    return counts, pack_words_u32(padded.reshape(ni, w, 32))
