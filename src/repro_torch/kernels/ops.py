"""Routing between the hand-written CUDA kernels and their plain versions.

A tensor on the CPU goes to the plain PyTorch version in ``ref``; any other
tensor goes to the kernel wrapper, which launches the CUDA kernel or raises.
There is no fall-back from a CUDA tensor to the plain code. B1 and B2 go
through their ``torch.library`` operators (``library``), whose
implementation the dispatcher picks by device type; the others call their
wrapper.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels import cholesky as _cholesky
from repro_torch.kernels import diffusion as _diffusion
from repro_torch.kernels import dominance as _dominance
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import flash_attention_bwd as _flash_bwd
from repro_torch.kernels import gp as _gp
from repro_torch.kernels import library, ref

KERNELS = {
    "diffuse_evaporate": _diffusion.diffuse_evaporate,
    "dominance_pass": _dominance.dominance_pass,
    "dominated_counts": _dominance.dominated_counts,
    "gp_sqdist": _gp.gp_sqdist,
    "gp_matrix": _gp.gp_matrix,
    "tri_solve": _cholesky.tri_solve_blocked,
    "tri_solve_backward": _cholesky.tri_solve_blocked.backward,
    "chol_blocked": _cholesky.chol_blocked,
    "gp_chol_blocked": _cholesky.gp_chol_blocked,
    "flash_attention": _flash.flash_attention,
    "flash_attention_fwd": _flash_bwd.flash_attention_fwd,
    "flash_attention_dq": _flash_bwd.flash_attention_dq,
    "flash_attention_dkv": _flash_bwd.flash_attention_dkv,
}


def kernel_launch_counts() -> dict:
    """{kernel name: launches since the last reset}."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_kernel_launch_counts() -> None:
    for fn in KERNELS.values():
        build.set_launch_count(fn, 0)


def _on_cpu(x: torch.Tensor) -> bool:
    return x.device.type == "cpu"


# --------------------------------------------------------------------------
# Flash attention
# --------------------------------------------------------------------------
def flash_available(q, k, *, block_q=512, block_k=512) -> bool:
    """Can the kernel take these shapes? q (B, S, H, D), k (B, S, KH, D),
    the model layout. The reference's on-TPU rule (``d % 8 == 0``,
    ``s >= 8``, ``h % kh == 0``, S a multiple of min(block, S)), restricted
    to the head dims the kernel is built for; decided by shape alone, on
    any device (the reference's interpret-mode grid limit is an artefact of
    running Pallas on a CPU)."""
    b, s, h, d = q.shape
    if d % 8 != 0 or s < 8 or d not in _flash.HEAD_DIMS:
        return False
    if h % k.shape[2] != 0:
        return False
    return s % min(block_q, s) == 0 and s % min(block_k, s) == 0


def _flash_heads(q, k, v, causal, block_q, block_k):
    """B8 in (B, H, S, D): the plain version for CPU tensors, under the
    kernel's own checks; the kernel, which checks its inputs, otherwise.
    Not differentiable, as in the reference."""
    if not _on_cpu(q):
        return _flash.flash_attention(q, k, v, causal=causal,
                                      block_q=block_q, block_k=block_k)
    _flash.check_not_differentiated(q, k, v)
    _flash.check_contract(q, k, v, block_q, block_k)
    return ref.flash_attention_ref(q, k, v, causal=causal)


def flash_attention_gqa(q, k, v, *, causal=True, block_q=512, block_k=512):
    """Model-layout wrapper: q (B, S, H, D), k/v (B, S, KH, D) ->
    (B, S, H, D)."""
    out = _flash_heads(q.transpose(1, 2), k.transpose(1, 2),
                       v.transpose(1, 2), causal, block_q, block_k)
    return out.transpose(1, 2)


def flash_attention_gqa_diff(q, k, v, *, causal=True, block_q=512,
                             block_k=512):
    """Differentiable flash attention in model layout (the autograd
    Function with the dQ and dK/dV kernels) — usable inside a loss."""
    out = _flash_bwd.flash_attention_diff(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal,
        block_q, block_k)
    return out.transpose(1, 2)


def flash_attention_or_ref(q, k, v, *, causal=True):
    """(B, H, S, D) layout. On the card, as the reference on its own
    device: always B8, which launches or raises on a shape it cannot take.
    On the CPU, where the reference runs Pallas in interpret mode only for
    the shapes ``flash_available`` passes, the plain version either way
    (under the kernel's checks where it passes)."""
    if not _on_cpu(q) or flash_available(q.transpose(1, 2),
                                         k.transpose(1, 2)):
        return _flash_heads(q, k, v, causal, 512, 512)
    return ref.flash_attention_ref(q, k, v, causal=causal)


# --------------------------------------------------------------------------
# Ants diffusion
# --------------------------------------------------------------------------
def diffuse_evaporate(chem, rate, evap):
    """chem (N, W, W) f32; rate/evap (N,) fractions in [0, 1]."""
    rate = rate.to(torch.float32).contiguous()
    evap = evap.to(torch.float32).contiguous()
    return library.diffuse_evaporate(chem.contiguous(), rate, evap)


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
    return library.dominance_pass(rows, cols, groups, groups_cols)


# --------------------------------------------------------------------------
# GP covariance assembly
# --------------------------------------------------------------------------
def gp_sqdist(x1, x2):
    """(N1, D) x (N2, D) -> (N1, N2) f32 squared distances (fused pass)."""
    x1 = x1.to(torch.float32).contiguous()
    x2 = x2.to(torch.float32).contiguous()
    if _on_cpu(x1):
        return ref.gp_sqdist_ref(x1, x2)
    return _gp.gp_sqdist(x1, x2)


def gp_matrix(x1, x2, *, kind="matern52", lengthscale=0.2, variance=1.0):
    """Fused covariance assembly for fixed (float) hyper-parameters."""
    x1 = x1.to(torch.float32).contiguous()
    x2 = x2.to(torch.float32).contiguous()
    if _on_cpu(x1):
        return ref.gp_matrix_ref(x1, x2, kind=kind,
                                 lengthscale=float(lengthscale),
                                 variance=float(variance))
    return _gp.gp_matrix(x1, x2, kind=kind, lengthscale=lengthscale,
                         variance=variance)


# --------------------------------------------------------------------------
# Blocked Cholesky and triangular solve
# --------------------------------------------------------------------------
CHOL_BLOCK = 256         # the reference's pinned tile edge (64 * 2**j)
TRSM_RHS_BLOCK = 256


def _chol_block_ok(block: int) -> bool:
    q, r = divmod(block, ref.CHOL_BASE)
    return r == 0 and q >= 1 and (q & (q - 1)) == 0


def _check_block(block: int) -> None:
    if not _chol_block_ok(block):
        raise ValueError(f"block must be 64*2^j, got {block}")


def _ceil_to(n: int, b: int) -> int:
    return -(-n // b) * b


def _pad_identity(a, n_p):
    """(n, n) -> contiguous f32 (n_p, n_p) with ``a`` in the top-left corner
    and identity past it, so a factor of the padded matrix is blkdiag(L, I)
    and a solve against it leaves the padded rows alone."""
    n = a.shape[0]
    ap = torch.eye(n_p, dtype=torch.float32, device=a.device)
    ap[:n, :n] = a
    return ap


def _kernel_rows(n: int) -> int:
    """Rows the kernels need: they tile at 64 whatever ``block`` is, and a
    pad past the next multiple of 64 would factor as identity, uncoupled
    from the true part, so it would change no bit of ``[:n, :n]``."""
    return _ceil_to(n, _cholesky.TILE)


def chol_factor(a, *, block=CHOL_BLOCK):
    """Lower Cholesky factor of a (n, n) symmetric positive definite matrix
    by the blocked engine (``repro.kernels.ops.chol_factor``): pads to a
    multiple of ``block`` with identity (the kernel: of 64), factors, slices
    back. A pivot at or below 1e-30 is taken as 1e-30: no error for a
    matrix that is not positive definite."""
    _check_block(block)
    n = a.shape[0]
    if _on_cpu(a):
        out = ref.chol_blocked_ref(_pad_identity(a, _ceil_to(n, block)),
                                   block=block)
    else:
        n_p = _kernel_rows(n)
        if n != n_p or a.dtype != torch.float32 or not a.is_contiguous():
            a = _pad_identity(a, n_p)
        out = _cholesky.chol_blocked(a)    # reads a, writes a new buffer
    return out[:n, :n]


def gp_chol(x, *, kind="matern52", lengthscale=0.2, nugget=1e-4,
            block=CHOL_BLOCK):
    """Fused covariance assembly and blocked Cholesky
    (``repro.kernels.ops.gp_chol``): x (n, d) points -> the lower factor of
    K(x, x) + nugget I (variance 1). Zero-pads x to a multiple of ``block``
    (the kernel: of 64; the assembly masks the pad to identity rows) and
    slices back; on the kernel path K never exists as an unfactored (n, n)
    matrix. A lengthscale sweep calls this once per lengthscale."""
    _check_block(block)
    n, d = x.shape
    n_p = _ceil_to(n, block) if _on_cpu(x) else _kernel_rows(n)
    xp = torch.zeros((n_p, d), dtype=torch.float32, device=x.device)
    xp[:n] = x
    kw = dict(kind=kind, lengthscale=float(lengthscale), nugget=float(nugget))
    if _on_cpu(x):
        out = ref.gp_chol_blocked_ref(xp, n, block=block, **kw)
    else:
        out = _cholesky.gp_chol_blocked(xp, n, **kw)
    return out[:n, :n]


def tri_solve(l, b, *, trans=False, block=CHOL_BLOCK,
              rhs_block=TRSM_RHS_BLOCK):
    """Blocked triangular solve against a lower factor: L X = B
    (``trans=False``) or L^T X = B (``trans=True``); b (n, m) or (n,). Pads
    L with identity and B with zeros to multiples of ``block`` and
    ``rhs_block`` (the reference's contract), solves, slices back."""
    _check_block(block)
    n = l.shape[0]
    vec = b.dim() == 1
    bm = b[:, None] if vec else b
    m = bm.shape[1]
    n_p, m_p = _ceil_to(n, block), _ceil_to(m, rhs_block)
    lp = _pad_identity(l, n_p)
    bp = torch.zeros((n_p, m_p), dtype=torch.float32, device=l.device)
    bp[:n, :m] = bm
    if _on_cpu(l):
        xs = ref.tri_solve_blocked_ref(lp, bp, trans=trans, block=block)
    else:
        xs = _cholesky.tri_solve_blocked(lp, bp, trans=trans)
    xs = xs[:n, :m]
    return xs[:, 0] if vec else xs
