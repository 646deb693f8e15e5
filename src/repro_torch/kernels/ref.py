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

import math

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


# ---------------------------------------------------------------------------
# GP covariance assembly (B4)
# ---------------------------------------------------------------------------
def gp_sqdist_ref(x1, x2):
    """(..., N1, D), (..., N2, D) -> (..., N1, N2) f32 squared Euclidean
    distances in the expanded form ``(||a||^2 + ||b||^2) - 2 a.b``, clamped
    at 0, as ``repro.kernels.ref.gp_sqdist_ref`` computes them.

    Each sum over D runs as an explicit loop over the columns, from the
    product of column 0 upwards, one rounded multiply and one rounded add
    per term: ``csrc/gp.cu`` follows the same order (without FMA), so the
    kernel equals this function bitwise on the card. Leading batch
    dimensions broadcast (the acquisition ascent scores all its starts in
    one call); autograd runs through it."""
    d = x1.shape[-1]
    n1 = x1[..., 0] * x1[..., 0]
    n2 = x2[..., 0] * x2[..., 0]
    cross = x1[..., :, None, 0] * x2[..., None, :, 0]
    for k in range(1, d):
        n1 = n1 + x1[..., k] * x1[..., k]
        n2 = n2 + x2[..., k] * x2[..., k]
        cross = cross + x1[..., :, None, k] * x2[..., None, :, k]
    d2 = n1[..., :, None] + n2[..., None, :] - 2.0 * cross
    # maximum (not clamp): ties split the gradient as jnp.maximum does
    return torch.maximum(d2, torch.zeros((), dtype=d2.dtype,
                                         device=d2.device))


SQRT5 = float(torch.sqrt(torch.tensor(5.0)))   # sqrt(5) rounded to f32


def gp_kernel_fn(kind, d2, lengthscale, variance):
    """Map squared distances through a stationary covariance function
    (``repro.kernels.ref.gp_kernel_fn``): "rbf" or "matern52".

    ``lengthscale`` is a float or a tensor that broadcasts against ``d2``
    (the lengthscale sweep passes a (G, 1, 1) grid). A float becomes an f32
    tensor first, so every division is a true IEEE division on the CPU and
    on the card alike (the card divides by a Python scalar as a multiply by
    its reciprocal); ``csrc/gp.cu``'s epilogues do the same operations in
    the same order. The Matérn branch keeps the reference's safe sqrt: its
    forward value at d2 = 0 is 0, and the ``where`` keeps d/d(d2) finite
    there, so the acquisition ascent can differentiate through k(x, x)."""
    if not isinstance(lengthscale, torch.Tensor):
        lengthscale = torch.tensor(lengthscale, dtype=torch.float32,
                                   device=d2.device)
    if kind == "rbf":
        return variance * torch.exp(-0.5 * d2 / (lengthscale * lengthscale))
    if kind == "matern52":
        d2p = torch.maximum(d2, torch.zeros((), dtype=d2.dtype,
                                            device=d2.device))
        pos = d2p > 0.0
        r = torch.where(pos, torch.sqrt(torch.where(pos, d2p, 1.0)),
                        0.0) / lengthscale
        return variance * (1.0 + SQRT5 * r + (5.0 / 3.0) * (r * r)) \
            * torch.exp(-SQRT5 * r)
    raise ValueError(f"unknown GP kernel kind: {kind}")


def gp_matrix_ref(x1, x2, *, kind="matern52", lengthscale=0.2, variance=1.0):
    """Covariance assembly for fixed hyper-parameters: ``gp_kernel_fn`` of
    ``gp_sqdist_ref``."""
    return gp_kernel_fn(kind, gp_sqdist_ref(x1, x2), lengthscale, variance)


# ---------------------------------------------------------------------------
# Blocked triangular solve (B7)
# ---------------------------------------------------------------------------
CHOL_BASE = 64   # base tile edge of the recursive tile inverse


def tri_inv_base_ref(l):
    """Inverse of one (b, b) lower-triangular tile, b <= CHOL_BASE, by
    forward substitution on the identity, one row at a time."""
    b = l.shape[0]
    eye = torch.eye(b, dtype=l.dtype, device=l.device)
    rows = []
    for i in range(b):
        acc = eye[i]
        if i:
            acc = acc - l[i, :i] @ torch.stack(rows)
        rows.append(acc / l[i, i])
    return torch.stack(rows)


def tri_inv_tile_ref(l):
    """Inverse of one (block, block) lower-triangular tile by recursive
    halving (``repro.kernels.ref.tri_inv_tile_ref``): inv([[L11, 0], [L21,
    L22]]) has lower-left block -L22^-1 L21 L11^-1, so only the CHOL_BASE
    leaves substitute."""
    b = l.shape[0]
    if b <= CHOL_BASE:
        return tri_inv_base_ref(l)
    h = b // 2
    i11 = tri_inv_tile_ref(l[:h, :h])
    i22 = tri_inv_tile_ref(l[h:, h:])
    z = torch.zeros((h, b - h), dtype=l.dtype, device=l.device)
    return torch.cat([torch.cat([i11, z], 1),
                      torch.cat([-(i22 @ (l[h:, :h] @ i11)), i22], 1)], 0)


def tri_solve_blocked_ref(l, b, *, trans=False, block=256):
    """Blocked triangular solve (``repro.kernels.ref.tri_solve_blocked_ref``):
    L (n_p, n_p) lower, identity-padded past the true size, B (n_p, m_p)
    with n_p % block == 0 -> X with L X = B (forward) or L^T X = B
    (``trans``, backward). Row blocks substitute in sequence; each is B's
    row block minus the tile products with the blocks already solved, then
    one product with the explicit inverse of the diagonal tile. The
    reference also splits the RHS into independent column panels; the
    panels never interact, so this version takes all columns at once."""
    nb = l.shape[0] // block

    def tile(i, j):
        t = l[i * block:(i + 1) * block, j * block:(j + 1) * block]
        return t.T if trans else t

    order = range(nb - 1, -1, -1) if trans else range(nb)
    xs = [None] * nb
    for i in order:
        s = b[i * block:(i + 1) * block]
        for j in (range(i + 1, nb) if trans else range(i)):
            s = s - (tile(j, i) if trans else tile(i, j)) @ xs[j]
        inv = tri_inv_tile_ref(l[i * block:(i + 1) * block,
                                 i * block:(i + 1) * block])
        xs[i] = (inv.T if trans else inv) @ s
    return torch.cat(xs, 0)


# ---------------------------------------------------------------------------
# Blocked Cholesky (B5) and fused assembly + Cholesky (B6)
# ---------------------------------------------------------------------------
def chol_base_ref(a):
    """Unblocked Cholesky–Crout of one (b, b) tile, b <= CHOL_BASE
    (``repro.kernels.ref.chol_base_ref``): per column j the pivot
    ``sqrt(max(a_jj, 1e-30))``, the column below it divided by the pivot,
    then the rank-1 downdate of the trailing part; the lower triangle is
    returned. The guard means a matrix that is not positive definite gives
    huge or non-finite entries, never an error (``torch.linalg.cholesky``
    would raise). Column j is read and replaced through one-hot masks, as
    the reference does, so a non-finite entry spreads to the same places."""
    b = a.shape[0]
    idx = torch.arange(b, device=a.device)
    floor = torch.tensor(1e-30, dtype=a.dtype, device=a.device)
    acc = a
    for j in range(b):
        onehot = (idx == j).to(a.dtype)
        below = (idx > j).to(a.dtype)
        ajj = (acc * onehot[None, :] * onehot[:, None]).sum()
        d = torch.sqrt(torch.maximum(ajj, floor))
        col = (acc * onehot[None, :]).sum(1)
        lcol = torch.where(idx > j, col / d, 0.0) + onehot * d
        acc = acc - torch.outer(lcol * below, lcol * below)
        acc = acc * (1.0 - onehot[None, :]) + torch.outer(lcol, onehot)
    return torch.tril(acc)


def chol_tile_ref(a):
    """Factor one (block, block) diagonal tile by recursive halving down to
    CHOL_BASE (``repro.kernels.ref.chol_tile_ref``): L21 = A21 inv(L11)^T,
    then the factor of A22 - L21 L21^T."""
    b = a.shape[0]
    if b <= CHOL_BASE:
        return chol_base_ref(a)
    h = b // 2
    l11 = chol_tile_ref(a[:h, :h])
    l21 = a[h:, :h] @ tri_inv_tile_ref(l11).T
    l22 = chol_tile_ref(a[h:, h:] - l21 @ l21.T)
    z = torch.zeros((h, b - h), dtype=a.dtype, device=a.device)
    return torch.cat([torch.cat([l11, z], 1), torch.cat([l21, l22], 1)], 0)


def gp_tile_ref(x1, x2, row0, col0, n, *, kind, lengthscale, nugget):
    """One covariance tile of the fused assemble-and-factor path
    (``repro.kernels.ref.gp_tile_ref``): K[row0:row0+b1, col0:col0+b2] of
    the n-point matrix (variance 1) with ``nugget`` added on the true
    diagonal, and identity rows and columns at every index >= n, so the
    padded matrix factors as blkdiag(L, I). The covariance is B4's plain
    version, ``gp_kernel_fn(kind, gp_sqdist_ref(...))``, which
    ``csrc/cholesky.cu`` assembles bitwise."""
    k = gp_kernel_fn(kind, gp_sqdist_ref(x1, x2), lengthscale, 1.0)
    r = row0 + torch.arange(x1.shape[0], device=x1.device)
    c = col0 + torch.arange(x2.shape[0], device=x1.device)
    eye = (r[:, None] == c[None, :]).to(torch.float32)
    pad = (r[:, None] >= n) | (c[None, :] >= n)
    return torch.where(pad, eye, k + nugget * eye)


def _chol_left_tiles(tiles, nb, block):
    """Left-looking factor of a dict {(i, j): tile} of the lower
    (block, block) tiles -> the assembled lower L (nb*block, nb*block)
    (``repro.kernels.ref._chol_left_tiles``): block column k is its tiles
    minus the products with the finished columns, one tile product at a
    time in increasing j; then the diagonal tile's factor, and each tile
    below times the transposed inverse of that factor."""
    out = {}
    for k in range(nb):
        col = {}
        for i in range(k, nb):
            s = tiles[(i, k)]
            for j in range(k):
                s = s - out[(i, j)] @ out[(k, j)].T
            col[i] = s
        lkk = chol_tile_ref(col[k])
        out[(k, k)] = lkk
        if k < nb - 1:
            linv_t = tri_inv_tile_ref(lkk).T
            for i in range(k + 1, nb):
                out[(i, k)] = col[i] @ linv_t
    z = torch.zeros((block, block), dtype=lkk.dtype, device=lkk.device)
    return torch.cat([torch.cat([out[(i, j)] if j <= i else z
                                 for j in range(nb)], 1)
                      for i in range(nb)], 0)


def chol_blocked_ref(a, *, block=256):
    """Blocked Cholesky (``repro.kernels.ref.chol_blocked_ref``): a
    (n_p, n_p) f32 with n_p % block == 0, identity-padded past the true
    size -> lower L. Left-looking over (block, block) tiles; only the lower
    tiles are read. The factor depends on ``block`` in the last bit, as the
    reference's does."""
    nb = a.shape[0] // block
    tiles = {(i, j): a[i * block:(i + 1) * block, j * block:(j + 1) * block]
             for i in range(nb) for j in range(i + 1)}
    return _chol_left_tiles(tiles, nb, block)


def gp_chol_blocked_ref(x, n, *, kind, lengthscale, nugget, block=256):
    """Fused assembly and factorization
    (``repro.kernels.ref.gp_chol_blocked_ref``): x (n_p, d) zero-padded
    points, n_p % block == 0, true count n -> the lower factor of
    K(x, x) + nugget I with identity past n. Each lower tile is assembled
    through ``gp_tile_ref`` from its two (block, d) row tiles; K never exists
    as one (n_p, n_p) matrix."""
    nb = x.shape[0] // block
    xt = [x[i * block:(i + 1) * block] for i in range(nb)]
    tiles = {(i, j): gp_tile_ref(xt[i], xt[j], i * block, j * block, n,
                                 kind=kind, lengthscale=lengthscale,
                                 nugget=nugget)
             for i in range(nb) for j in range(i + 1)}
    return _chol_left_tiles(tiles, nb, block)


# --------------------------------------------------------------------------
# Flash attention (B8, B9): full S x S matrices in f32
# --------------------------------------------------------------------------
def _flash_scores(q, k, causal):
    """q (B, H, S, D), k (B, KH, S, D) -> f32 scores (B, KH, G, S, S) of
    q-head h = kv * G + g against kv head kv, divided by sqrt(D), -inf
    above the diagonal when ``causal``."""
    b, h, s, d = q.shape
    kh = k.shape[1]
    qg = q.reshape(b, kh, h // kh, s, d).float()
    scores = torch.einsum("bkgsd,bktd->bkgst", qg, k.float()) / math.sqrt(d)
    if causal:
        keep = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~keep, float("-inf"))
    return scores


def flash_attention_ref(q, k, v, *, causal=True):
    """(``repro.kernels.ref.flash_attention_ref``) q (B, H, S, D); k, v
    (B, KH, S, D): plain softmax attention with GQA in f32, the output cast
    to q's type."""
    b, h, s, d = q.shape
    probs = torch.softmax(_flash_scores(q, k, causal), dim=-1)
    out = torch.einsum("bkgst,bktd->bkgsd", probs, v.float())
    return out.reshape(b, h, s, d).to(q.dtype)


def flash_attention_fwd_ref(q, k, v, *, causal=True):
    """-> (out (B, H, S, D) in q's type, lse (B, H, S) f32) with
    lse = m + log(max(l, 1e-30)) of each row's max m and denominator
    l = sum(exp(scores - m)), as the forward kernels write it."""
    b, h, s, d = q.shape
    scores = _flash_scores(q, k, causal)
    m = scores.amax(-1, keepdim=True)
    p = torch.exp(scores - m)
    l = p.sum(-1, keepdim=True)
    out = torch.einsum("bkgst,bktd->bkgsd", p / l, v.float())
    lse = m + torch.log(l.clamp_min(1e-30))
    return out.reshape(b, h, s, d).to(q.dtype), lse.reshape(b, h, s)


def flash_attention_bwd_ref(q, k, v, out, lse, do, *, causal=True):
    """The Dao backward with full S x S matrices
    (``repro.kernels.flash_attention_bwd``'s docstring) -> (dq, dk_h,
    dv_h), each (B, H, S, D) in q's type, dK/dV per q-head. dsum is taken
    in f32 from ``do`` and the cast ``out``, as the reference does."""
    b, h, s, d = q.shape
    kh = k.shape[1]
    g = h // kh
    scale = 1.0 / math.sqrt(d)

    def grouped(x):
        return x.reshape(b, kh, g, s, d).float()

    p = torch.exp(_flash_scores(q, k, causal) - lse.reshape(b, kh, g, s, 1))
    dof = grouped(do)
    dsum = (dof * grouped(out)).sum(-1, keepdim=True)
    dv = torch.einsum("bkgst,bkgsd->bkgtd", p, dof)
    dp = torch.einsum("bkgsd,bktd->bkgst", dof, v.float())
    ds = p * (dp - dsum)
    dq = torch.einsum("bkgst,bktd->bkgsd", ds, k.float()) * scale
    dk = torch.einsum("bkgst,bkgsd->bkgtd", ds, grouped(q)) * scale
    return tuple(x.reshape(b, h, s, d).to(q.dtype) for x in (dq, dk, dv))
