"""NSGA-II [Deb et al. 2002] in PyTorch — the paper's §4.5 optimizer, ported
from ``repro.evolution.nsga2``.

- non-dominated sorting through the single-pass selection engine: ONE fused
  pairwise sweep (the ``dominance_pass`` kernel) gives dominated counts and
  a packed dominance bitmap; front peeling is then popcount decrements over
  the bitmap, one host sync (``active.any()``) per front;
- crowding distance per front, optionally grouped so several islands'
  populations rank in one launch;
- binary tournament on (rank, -crowding), SBX crossover and polynomial
  mutation within box bounds.

Every stochastic function is split into a *draw* from a ``torch.Generator``
and an *apply* that is a pure function of the drawn numbers, so tests can
feed the apply functions another generator's draws. Functions that take
populations accept a leading island axis where noted.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch
import torch.distributed
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.runtime.sharding import RowBlock

BIG = 1.0e30


@dataclasses.dataclass(frozen=True)
class NSGA2Config:
    mu: int                       # population size
    genome_dim: int
    bounds: Tuple[Tuple[float, float], ...]
    n_objectives: int = 3
    sbx_eta: float = 15.0
    mut_eta: float = 20.0
    mut_p: float = 0.1            # per-gene mutation probability
    tournament_k: int = 2
    # paper Listing 4: "reevaluate = 0.01" — fraction of offspring slots that
    # re-evaluate an existing individual to fight over-evaluated fitness noise
    reevaluate: float = 0.01

    def lo(self, device=None):
        return torch.tensor([b[0] for b in self.bounds], dtype=torch.float32,
                            device=device)

    def hi(self, device=None):
        return torch.tensor([b[1] for b in self.bounds], dtype=torch.float32,
                            device=device)


# ---------------------------------------------------------------------------
# Non-dominated sorting + crowding
# ---------------------------------------------------------------------------
def _pack_bool_words(mask: torch.Tensor, n_words: int) -> torch.Tensor:
    """(N,) bool -> (n_words,) int32 with bit (i%32) of word i//32 =
    mask[i] (the bit convention of the dominance bitmap)."""
    lanes = F.pad(mask, (0, n_words * 32 - mask.shape[0]))
    return kref.pack_words_u32(lanes.reshape(n_words, 32))


def nondominated_ranks(objectives: torch.Tensor,
                       valid: torch.Tensor | None = None,
                       groups: torch.Tensor | None = None,
                       pass_fn=None) -> torch.Tensor:
    """objectives: (N, M) minimized. Returns (N,) i32 front index (0 =
    Pareto); rows not ``valid`` keep rank N.

    One fused sweep yields per-row dominated counts and the packed
    dominance bitmap. Front r is the active rows with count 0; peeling it
    subtracts from each remaining row the popcount of its bitmap words
    ANDed with the packed front mask.

    groups: optional (N,) int — dominance only within a group, so many
    islands' populations rank independently in ONE kernel launch.
    pass_fn: override for the fused sweep, ``pass_fn(objectives,
    groups=...) -> (counts, bitmap)``, e.g. ``runtime.sharding.
    sharded_dominance_pass`` bound to a mesh. When its bitmap is a
    ``RowBlock`` (this rank's rows), each front's decrements of the block
    go into a zero-padded full vector and one ``all_reduce`` a front makes
    them whole: every rank then holds the same counts and leaves the loop
    on the same front."""
    n = objectives.shape[0]
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=objectives.device)
    obj_masked = torch.where(valid[:, None], objectives, BIG)
    counts, bitmap = (pass_fn or kops.dominance_pass)(obj_masked,
                                                      groups=groups)
    block = bitmap if isinstance(bitmap, RowBlock) else None
    words = block.words if block is not None else bitmap
    n_words = words.shape[1]
    ranks = torch.full((n,), n, dtype=torch.int32, device=objectives.device)
    active = valid
    r = 0
    while bool(active.any()):
        front = active & (counts == 0)
        ranks = torch.where(front, r, ranks)
        front_words = _pack_bool_words(front, n_words)
        dec = kref.popcount_rows(words & front_words[None, :])
        if block is not None:
            full = torch.zeros((n,), dtype=torch.int32, device=dec.device)
            full[block.row0:block.row0 + len(dec)] = dec
            torch.distributed.all_reduce(full, group=block.group)
            dec = full
        counts = counts - dec
        active = active & ~front
        r += 1
    return ranks


def nondominated_ranks_peel(objectives, valid=None):
    """The pre-engine baseline: one full pairwise pass (``dominated_counts``)
    per front, as a host loop, so every pass registers in the kops
    pairwise-pass counter."""
    n = objectives.shape[0]
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=objectives.device)
    obj_masked = torch.where(valid[:, None], objectives, BIG)
    ranks = torch.full((n,), n, dtype=torch.int32, device=objectives.device)
    active = valid
    r = 0
    while bool(active.any()):
        masked = torch.where(active[:, None], obj_masked, BIG)
        counts = kops.dominated_counts(masked)
        front = active & (counts == 0)
        ranks = torch.where(front, r, ranks)
        active = active & ~front
        r += 1
    return ranks


def lexsort(keys) -> torch.Tensor:
    """Indices sorting by the LAST key first (``jnp.lexsort`` order), ties
    kept in index order: successive stable argsorts from the first key
    (least significant) to the last."""
    order = torch.arange(keys[0].shape[0], device=keys[0].device)
    for k in keys:
        order = order[torch.argsort(k[order], stable=True)]
    return order


def crowding_distance(objectives: torch.Tensor,
                      ranks: torch.Tensor,
                      groups: torch.Tensor | None = None,
                      n_groups: int = 1) -> torch.Tensor:
    """Per-front crowding distance (boundary points get +inf). (N,) f32.

    groups/n_groups: the fronts of distinct groups are distinct segments,
    so every island's crowding comes from one call on the flattened
    islands."""
    n, m = objectives.shape
    ranks = ranks.to(torch.int64)
    if groups is None:
        seg = ranks
        n_seg = n
        sort_keys = (ranks,)
    else:
        groups = groups.to(torch.int64)
        seg = groups * (n + 1) + ranks
        n_seg = n_groups * (n + 1)
        sort_keys = (ranks, groups)
    false = torch.zeros((1,), dtype=torch.bool, device=objectives.device)
    # The reference's segment reductions drop ids >= n_seg (unranked rows
    # carry rank n) and its span lookup clamps them to n_seg - 1: ids past
    # the end reduce into one spare bucket here and read span[n_seg - 1].
    seg_sink = seg.clamp(max=n_seg)
    dists = []
    for k in range(m):
        vals = objectives[:, k]
        # sort within (group, front) segments, then by value
        order = lexsort((vals,) + sort_keys)
        sv = vals[order]
        sr = seg[order]
        seg_max = vals.new_full((n_seg + 1,), -torch.inf).scatter_reduce_(
            0, seg_sink, vals, "amax", include_self=False)
        seg_min = vals.new_full((n_seg + 1,), torch.inf).scatter_reduce_(
            0, seg_sink, vals, "amin", include_self=False)
        span = torch.clamp(seg_max - seg_min, min=1e-12)
        prev_ok = torch.cat([false, sr[1:] == sr[:-1]])
        next_ok = torch.cat([sr[:-1] == sr[1:], false])
        gap = torch.where(
            prev_ok & next_ok,
            (torch.roll(sv, -1) - torch.roll(sv, 1))
            / span[sr.clamp(max=n_seg - 1)],
            torch.inf)
        dists.append(torch.empty_like(gap).index_put_((order,), gap))
    return torch.stack(dists, dim=1).sum(dim=1)


def truncation_key(ranks: torch.Tensor, crowding: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
    """Scalar sort key for (rank asc, crowding desc) truncation; invalid rows
    sort last. Shared by environmental selection, the archive merge, and the
    island merge."""
    ranks = torch.where(valid, ranks, 10 ** 9)
    return ranks.to(torch.float32) * 1e6 - torch.clamp(
        torch.nan_to_num(crowding, nan=0.0, posinf=1e5), 0, 1e5)


# ---------------------------------------------------------------------------
# Selection + variation: draws and applies
# ---------------------------------------------------------------------------
def take_rows(x, idx):
    """x (..., N) or (..., N, D) gathered at idx (..., K) along N."""
    if x.dim() == idx.dim():
        return torch.gather(x, -1, idx)
    return torch.gather(x, -2, idx[..., None].expand(
        *idx.shape, x.shape[-1]))


def tournament_apply(cand, ranks, crowding):
    """Binary tournament on (rank asc, crowding desc) between the candidate
    pairs cand (..., K, 2) of populations ranks/crowding (..., N). Returns
    (..., K) winner indices."""
    flat = cand.flatten(-2)
    r = take_rows(ranks, flat).unflatten(-1, (-1, 2))
    c = take_rows(crowding, flat).unflatten(-1, (-1, 2))
    first_better = (r[..., 0] < r[..., 1]) | (
        (r[..., 0] == r[..., 1]) & (c[..., 0] >= c[..., 1]))
    return torch.where(first_better, cand[..., 0], cand[..., 1])


def tournament(generator, ranks, crowding, n_picks):
    cand = torch.randint(0, ranks.shape[-1],
                         ranks.shape[:-1] + (n_picks, 2),
                         generator=generator, device=ranks.device)
    return tournament_apply(cand, ranks, crowding)


def sbx_apply(u, swap, p1, p2, lo, hi, eta):
    """Simulated binary crossover per gene, given uniforms u and swap
    flags of p1's shape."""
    beta = torch.where(u <= 0.5,
                       (2 * u) ** (1 / (eta + 1)),
                       (1 / (2 * (1 - u))) ** (1 / (eta + 1)))
    c1 = 0.5 * ((1 + beta) * p1 + (1 - beta) * p2)
    c2 = 0.5 * ((1 - beta) * p1 + (1 + beta) * p2)
    return torch.clamp(torch.where(swap, c1, c2), lo, hi)


def sbx_crossover(generator, p1, p2, lo, hi, eta):
    u = torch.rand(p1.shape, generator=generator, device=p1.device)
    swap = torch.rand(p1.shape, generator=generator, device=p1.device) < 0.5
    return sbx_apply(u, swap, p1, p2, lo, hi, eta)


def mutation_apply(u, mutate, x, lo, hi, eta):
    """Polynomial mutation per gene, given uniforms u and mutate flags."""
    span = hi - lo
    delta = torch.where(
        u < 0.5,
        (2 * u) ** (1 / (eta + 1)) - 1,
        1 - (2 * (1 - u)) ** (1 / (eta + 1)))
    return torch.clamp(torch.where(mutate, x + delta * span, x), lo, hi)


def polynomial_mutation(generator, x, lo, hi, eta, p):
    u = torch.rand(x.shape, generator=generator, device=x.device)
    mutate = torch.rand(x.shape, generator=generator, device=x.device) < p
    return mutation_apply(u, mutate, x, lo, hi, eta)


class OffspringDraws(NamedTuple):
    """Every random number one make_offspring call consumes."""
    cand1: torch.Tensor    # (..., lam, 2) int64 tournament 1 candidates
    cand2: torch.Tensor    # (..., lam, 2) int64 tournament 2 candidates
    u_sbx: torch.Tensor    # (..., lam, D) f32 SBX uniforms
    swap: torch.Tensor     # (..., lam, D) bool SBX child choice
    u_mut: torch.Tensor    # (..., lam, D) f32 mutation uniforms
    mutate: torch.Tensor   # (..., lam, D) bool genes that mutate
    reeval: torch.Tensor   # (..., lam) bool reevaluation slots
    src: torch.Tensor      # (..., lam) int64 genome copied into them


def draw_offspring(cfg: NSGA2Config, generator, n: int, lam: int,
                   batch: tuple = (), device=None) -> OffspringDraws:
    """Draws for ``lam`` children of each of ``batch`` populations of n."""
    d = cfg.genome_dim

    def rand(*shape):
        return torch.rand(batch + shape, generator=generator, device=device)

    def randint(hi, *shape):
        return torch.randint(0, hi, batch + shape, generator=generator,
                             device=device)

    return OffspringDraws(
        cand1=randint(n, lam, 2), cand2=randint(n, lam, 2),
        u_sbx=rand(lam, d), swap=rand(lam, d) < 0.5,
        u_mut=rand(lam, d), mutate=rand(lam, d) < cfg.mut_p,
        reeval=rand(lam) < cfg.reevaluate, src=randint(n, lam))


def apply_offspring(cfg: NSGA2Config, draws: OffspringDraws, genomes, ranks,
                    crowding):
    """(..., lam, D) offspring genomes + (..., lam) bool reevaluation flags
    from populations genomes (..., N, D) (reevaluated slots copy an existing
    genome verbatim — paper §4.5)."""
    i1 = tournament_apply(draws.cand1, ranks, crowding)
    i2 = tournament_apply(draws.cand2, ranks, crowding)
    lo, hi = cfg.lo(genomes.device), cfg.hi(genomes.device)
    children = sbx_apply(draws.u_sbx, draws.swap, take_rows(genomes, i1),
                         take_rows(genomes, i2), lo, hi, cfg.sbx_eta)
    children = mutation_apply(draws.u_mut, draws.mutate, children, lo, hi,
                              cfg.mut_eta)
    children = torch.where(draws.reeval[..., None],
                           take_rows(genomes, draws.src), children)
    return children, draws.reeval


def make_offspring(cfg: NSGA2Config, generator, genomes, ranks, crowding,
                   lam):
    """Draw then apply: (..., lam, D) children and (..., lam) reeval flags."""
    draws = draw_offspring(cfg, generator, genomes.shape[-2], lam,
                           tuple(genomes.shape[:-2]), genomes.device)
    return apply_offspring(cfg, draws, genomes, ranks, crowding)


# ---------------------------------------------------------------------------
# Environmental selection (mu + lambda truncation)
# ---------------------------------------------------------------------------
def island_groups(n_islands: int, size: int, device=None) -> torch.Tensor:
    """(n_islands*size,) int32 island id of each row of flattened islands."""
    return torch.arange(n_islands, dtype=torch.int32,
                        device=device).repeat_interleave(size)


def select_mu(cfg: NSGA2Config, genomes, objectives, valid):
    """(mu+lam) pool -> indices of the best mu by (rank, -crowding), plus
    ranks (invalid rows 1e9) and crowding. With a leading island axis
    (objectives (I, P, M)) all islands rank in one grouped launch and the
    results are per island: (I, mu), (I, P), (I, P)."""
    if objectives.dim() == 2:
        ranks = nondominated_ranks(objectives, valid)
        crowd = crowding_distance(objectives, ranks)
        key_val = truncation_key(ranks, crowd, valid)
        ranks = torch.where(valid, ranks, 10 ** 9)
        order = torch.argsort(key_val, stable=True)
        return order[:cfg.mu], ranks, crowd
    n_i, p, m = objectives.shape
    flat_o = objectives.reshape(n_i * p, m)
    flat_v = valid.reshape(n_i * p)
    groups = island_groups(n_i, p, objectives.device)
    ranks = nondominated_ranks(flat_o, flat_v, groups=groups)
    crowd = crowding_distance(flat_o, ranks, groups=groups, n_groups=n_i)
    key_val = truncation_key(ranks, crowd, flat_v).reshape(n_i, p)
    ranks = torch.where(flat_v, ranks, 10 ** 9).reshape(n_i, p)
    order = torch.argsort(key_val, dim=1, stable=True)
    return order[:, :cfg.mu], ranks, crowd.reshape(n_i, p)
