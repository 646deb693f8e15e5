"""The NetLogo 'ants' foraging model (Wilensky 1999) in PyTorch — the
paper's §4 case study, ported from ``repro.ants.model``.

Mechanics as in the reference: a colony of ``population`` ants leaves the
nest at the world centre; ants without food wander, biased towards chemical;
ants that reach food pick a piece up and head back to the nest, dropping
chemical; patches diffuse chemical to their 8 neighbours and evaporate every
tick (the fused CUDA kernel, ``kernels.ops.diffuse_evaporate``); fitness is
the first tick at which each of the 3 food sources empties.

The simulation is natively batched: every state tensor carries a leading
``lanes`` dim (parameter candidates x replicates) and one Python loop over
ticks advances all lanes in lockstep. Ant moves are a Gumbel-jittered argmax
over the 8-neighbourhood; the Gumbel noise of a tick is one ``(N, P, 8)``
draw from the caller's ``torch.Generator``, or a slice of precomputed
``noise`` so tests can replay another generator's stream.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.configs.ants_netlogo import AntsConfig
from repro_torch.kernels import ops as kops
from repro_torch.runtime.device import resolve_device

_OFFSETS = ((-1, -1), (-1, 0), (-1, 1), (0, -1),
            (0, 1), (1, -1), (1, 0), (1, 1))


class AntsState(NamedTuple):
    chem: torch.Tensor         # (N, W, W) chemical field, cfg.chem_dtype
    food: torch.Tensor         # (N, W, W) f32 food units
    ant_pos: torch.Tensor      # (N, P, 2) i32 patch coordinates
    carrying: torch.Tensor     # (N, P) bool
    ticks_empty: torch.Tensor  # (N, 3) i32 first tick each source emptied


def _dist2(w, cy, cx, device=None):
    ii = torch.arange(w, device=device)
    dy = ii[:, None] - cy
    dx = ii[None, :] - cx
    return dy * dy + dx * dx


def food_sources(cfg: AntsConfig, device=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(W,W) f32 initial food grid and (3,W,W) bool source masks (NetLogo
    layout)."""
    w = cfg.world_size
    c = w // 2
    r2 = cfg.food_radius ** 2
    centers = [
        (c, c + int(0.6 * c)),                 # source 1: right of nest
        (c + int(0.6 * c), c - int(0.6 * c)),  # source 2: lower-left
        (c - int(0.8 * c), c - int(0.8 * c)),  # source 3: upper-left (far)
    ]
    masks = torch.stack([_dist2(w, cy, cx, device) <= r2
                         for cy, cx in centers])
    food = torch.zeros((w, w), dtype=torch.float32, device=device)
    for i in range(3):
        food = torch.where(masks[i], 1.0 + (i % 2), food)
    return food, masks


def nest_mask(cfg: AntsConfig, device=None) -> torch.Tensor:
    w = cfg.world_size
    c = w // 2
    return _dist2(w, c, c, device) <= cfg.nest_radius ** 2


def init_state(cfg: AntsConfig, n: int, device=None) -> AntsState:
    w = cfg.world_size
    c = w // 2
    food, _ = food_sources(cfg, device)
    return AntsState(
        chem=torch.zeros((n, w, w), dtype=getattr(torch, cfg.chem_dtype),
                         device=device),
        food=food.expand(n, w, w).clone(),
        ant_pos=torch.full((n, cfg.population, 2), c, dtype=torch.int32,
                           device=device),
        carrying=torch.zeros((n, cfg.population), dtype=torch.bool,
                             device=device),
        ticks_empty=torch.full((n, 3), cfg.max_ticks, dtype=torch.int32,
                               device=device),
    )


def draw_gumbel(generator: torch.Generator, shape, device) -> torch.Tensor:
    """Standard Gumbel noise, -log(-log(u)) with u uniform in [tiny, 1)."""
    u = torch.rand(shape, generator=generator, device=device)
    u = u.clamp_(min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def _ant_step(cfg: AntsConfig, nest, toward, offsets, chem, food, ant_pos,
              carrying, gumbel):
    """All lanes' ant logic. Returns new positions, carrying flags, food,
    and the chemical-drop field (built on zeros, as the reference does)."""
    n, p = carrying.shape
    w = cfg.world_size
    # patches are addressed by flat index lane*W*W + y*W + x: one index
    # tensor per gather/scatter instead of three
    lane_base = (torch.arange(n, device=chem.device) * (w * w))[:, None]
    npos = ant_pos[:, :, None, :] + offsets                # (N,P,8,2)
    inb = ((npos >= 0) & (npos < w)).all(-1)               # (N,P,8)
    npc = npos.clamp(0, w - 1).long()
    cell_n = npc[..., 0] * w + npc[..., 1]                 # (N,P,8)
    chem_n = torch.where(inb, torch.take(chem, lane_base[..., None] + cell_n),
                         0.0)
    # forage: follow chemical above sniff threshold, else wander
    sniff = torch.where(chem_n > 0.05, chem_n, 0.0)
    forage = torch.where(inb, torch.log1p(sniff) * 8.0 + gumbel, -1e9)
    # return: move toward nest (precomputed per-patch descent scores)
    ret = torch.where(inb, -torch.take(toward, cell_n) + 0.5 * gumbel, -1e9)
    scores = torch.where(carrying[:, :, None], ret, forage)
    choice = scores.argmax(dim=-1, keepdim=True)           # first maximum
    new_pos = torch.gather(
        npc, 2, choice[..., None].expand(n, p, 1, 2))[:, :, 0]
    cell = torch.gather(cell_n, 2, choice)[..., 0]         # (N,P)
    flat = (lane_base + cell).reshape(-1)

    on_food = torch.take(food, flat).reshape(n, p) > 0
    on_nest = torch.take(nest, cell)
    pickup = ~carrying & on_food
    dropoff = carrying & on_nest
    new_carrying = (carrying | pickup) & ~dropoff

    # duplicate indices accumulate; the values are integers, so the order
    # of the accumulation (atomics on the card) does not change the result
    food = food.clone()
    food.view(-1).index_add_(0, flat, -pickup.to(torch.float32).reshape(-1))
    food.clamp_(min=0.0)
    chem_drop = torch.zeros_like(chem)
    chem_drop.view(-1).index_add_(
        0, flat, (60.0 * new_carrying.to(torch.float32)).to(chem.dtype)
        .reshape(-1))
    return new_pos.to(torch.int32), new_carrying, food, chem_drop


def make_step(cfg: AntsConfig, device=None):
    """step(state, tick, diffusion, evaporation, gumbel) -> state, with
    diffusion/evaporation (N,) fractions in [0, 1] and gumbel (N, P, 8)."""
    nest = nest_mask(cfg, device)
    w = cfg.world_size
    c = w // 2
    toward = _dist2(w, c, c, device).to(torch.float32)  # smaller = closer
    _, masks = food_sources(cfg, device)
    masks_t = masks.reshape(3, w * w).to(torch.float32).T.contiguous()
    offsets = torch.tensor(_OFFSETS, dtype=torch.int32, device=device)

    def step(state: AntsState, tick: int, diffusion, evaporation,
             gumbel) -> AntsState:
        new_pos, carrying, food, chem_drop = _ant_step(
            cfg, nest, toward, offsets, state.chem, state.food,
            state.ant_pos, state.carrying, gumbel)
        chem = state.chem + chem_drop
        chem = kops.diffuse_evaporate(
            chem.to(torch.float32), diffusion,
            evaporation).to(state.chem.dtype)
        # sums of integer food counts: exact in f32 in any order
        src_left = food.reshape(food.shape[0], w * w) @ masks_t   # (N, 3)
        newly_empty = (src_left <= 0) & (state.ticks_empty == cfg.max_ticks)
        ticks_empty = torch.where(newly_empty, tick, state.ticks_empty)
        return AntsState(chem, food, new_pos, carrying, ticks_empty)

    return step


def simulate_batch(cfg: AntsConfig, diffusion_rates, evaporation_rates, *,
                   generator: torch.Generator = None,
                   noise: torch.Tensor = None, rows=None) -> torch.Tensor:
    """diffusion/evaporation rates: (N,) NetLogo percentages in [0, 99], on
    the device to simulate on. Gumbel noise comes from ``generator`` one
    (N, P, 8) tick at a time, or from ``noise`` (max_ticks, N, P, 8).
    ``rows`` (a ``ga.Rows``, with ``generator``): these N lanes are lanes
    ``rows.start .. rows.stop`` of a batch of ``rows.total``; each tick
    draws the whole batch's noise and keeps theirs, so every lane sees the
    numbers it would in the whole batch.
    Returns (N, 3) f32 objectives (first-empty ticks, lower = better)."""
    return simulate_state(cfg, diffusion_rates, evaporation_rates,
                          generator=generator, noise=noise,
                          rows=rows).ticks_empty.to(torch.float32)


def simulate_state(cfg: AntsConfig, diffusion_rates, evaporation_rates, *,
                   generator: torch.Generator = None,
                   noise: torch.Tensor = None, rows=None) -> AntsState:
    """``simulate_batch``'s run (the same arguments), returning its final
    ``AntsState``: the objectives are its ``ticks_empty``."""
    if (generator is None) == (noise is None):
        raise ValueError("pass exactly one of generator= or noise=")
    device = diffusion_rates.device
    n = diffusion_rates.shape[0]
    shape = (n if rows is None else rows.total, cfg.population, 8)
    if rows is not None:
        if noise is not None or rows.stop - rows.start != n:
            raise ValueError(f"rows={rows} needs generator= and {n} lanes")
        if n == 0:      # the draws of the other lanes, nothing to simulate
            for _ in range(cfg.max_ticks):
                draw_gumbel(generator, shape, device)
            return init_state(cfg, 0, device)
    diffusion = (diffusion_rates.to(torch.float32) / 100.0).clamp(0.0, 1.0)
    evaporation = (evaporation_rates.to(torch.float32) / 100.0).clamp(0.0,
                                                                     1.0)
    state = init_state(cfg, n, device)
    step = make_step(cfg, device)
    for tick in range(cfg.max_ticks):
        gumbel = noise[tick] if noise is not None else draw_gumbel(
            generator, shape, device)
        if rows is not None:
            gumbel = rows.take(gumbel)
        state = step(state, tick, diffusion, evaporation, gumbel)
    return state


def simulate(cfg: AntsConfig, diffusion_rate: float, evaporation_rate: float,
             *, generator: torch.Generator, device="cuda") -> torch.Tensor:
    """Single-lane convenience wrapper. Returns (3,) objectives."""
    dev = resolve_device(device)
    out = simulate_batch(
        cfg, torch.tensor([diffusion_rate], dtype=torch.float32, device=dev),
        torch.tensor([evaporation_rate], dtype=torch.float32, device=dev),
        generator=generator)
    return out[0]
