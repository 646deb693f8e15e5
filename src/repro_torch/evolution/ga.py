"""Steady-state NSGA-II over a written-out island axis, ported from
``repro.evolution.ga``.

``eval_fn(generator, genomes (L, D)) -> objectives (L, M)`` is the fitness
task — e.g. ``explore.replication.replicated_batch`` over the ants
simulator. Where the reference vmaps one population's step over islands,
the port's state carries the island axis itself: one step ranks every
island in one grouped ``dominance_pass`` launch and evaluates every
island's children in one ``eval_fn`` call (8 islands x lam 16 x 5
replicates = 640 simulator lanes at the reference's defaults).

The streaming init (``evaluate_population_streaming``) evaluates a
paper-scale initial population in chunks, each a pure job of (seed, chunk)
that an EnvironmentPool may run anywhere and retry, and
``select_top_streaming`` picks the islands' seeds from it block by block.

``run_generational`` (paper Listing 4) runs one island and returns the
reference's un-islanded shapes. The reference's ``run_chunked`` scans
``chunk`` generations into one device program; eagerly that is
``run_generational`` itself, so the port has no counterpart.
"""
from __future__ import annotations

import time
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.evolution import nsga2
from repro_torch.evolution.nsga2 import NSGA2Config
from repro_torch.runtime.device import make_generator, resolve_device


class Rows(NamedTuple):
    """Rows ``start .. stop`` of a batch of ``total`` rows: the part a rank
    keeps of a draw made at the whole batch's shape. A rank that holds a
    block of islands draws every random tensor at the single-device run's
    shape and keeps its rows, so its numbers are that run's, bit for bit."""
    start: int
    stop: int
    total: int

    def take(self, x: torch.Tensor) -> torch.Tensor:
        return x[self.start:self.stop]

    def times(self, k: int) -> "Rows":
        """The same rows when each row of the batch becomes ``k`` rows."""
        return Rows(self.start * k, self.stop * k, self.total * k)


def call_eval(eval_fn: Callable, generator, genomes, rows: "Rows" = None):
    """``eval_fn(generator, genomes)``, or with ``rows=`` when ``genomes``
    are only ``rows`` of the batch whose draws the generator makes (an
    ``eval_fn`` used on a block of islands must take ``rows``)."""
    if rows is None:
        return eval_fn(generator, genomes)
    return eval_fn(generator, genomes, rows=rows)


class GAState(NamedTuple):
    genomes: torch.Tensor      # (I, mu, D) f32
    objectives: torch.Tensor   # (I, mu, M) f32
    valid: torch.Tensor        # (I, mu) bool
    generation: torch.Tensor   # (I,) i32
    evaluations: torch.Tensor  # (I,) i32


def init_state(cfg: NSGA2Config, generator: torch.Generator, *,
               n_islands: int = 1, device="cuda") -> GAState:
    """Uniform random unevaluated populations within the bounds, on
    ``device`` (the card unless the caller asks for the CPU)."""
    device = resolve_device(device)
    lo, hi = cfg.lo(device), cfg.hi(device)
    genomes = torch.rand((n_islands, cfg.mu, cfg.genome_dim),
                         generator=generator, device=device) * (hi - lo) + lo
    zeros = torch.zeros((n_islands,), dtype=torch.int32, device=device)
    return GAState(
        genomes=genomes,
        objectives=torch.full((n_islands, cfg.mu, cfg.n_objectives),
                              nsga2.BIG, dtype=torch.float32, device=device),
        valid=torch.zeros((n_islands, cfg.mu), dtype=torch.bool,
                          device=device),
        generation=zeros,
        evaluations=zeros.clone(),
    )


def evaluate_initial(cfg: NSGA2Config, state: GAState, eval_fn: Callable,
                     generator: torch.Generator, islands=None,
                     rows: Rows = None) -> GAState:
    """Evaluate the whole population of each island in ``islands`` (a (I,)
    bool mask; default all) in one ``eval_fn`` call. ``rows``: where these
    genomes sit in the whole run's batch of initial evaluations, when the
    state is one rank's block of islands."""
    n_i, mu, d = state.genomes.shape
    if islands is None:
        islands = torch.ones((n_i,), dtype=torch.bool,
                             device=state.genomes.device)
    idx = islands.nonzero()[:, 0]
    obj = call_eval(eval_fn, generator,
                    state.genomes[idx].reshape(-1, d), rows)
    objectives = state.objectives.clone()
    objectives[idx] = obj.reshape(len(idx), mu, obj.shape[-1]).to(
        torch.float32)
    valid = state.valid.clone()
    valid[idx] = True
    return state._replace(objectives=objectives, valid=valid,
                          evaluations=state.evaluations
                          + mu * islands.to(torch.int32))


def make_step(cfg: NSGA2Config, eval_fn: Callable, lam: int) -> Callable:
    """step(state, generator, block=None) -> state: one (mu + lambda)
    NSGA-II generation on every island. ``block`` (islands ``start ..
    stop`` of ``total``) marks ``state`` as one rank's block: the draws are
    made for all ``total`` islands and the block's are kept."""

    def step(state: GAState, generator: torch.Generator,
             block: Rows = None) -> GAState:
        n_i, mu, d = state.genomes.shape
        m = state.objectives.shape[-1]
        flat_o = state.objectives.reshape(n_i * mu, m)
        groups = nsga2.island_groups(n_i, mu, flat_o.device)
        ranks = nsga2.nondominated_ranks(flat_o, state.valid.reshape(-1),
                                         groups=groups)
        crowd = nsga2.crowding_distance(flat_o, ranks, groups=groups,
                                        n_groups=n_i)
        whole = block.total if block is not None else n_i
        draws = nsga2.draw_offspring(cfg, generator, mu, lam, (whole,),
                                     state.genomes.device)
        if block is not None:
            draws = nsga2.OffspringDraws(*(block.take(t) for t in draws))
        children, _ = nsga2.apply_offspring(
            cfg, draws, state.genomes, ranks.reshape(n_i, mu),
            crowd.reshape(n_i, mu))
        child_obj = call_eval(
            eval_fn, generator, children.reshape(n_i * lam, d),
            block.times(lam) if block is not None else None)
        pool_g = torch.cat([state.genomes, children], dim=1)
        pool_o = torch.cat([state.objectives,
                            child_obj.reshape(n_i, lam, m)], dim=1)
        pool_v = torch.cat([state.valid,
                            torch.ones((n_i, lam), dtype=torch.bool,
                                       device=flat_o.device)], dim=1)
        idx, _, _ = nsga2.select_mu(cfg, pool_g, pool_o, pool_v)
        return GAState(
            genomes=nsga2.take_rows(pool_g, idx),
            objectives=nsga2.take_rows(pool_o, idx),
            valid=nsga2.take_rows(pool_v, idx),
            generation=state.generation + 1,
            evaluations=state.evaluations + lam,
        )

    return step


def _one_island(state: GAState) -> GAState:
    """The reference's un-islanded state of a one-island run: genomes
    (mu, D), objectives (mu, M), valid (mu,), generation and evaluations
    0-d."""
    return GAState(*(t[0] for t in state))


def run_generational(cfg: NSGA2Config, eval_fn: Callable,
                     generator: torch.Generator, *, lam: int,
                     generations: int, hooks=(), device="cuda") -> GAState:
    """Paper Listing 4: GenerationalGA(evolution)(fitness, lambda) on
    ``device`` (the card unless the caller asks for the CPU): ``mu``
    random genomes evaluated, then ``generations`` (mu + lam) NSGA-II
    steps, each hook called with the state after each. Returns the
    reference's un-islanded state (genomes (mu, D), objectives (mu, M));
    ``evaluations`` counts mu + lam per generation."""
    state = init_state(cfg, generator, n_islands=1, device=device)
    state = evaluate_initial(cfg, state, eval_fn, generator)
    step = make_step(cfg, eval_fn, lam)
    for _ in range(generations):
        state = step(state, generator)
        for hook in hooks:
            hook(_one_island(state))
    return _one_island(state)


# ---------------------------------------------------------------------------
# Paper-scale streaming initialization (§4.6: "200,000 individuals evaluated
# in one hour" on EGI). The initial population is generated and evaluated in
# device-sized chunks; each chunk is a pure job of (seed, chunk index), so it
# can be delegated to an unreliable EnvironmentPool, resubmitted on failure
# and verified by fingerprint: the result is the same whichever worker
# evaluated which chunk, in whatever order, after however many retries, and
# the contiguous completed prefix checkpoints to disk for resume.
# ---------------------------------------------------------------------------
class StreamingResult(NamedTuple):
    """Outcome of one (possibly interrupted or resumed) streaming
    evaluation."""
    genomes: Optional[np.ndarray]      # (n_total, D); None when interrupted
    objectives: Optional[np.ndarray]   # (n_total, M); None when interrupted
    chunks_done: int
    chunks_total: int
    resumed_chunks: int                # chunks served from the checkpoint
    interrupted: bool
    attempts: int                      # environment attempts incl. retries
    wall_s: float


def chunk_sizes(n_total: int, chunk: int) -> List[int]:
    """Chunk layout of a streamed population (full chunks + remainder)."""
    sizes = [chunk] * (n_total // chunk)
    if n_total % chunk:
        sizes.append(n_total % chunk)
    return sizes


GENOMES, GUMBEL = 0, 1      # the two random streams of a chunk


def chunk_seed(seed: int, i: int, stream: int) -> int:
    """The generator seed of ``stream`` (GENOMES or GUMBEL) of chunk ``i``:

        ((seed mod 2^32) << 32) | ((0x9E3779B9 * seed + 2 * i + stream)
                                   mod 2^32)

    For one ``seed`` the low word differs for every (i, stream) with
    i < 2^31, and so does the whole 64-bit value: a CPU generator, which
    seeds from the low 32 bits only, and a CUDA generator both see a
    different seed for every chunk and stream. The high word carries the
    run's seed into the CUDA streams."""
    low = (0x9E3779B9 * seed + 2 * i + stream) & 0xFFFFFFFF
    return ((seed & 0xFFFFFFFF) << 32) | low


def population_chunk_draw(seed: int, i: int, size: int, dim: int,
                          device) -> torch.Tensor:
    """The draw of chunk ``i``: (size, dim) uniforms in [0, 1) from a
    generator of its own, seeded with ``chunk_seed(seed, i, GENOMES)``."""
    gen = make_generator(chunk_seed(seed, i, GENOMES), device)
    return torch.rand((size, dim), generator=gen, device=gen.device)


def population_chunk_apply(cfg: NSGA2Config, u: torch.Tensor) -> torch.Tensor:
    """Uniforms in [0, 1) scaled into the genome bounds."""
    lo, hi = cfg.lo(u.device), cfg.hi(u.device)
    return u * (hi - lo) + lo


def population_chunk(cfg: NSGA2Config, seed: int, i: int, size: int,
                     device="cuda") -> torch.Tensor:
    """The genomes of chunk ``i`` of the initial population: a pure
    function of (cfg, seed, i, size, device), the property that makes
    chunks resubmittable, checkpointable and the same under failures."""
    return population_chunk_apply(cfg, population_chunk_draw(
        seed, i, size, cfg.genome_dim, resolve_device(device)))


def make_chunk_task(cfg: NSGA2Config, eval_fn: Callable, seed: int,
                    device="cuda"):
    """One chunk's evaluation as a PyTask, so the environment layer owns
    delegation, retry and fingerprint verification. The context carries
    only the ints ``chunk`` and ``size``; every attempt regenerates the
    chunk's genomes and a fresh generator for its Gumbel stream
    (``chunk_seed(seed, i, GUMBEL)``) inside the job, and never draws from
    a generator shared with other jobs. Returns the objectives as a numpy
    array, which the pool can fingerprint."""
    from repro_torch.core.prototype import Val
    from repro_torch.core.task import PyTask
    dev = resolve_device(device)

    def fn(ctx):
        i, size = int(ctx["chunk"]), int(ctx["size"])
        genomes = population_chunk(cfg, seed, i, size, dev)
        gen = make_generator(chunk_seed(seed, i, GUMBEL), dev)
        return {"objectives": eval_fn(gen, genomes).to(
            torch.float32).cpu().numpy()}

    return PyTask("init_chunk", fn,
                  inputs=(Val("chunk", int), Val("size", int)),
                  outputs=(Val("objectives"),))


def evaluate_population_streaming(
        cfg: NSGA2Config, eval_fn: Callable, seed: int, *, n_total: int,
        chunk: int = 4096, environment=None, checkpoint_dir: str = None,
        checkpoint_every: int = 8, stop_after_chunks: Optional[int] = None,
        record=None, progress: Callable[[int, int], None] = None,
        service=None, experiment_id: str = "ga-init", device="cuda",
        settings: Optional[str] = None) -> StreamingResult:
    """Evaluate an ``n_total``-individual initial population in chunks of
    ``chunk`` on ``device``, inline (``environment=None``: the serial
    baseline), through a (fault-injected) Environment or EnvironmentPool,
    or as tenant ``experiment_id`` of a shared ``ExplorationService``
    (``service=``, not with ``environment=``: the chunks then share the
    service's pool with other tenants, and completed chunks are memoized
    across driver restarts by the service's cache).

    ``eval_fn(generator, genomes (n, D)) -> (n, M)`` is the fitness batch.
    With ``checkpoint_dir`` the contiguous completed prefix commits there
    every ``checkpoint_every`` chunks (the two newest commits are kept) and
    the run resumes from the newest; ``settings`` (a JSON string) is stored
    with each commit, and a resume from a commit of other settings raises.
    ``stop_after_chunks`` evaluates only that many chunks, commits, and
    returns ``interrupted=True``: the mid-population kill switch. ``record``
    (a RunRecord) gets one TaskRecord a chunk: mode "stream" with the
    per-attempt trace, or "cache" for a chunk restored from the checkpoint.
    ``progress(chunks_done, chunks_total)`` is called after each chunk.
    """
    if service is not None and environment is not None:
        raise ValueError("pass either environment= or service=, not both")
    from repro_torch import checkpoint
    from repro_torch.core.cache import inputs_digest
    from repro_torch.core.prototype import Context
    from repro_torch.core.scheduler import TaskRecord

    t0 = time.monotonic()
    dev = resolve_device(device)
    sizes = chunk_sizes(n_total, chunk)
    n_chunks = len(sizes)
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(int)
    task = make_chunk_task(cfg, eval_fn, seed, dev)
    done: List[Optional[np.ndarray]] = [None] * n_chunks

    def digest(i):
        return inputs_digest(task, Context(chunk=i, size=sizes[i]))

    # -- resume: restore the contiguous prefix committed last run ----------
    resumed = 0
    if checkpoint_dir is not None:
        last = checkpoint.latest_step(checkpoint_dir)
        if last:
            like = {"objectives": None}
            if settings is not None:
                like["settings"] = None
            saved = checkpoint.restore(checkpoint_dir, last, like)
            if settings is not None:
                checkpoint.require_settings(
                    checkpoint_dir, saved["settings"].item(), settings)
            prefix = saved["objectives"]
            if last > n_chunks or prefix.shape != (offsets[last],
                                                   cfg.n_objectives):
                raise ValueError(
                    f"{checkpoint_dir}: {last} chunks of shape "
                    f"{prefix.shape} do not fit n_total={n_total}, "
                    f"chunk={chunk}")
            for i in range(last):
                done[i] = prefix[offsets[i]:offsets[i + 1]]
            resumed = last
            if record is not None:
                for i in range(last):
                    record.tasks.append(TaskRecord(
                        task=task.name, capsule=i, environment="checkpoint",
                        inputs_digest=digest(i), started_s=0.0, wall_s=0.0,
                        retries=0, cache_hit=True, mode="cache"))

    committed = resumed

    def commit(force: bool = False):
        # each commit rewrites the whole completed prefix (one atomic
        # artifact, no chunk manifest); checkpoint_every bounds how often
        nonlocal committed
        if checkpoint_dir is None:
            return
        k = committed
        while k < n_chunks and done[k] is not None:
            k += 1
        if k > committed and (force or k - committed >= checkpoint_every
                              or k == n_chunks):
            tree = {"objectives": np.concatenate(done[:k], axis=0)}
            if settings is not None:
                tree["settings"] = settings
            checkpoint.save(checkpoint_dir, k, tree)
            checkpoint.prune(checkpoint_dir, keep=2)
            committed = k

    todo = [i for i in range(n_chunks) if done[i] is None]
    if stop_after_chunks is not None:
        todo = todo[:max(0, stop_after_chunks - resumed)]
    attempts = 0
    env_name = (environment.name if environment is not None
                else getattr(service, "name", None) or "inline")

    def land(i, out, meta, n_done):
        nonlocal attempts
        done[i] = out["objectives"]
        attempts += len(meta.get("attempts") or ()) or 1
        if record is not None:
            record.tasks.append(TaskRecord(
                task=task.name, capsule=i, environment=env_name,
                inputs_digest=digest(i),
                started_s=meta.get("t0", t0) - t0,
                wall_s=meta.get("wall_s", 0.0),
                retries=meta.get("retries", 0), cache_hit=False,
                mode="stream",
                attempts=list(meta.get("attempts") or ()) or None))
        commit()
        if progress:
            progress(resumed + n_done, n_chunks)

    if service is not None:
        if todo:
            tids = service.submit_tasks(
                experiment_id,
                [(task, Context(chunk=i, size=sizes[i])) for i in todo])
            tid_to_i = dict(zip(tids, todo))
            for n_done, (tid, out) in enumerate(
                    service.as_completed(experiment_id, tids), 1):
                if out is None:
                    service.result(experiment_id, tid)  # raises the error
                land(tid_to_i[tid], out, {"retries": 0, "wall_s": 0.0},
                     n_done)
    elif environment is None:
        for n_done, i in enumerate(todo, 1):
            a_t0 = time.monotonic()
            out = task.run(Context(chunk=i, size=sizes[i]))
            land(i, out, {"t0": a_t0, "wall_s": time.monotonic() - a_t0,
                          "retries": 0}, n_done)
    elif todo:
        import concurrent.futures as cf
        futures = {environment.submit_async(
            task, Context(chunk=i, size=sizes[i])): i for i in todo}
        for n_done, f in enumerate(cf.as_completed(futures), 1):
            out, meta = f.result()
            land(futures[f], out, meta, n_done)

    commit(force=True)
    n_ready = sum(d is not None for d in done)
    if n_ready < n_chunks:
        return StreamingResult(
            genomes=None, objectives=None, chunks_done=n_ready,
            chunks_total=n_chunks, resumed_chunks=resumed, interrupted=True,
            attempts=attempts, wall_s=time.monotonic() - t0)
    genomes = torch.cat([population_chunk(cfg, seed, i, sizes[i], dev)
                         for i in range(n_chunks)]).cpu().numpy()
    return StreamingResult(
        genomes=genomes, objectives=np.concatenate(done, axis=0),
        chunks_done=n_chunks, chunks_total=n_chunks, resumed_chunks=resumed,
        interrupted=False, attempts=attempts,
        wall_s=time.monotonic() - t0)


def select_top_streaming(cfg: NSGA2Config, genomes, objectives, k: int,
                         block: int = 2048, device="cuda"):
    """Top ``k`` of an archive-scale population by (rank, -crowding),
    hierarchically: the O(N^2) dominance pass runs per block of ``block``
    rows, and block winners compete again, so 200k individuals never enter
    one quadratic pass. ``genomes`` (N, D) and ``objectives`` (N, M) are
    arrays or tensors; the ranking runs on ``device``, and the picks come
    back as tensors there. Ties in the truncation key keep row order, as
    the reference's stable argsort does."""
    dev = resolve_device(device)
    g = torch.as_tensor(genomes, dtype=torch.float32).to(dev)
    o = torch.as_tensor(objectives, dtype=torch.float32).to(dev)

    def top(gi, oi, kk):
        valid = torch.ones((len(oi),), dtype=torch.bool, device=dev)
        ranks = nsga2.nondominated_ranks(oi, valid)
        crowd = nsga2.crowding_distance(oi, ranks)
        key = nsga2.truncation_key(ranks, crowd, valid)
        idx = torch.argsort(key, stable=True)[:kk]
        return gi[idx], oi[idx]

    while len(g) > max(k, block):
        picks = [top(g[lo:lo + block], o[lo:lo + block],
                     min(k, block, len(g) - lo))
                 for lo in range(0, len(g), block)]
        g2 = torch.cat([p[0] for p in picks])
        if len(g2) >= len(g):
            break
        g, o = g2, torch.cat([p[1] for p in picks])
    return top(g, o, min(k, len(g)))


def init_state_from_population(cfg: NSGA2Config, genomes, objectives,
                               device="cuda") -> GAState:
    """A one-island GAState seeded from an already evaluated population
    (the streamed init): the best ``mu`` by NSGA-II truncation become the
    population; ``evaluations`` counts the whole population."""
    g, o = select_top_streaming(cfg, genomes, objectives, cfg.mu,
                                device=device)
    n = len(objectives)
    return GAState(
        genomes=g[None],
        objectives=o[None],
        valid=torch.ones((1, len(g)), dtype=torch.bool, device=g.device),
        generation=torch.zeros((1,), dtype=torch.int32, device=g.device),
        evaluations=torch.full((1,), n, dtype=torch.int32, device=g.device),
    )
