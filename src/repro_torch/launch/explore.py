"""The paper-centric entry point, ported from ``repro.launch.explore``:
calibrate the ants model on CUDA devices with island-model NSGA-II
(default), the surrogate-assisted GP ask/tell engine, its multi-objective
qEHVI form, or both a streaming GA init and a surrogate run as tenants of
one exploration service; checkpointed per epoch or round, or journalled
(restart-safe).

    PYTHONPATH=src python -m repro_torch.launch.explore --islands 8 \\
        --epochs 5 --out /tmp/ants_calibration              # on the card

    PYTHONPATH=src python -m repro_torch.launch.explore --method surrogate \\
        --rounds 8 --out /tmp/ants_surrogate                # on the card

    PYTHONPATH=src python -m repro_torch.launch.explore \\
        --method surrogate-mo --rounds 8 --out /tmp/ants_mo # on the card

    PYTHONPATH=src python -m repro_torch.launch.explore --method service \\
        --fault-rate 0.3 --out /tmp/ants_service            # on the card

    PYTHONPATH=src python -m repro_torch.launch.explore --reduced \\
        --device cpu --out /tmp/ants_cpu                    # plain path

    PYTHONPATH=src python -m repro_torch.launch.explore \\
        --init-population 200000 --init-chunk 4096 --fault-rate 0.3 \\
        --pipeline --out /tmp/ants_200k     # the paper's 200k init first

    torchrun --nproc-per-node 4 -m repro_torch.launch.explore \\
        --distributed --mesh data=4 --out /tmp/ants_mesh  # 4 cards, NCCL

    PYTHONPATH=src python -m repro_torch.launch.explore --device cpu \\
        --reduced --distributed --coordinator 127.0.0.1:29500 \\
        --num-processes 2 --process-id 0 --mesh data=2 --out /tmp/m &
    PYTHONPATH=src python -m repro_torch.launch.explore --device cpu \\
        --reduced --distributed --coordinator 127.0.0.1:29500 \\
        --num-processes 2 --process-id 1 --mesh data=2 --out /tmp/m
                                            # two gloo ranks on the CPU

Islands write ``pareto_front.json``, ``provenance.json`` and
``populations/`` (and ``init_checkpoints/`` with ``--init-population``);
the surrogate writes ``surrogate_result.json`` and ``provenance.json``, the
multi-objective surrogate ``surrogate_mo_result.json`` and
``provenance.json``, the service ``service_result.json``,
``provenance_ga-init.json``, ``provenance_surrogate.json``, its queue's
journal ``queue.jsonl`` and its task cache ``cache/``; all with the
reference's keys; with a mesh of several ranks, rank 0 alone writes them.
A rerun with the same ``--out`` resumes from the last committed epoch or
round, and refuses to when the checkpoint was written by a run of other
settings (model config, widths, replicates, device; not the mesh, which
changes where the work runs and not its result); the service resumes from
its journal and cache, where a firing of other settings has another
content address and runs anew.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import checkpoint
from repro_torch.ants import simulate_batch
from repro_torch.configs.ants_netlogo import BOUNDS, CONFIG, REDUCED
from repro_torch.core import (Context, EnvironmentPool, FaultSpec,
                              LocalEnvironment, SavePopulationHook,
                              make_device_members)
from repro_torch.core.cache import hash_value
from repro_torch.core.scheduler import RunRecord, TaskRecord, _utcnow
from repro_torch.evolution import (Archive, NSGA2Config, ga,
                                   init_island_state, pareto_front,
                                   run_islands)
from repro_torch.explore import replicated_batch
from repro_torch.explore.moacq import MOSurrogateConfig, run_surrogate_mo
from repro_torch.explore.surrogate import SurrogateConfig, run_surrogate
from repro_torch.launch.mesh import (init_distributed, make_host_mesh,
                                     make_island_mesh)
from repro_torch.runtime.device import make_generator, resolve_device
from repro_torch.runtime.sharding import mesh_group


def make_init_pool(fault_rate: float = 0.0, *, workers: int = 3,
                   capacity: int = 2, retries: int = 8,
                   backoff_s: float = 0.05, timeout_s: float = None,
                   pool_devices: int = 0, device="cuda") -> EnvironmentPool:
    """The local evaluation pool: a few thread-backed workers, optionally
    with an injected per-attempt failure rate (the paper's unreliable-EGI
    regime, reproduced on one host).

    ``pool_devices=k`` makes the members ``k`` ``DeviceEnvironment``s over
    disjoint sets of the local devices of ``device``'s type (each card, or
    the CPU), so the init's and the surrogate's jobs spread over the
    cards; ``workers`` and ``capacity`` are then unused (capacity is two
    per device)."""
    faults = ((lambda i: FaultSpec(fail_rate=fault_rate, seed=i))
              if fault_rate > 0 else lambda i: None)
    if pool_devices:
        envs = make_device_members(None, pool_devices, device=device,
                                   timeout_s=timeout_s, faults=faults)
    else:
        envs = [LocalEnvironment(name=f"worker{i}", capacity=capacity,
                                 timeout_s=timeout_s, faults=faults(i))
                for i in range(workers)]
    return EnvironmentPool(envs, retries=retries, backoff_s=backoff_s)


def ants_eval_fn(ants_cfg, replicates: int):
    """(generator, genomes (L, 2), rows=None) -> (L, 3) replicated-median
    times to deplete each food source, the paper's three calibration
    objectives (``rows``: see ``replicated_batch``)."""
    def lanes(gen, genomes, rows=None):
        # rows= only for a block of islands, so a simulator that takes no
        # rows still serves a one-rank run
        kw = {} if rows is None else {"rows": rows}
        return simulate_batch(ants_cfg, genomes[:, 0], genomes[:, 1],
                              generator=gen, **kw)

    return replicated_batch(lanes, replicates)


def _streaming_init(ga_cfg, eval_fn, n_total, chunk, k, pool, record, dev,
                    settings, checkpoint_dir, printer):
    """The paper-scale streaming init through ``pool`` (shut down after),
    then its best ``k`` by NSGA-II truncation: (StreamingResult, genomes,
    objectives)."""
    try:
        sres = ga.evaluate_population_streaming(
            ga_cfg, eval_fn, 0, n_total=n_total, chunk=chunk,
            environment=pool, record=record, device=dev, settings=settings,
            checkpoint_dir=checkpoint_dir,
            progress=lambda i, n: printer(
                f"[explore] init chunk {i}/{n}") if i % 8 == 0 else None)
    finally:
        pool.shutdown()
    printer(f"[explore] init: {n_total} individuals in "
            f"{sres.wall_s:.1f}s ({sres.attempts} attempts, "
            f"{sres.resumed_chunks} chunks resumed) -> "
            f"{n_total / max(sres.wall_s, 1e-9) * 3600:.0f} evals/hour")
    top_g, top_o = ga.select_top_streaming(ga_cfg, sres.genomes,
                                           sres.objectives, k, device=dev)
    return sres, top_g, top_o


def calibrate(*, reduced: bool = True, n_islands: int = 8, mu: int = 16,
              lam: int = 16, steps_per_epoch: int = 4, epochs: int = 5,
              replicates: int = 5, archive_size: int = 256,
              merge_top_k: int = 8, out_dir: str,
              pipeline: bool = False, reseed_frac: float = 0.5,
              epochs_per_superstep: int = 0, init_population: int = 0,
              init_chunk: int = 2048, fault_rate: float = 0.0,
              pool_devices: int = 0, device="cuda", mesh=None,
              printer=print):
    """Island-model NSGA-II calibration of the ants model on ``device``.
    With ``init_population`` the islands are seeded from the best
    ``n_islands * mu`` of that many individuals, evaluated first in chunks
    of ``init_chunk`` through the environment pool of ``make_init_pool``
    (``fault_rate``: its injected per-attempt failure rate;
    ``pool_devices``: its device-set members), checkpointed under
    ``out_dir/init_checkpoints``.

    ``mesh`` (``launch.mesh.make_island_mesh``; default the process
    group's ranks, one without one): every rank calls ``calibrate`` alike
    and runs on the mesh's device; the islands spread over the ranks
    (``run_islands``), rank 0 alone runs the init and broadcasts its
    picks, and rank 0 alone writes ``out_dir``. Every rank returns (final
    IslandState, the pareto_front.json dict)."""
    if mesh is None:
        mesh = make_host_mesh(device)
    want = resolve_device(device)
    other_card = (want.index is not None and mesh.device.index is not None
                  and want.index != mesh.device.index)
    if mesh.device.type != want.type or other_card:
        raise ValueError(f"mesh on {mesh.device}, device={device!r}")
    dev = mesh.device
    group, _, rank = mesh_group(mesh)
    if init_population and init_population < n_islands * mu:
        raise ValueError(
            f"--init-population must cover the island populations: need "
            f">= n_islands*mu = {n_islands * mu}, got {init_population}")
    ants_cfg = REDUCED if reduced else CONFIG
    ga_cfg = NSGA2Config(mu=mu, genome_dim=2, bounds=BOUNDS, n_objectives=3)
    eval_fn = ants_eval_fn(ants_cfg, replicates)
    generator = make_generator(0, dev)
    os.makedirs(out_dir, exist_ok=True)
    pop_hook = (SavePopulationHook(os.path.join(out_dir, "populations"))
                if rank == 0 else None)
    ckpt_dir = os.path.join(out_dir, "checkpoints")

    # what a checkpoint must match to be resumed (epochs may grow; the
    # superstep grain, the mesh, the pool's devices and the fault rate
    # change when or where work runs, never its result)
    common = {"ants": dataclasses.asdict(ants_cfg), "device": dev.type,
              "replicates": replicates}
    init_settings = json.dumps(dict(
        common, init_population=init_population, init_chunk=init_chunk,
        seed=0), sort_keys=True)
    settings = dict(
        common, n_islands=n_islands, mu=mu, lam=lam,
        steps_per_epoch=steps_per_epoch, archive_size=archive_size,
        merge_top_k=merge_top_k, reseed_frac=reseed_frac, pipeline=pipeline,
        init=({"population": init_population, "chunk": init_chunk}
              if init_population else None))
    settings_json = json.dumps(settings, sort_keys=True)
    cfg_digest = hash_value(settings)

    # restart-safe: resume island state and generator from the last epoch
    start = None
    if (last := checkpoint.latest_step(ckpt_dir)) is not None:
        like = {"state": init_island_state(
                    ga_cfg, torch.Generator(device=dev), n_islands=n_islands,
                    archive_size=archive_size, device=dev),
                "rng": None, "settings": None}
        saved = checkpoint.restore(ckpt_dir, last, like, device=dev)
        checkpoint.require_settings(ckpt_dir, saved["settings"].item(),
                                    settings_json)
        start = saved["state"]
        generator.set_state(torch.from_numpy(saved["rng"]))
        printer(f"[explore] resumed at epoch {last}")

    # run-record provenance (the reference's schema): one TaskRecord per
    # committed epoch, resumed epochs marked cache hits
    record = RunRecord(
        workflow="ants-calibration",
        scheduler="islands-pipelined" if pipeline else "islands",
        environment=f"mesh{mesh.shape}", started_at=_utcnow())
    run_t0 = time.monotonic()
    last_epoch_t = [run_t0]
    if start is not None:
        for e in range(1, int(last) + 1):
            record.tasks.append(TaskRecord(
                task="island_epoch", capsule=e,
                environment=record.environment, inputs_digest=cfg_digest,
                started_s=0.0, wall_s=0.0, retries=0, cache_hit=True,
                mode="cache"))

    def on_epoch(state, rng):
        # rank 0 only. state: a CPU snapshot of the boundary (every
        # island); rng: the generator there
        e = state.epoch
        checkpoint.save(ckpt_dir, e, {"state": state, "rng": rng.numpy(),
                                      "settings": settings_json})
        now = time.monotonic()
        record.tasks.append(TaskRecord(
            task="island_epoch", capsule=e, environment=record.environment,
            inputs_digest=cfg_digest, started_s=last_epoch_t[0] - run_t0,
            wall_s=now - last_epoch_t[0], retries=0, cache_hit=False,
            mode="pipelined" if pipeline else "lanes"))
        last_epoch_t[0] = now
        mask = pareto_front(Archive(*(t.to(dev) for t in state.archive)))
        mask = mask.cpu().numpy()
        obj = state.archive.objectives.numpy()
        pop_hook(Context(generation=e,
                         genomes=state.archive.genomes.numpy(),
                         objectives=obj))
        printer(f"[explore] epoch {e}: evals={state.total_evaluations} "
                f"front={int(mask.sum())} "
                f"best t1={obj[mask, 0].min() if mask.any() else float('nan'):.0f}")

    # the paper-scale streaming init: evaluate a large initial population
    # through the (optionally fault-injected) pool, in chunks, with
    # mid-population checkpoint/resume; seed the islands from its best.
    # Skipped when resuming an island checkpoint (its state embodies it).
    init_record = None
    if init_population and start is None:
        if rank == 0:
            init_record, top_g, top_o = _streaming_init(
                ga_cfg, eval_fn, init_population, init_chunk, n_islands * mu,
                make_init_pool(fault_rate, pool_devices=pool_devices,
                               device=dev.type),
                # device-set members pin each job to a card of theirs: the
                # jobs then make their tensors on the bare "cuda" device
                record, torch.device(dev.type) if pool_devices else dev,
                init_settings,
                os.path.join(out_dir, "init_checkpoints"), printer)
        else:
            top_g = torch.empty((n_islands * mu, ga_cfg.genome_dim),
                                device=dev)
            top_o = torch.empty((n_islands * mu, ga_cfg.n_objectives),
                                device=dev)
        if group is not None:
            dist.broadcast(top_g, src=0, group=group)
            dist.broadcast(top_o, src=0, group=group)
        # a throwaway generator: the run's own draws start at the islands
        st0 = init_island_state(ga_cfg, torch.Generator(device=dev),
                                n_islands=n_islands,
                                archive_size=archive_size, device=dev)
        islands = st0.islands._replace(
            genomes=top_g.reshape(n_islands, mu, -1),
            objectives=top_o.reshape(n_islands, mu, -1),
            valid=torch.ones((n_islands, mu), dtype=torch.bool, device=dev))
        # epoch-0 accounting adds n_islands*mu for the (skipped) initial
        # evaluation; pre-subtract so the total counts init_population once
        start = st0._replace(
            islands=islands,
            total_evaluations=init_population - n_islands * mu)

    t0 = time.time()
    state = run_islands(
        ga_cfg, eval_fn, generator, n_islands=n_islands, lam=lam,
        steps_per_epoch=steps_per_epoch, epochs=epochs,
        archive_size=archive_size, checkpoint_fn=on_epoch,
        merge_top_k=min(merge_top_k, mu), reseed_frac=reseed_frac,
        pipeline=pipeline, epochs_per_superstep=epochs_per_superstep,
        start_state=start, device=dev, mesh=mesh)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    evals = state.total_evaluations
    printer(f"[explore] done: {evals} evaluations in {dt:.1f}s "
            f"({evals / max(dt, 1e-9) * 3600:.0f} evals/hour on {dev}, "
            f"mesh {mesh.shape}, rank {rank})")

    mask = pareto_front(state.archive).cpu().numpy()
    front = {
        "genomes": state.archive.genomes.cpu().numpy()[mask].tolist(),
        "objectives": state.archive.objectives.cpu().numpy()[mask].tolist(),
        "evaluations": evals,
        "wall_s": dt,
    }
    if init_record is not None:
        front["init"] = {"n_individuals": init_population,
                         "wall_s": init_record.wall_s,
                         "attempts": init_record.attempts,
                         "resumed_chunks": init_record.resumed_chunks,
                         "fault_rate": fault_rate}
    if rank == 0:
        with open(os.path.join(out_dir, "pareto_front.json"), "w") as f:
            json.dump(front, f, indent=2)
        record.finalize(dt)
        record.save(os.path.join(out_dir, "provenance.json"))
    return state, front


def ants_scalar_eval(reduced: bool = True, replicates: int = 3,
                     objective: int = 0):
    """(generator, genomes (n, 2)) -> (n,) scalar fitness for the
    surrogate: the replicated-median time to deplete food source
    ``objective`` (minimize); ``objective=None`` averages all three."""
    batch = ants_eval_fn(REDUCED if reduced else CONFIG, replicates)

    def eval_fn(generator, genomes):
        obj = batch(generator, genomes)
        return obj.mean(dim=-1) if objective is None else obj[:, objective]

    return eval_fn


def calibrate_surrogate(*, reduced: bool = True, rounds: int = 8, q: int = 8,
                        n_init: int = 16, replicates: int = 3,
                        acquisition: str = "qei", fault_rate: float = 0.0,
                        pool_devices: int = 0, out_dir: str, device="cuda",
                        printer=print):
    """Surrogate-assisted calibration of the ants model on ``device``: Sobol
    seeding, then GP + q-EI rounds streamed through the fault-tolerant
    environment pool (``pool_devices``: its device-set members; see
    ``make_init_pool``), checkpointed per round (restart-safe; a checkpoint
    of other settings is refused), with the reference's provenance schema.
    Returns (SurrogateResult, the surrogate_result.json dict)."""
    dev = resolve_device(device)
    ants_cfg = REDUCED if reduced else CONFIG
    os.makedirs(out_dir, exist_ok=True)
    cfg = SurrogateConfig(bounds=BOUNDS, q=q, n_init=n_init,
                          acquisition=acquisition, seed=0)
    # what a checkpoint must match to be resumed (rounds may grow; the
    # fault rate changes where jobs run, never what they return)
    settings = json.dumps({
        "ants": dataclasses.asdict(ants_cfg), "device": dev.type,
        "surrogate": dataclasses.asdict(cfg), "replicates": replicates},
        sort_keys=True)
    record = RunRecord(workflow="ants-surrogate", scheduler="ask-tell",
                       environment="pool", started_at=_utcnow())
    pool = make_init_pool(fault_rate, pool_devices=pool_devices,
                          device=dev.type)
    t0 = time.time()
    try:
        res = run_surrogate(
            cfg, ants_scalar_eval(reduced, replicates), rounds=rounds,
            environment=pool, record=record, device=dev, settings=settings,
            checkpoint_dir=os.path.join(out_dir, "surrogate_checkpoints"),
            progress=lambda r, n: printer(f"[explore] round {r}/{n}"))
    finally:
        pool.shutdown()
    dt = time.time() - t0
    printer(f"[explore] surrogate: {len(res.objectives)} evaluations in "
            f"{dt:.1f}s ({res.attempts} attempts, {res.repriorities} "
            f"re-prioritizations, {res.resumed_rounds} rounds resumed) on "
            f"{dev}; best {res.best_objective:.1f} at {res.best_genome}")
    out = {
        "best_genome": np.asarray(res.best_genome).tolist(),
        "best_objective": res.best_objective,
        "genomes": np.asarray(res.genomes).tolist(),
        "objectives": np.asarray(res.objectives).tolist(),
        "rounds": res.rounds_done,
        "attempts": res.attempts,
        "repriorities": res.repriorities,
        "fault_rate": fault_rate,
        "wall_s": dt,
    }
    with open(os.path.join(out_dir, "surrogate_result.json"), "w") as f:
        json.dump(out, f, indent=2)
    record.finalize(dt)
    record.save(os.path.join(out_dir, "provenance.json"))
    return res, out


def ants_mo_eval(reduced: bool = True, replicates: int = 3):
    """(generator, genomes (n, 2)) -> (n, 3) replicated-median times to
    deplete each food source, the paper's three calibration objectives,
    fed raw to the multi-objective surrogate (all minimized)."""
    return ants_eval_fn(REDUCED if reduced else CONFIG, replicates)


def calibrate_surrogate_mo(*, reduced: bool = True, rounds: int = 8,
                           q: int = 8, n_init: int = 16, replicates: int = 3,
                           fault_rate: float = 0.0, pool_devices: int = 0,
                           out_dir: str, device="cuda", printer=print):
    """Multi-objective surrogate calibration of the ants model on
    ``device``: per-objective GPs + qEHVI batches bred from the NSGA-II
    Pareto archive (``explore.moacq``), streamed through the fault-tolerant
    environment pool (``make_init_pool``), checkpointed per round
    (restart-safe; a checkpoint of other settings is refused), with the
    reference's provenance schema. Returns (MOSurrogateResult, the
    surrogate_mo_result.json dict)."""
    dev = resolve_device(device)
    ants_cfg = REDUCED if reduced else CONFIG
    os.makedirs(out_dir, exist_ok=True)
    cfg = MOSurrogateConfig(bounds=BOUNDS, n_objectives=3, q=q,
                            n_init=n_init, seed=0)
    settings = json.dumps({
        "ants": dataclasses.asdict(ants_cfg), "device": dev.type,
        "surrogate_mo": dataclasses.asdict(cfg), "replicates": replicates},
        sort_keys=True)
    record = RunRecord(workflow="ants-surrogate-mo", scheduler="ask-tell",
                       environment="pool", started_at=_utcnow())
    pool = make_init_pool(fault_rate, pool_devices=pool_devices,
                          device=dev.type)
    t0 = time.time()
    try:
        res = run_surrogate_mo(
            cfg, ants_mo_eval(reduced, replicates), rounds=rounds,
            environment=pool, record=record, device=dev, settings=settings,
            checkpoint_dir=os.path.join(out_dir, "surrogate_checkpoints"),
            progress=lambda r, n: printer(f"[explore] round {r}/{n}"))
    finally:
        pool.shutdown()
    dt = time.time() - t0
    printer(f"[explore] surrogate-mo: {len(res.objectives)} evaluations in "
            f"{dt:.1f}s ({res.attempts} attempts, {res.resumed_rounds} "
            f"rounds resumed) on {dev}; front {len(res.front_objectives)} "
            f"points, hypervolume {res.hv:.3g}")
    out = {
        "front_genomes": np.asarray(res.front_genomes).tolist(),
        "front_objectives": np.asarray(res.front_objectives).tolist(),
        "hypervolume": res.hv,
        "genomes": np.asarray(res.genomes).tolist(),
        "objectives": np.asarray(res.objectives).tolist(),
        "rounds": res.rounds_done,
        "attempts": res.attempts,
        "fault_rate": fault_rate,
        "wall_s": dt,
    }
    with open(os.path.join(out_dir, "surrogate_mo_result.json"), "w") as f:
        json.dump(out, f, indent=2)
    record.finalize(dt)
    record.save(os.path.join(out_dir, "provenance.json"))
    return res, out


def calibrate_service(*, reduced: bool = True, init_population: int = 2048,
                      init_chunk: int = 256, rounds: int = 4, q: int = 8,
                      n_init: int = 16, replicates: int = 3,
                      fault_rate: float = 0.0, pool_devices: int = 0,
                      out_dir: str, device="cuda", printer=print):
    """Service mode on ``device``: TWO experiments, a streaming GA-population
    init and a surrogate calibration, run concurrently as tenants of ONE
    ``ExplorationService`` over one shared environment pool
    (``make_init_pool``). The queue journals to ``<out>/queue.jsonl`` and
    outputs memoize under ``<out>/cache``, so killing this driver mid-run
    and rerunning it resumes both tenants without re-executing finished
    work. Returns ({"ga": StreamingResult, "surrogate": SurrogateResult},
    the service_result.json dict)."""
    import threading

    from repro_torch.core import ExplorationService

    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    ants_cfg = REDUCED if reduced else CONFIG
    ga_cfg = NSGA2Config(mu=16, genome_dim=2, bounds=BOUNDS, n_objectives=3)
    sur_cfg = SurrogateConfig(bounds=BOUNDS, q=q, n_init=n_init, seed=0)
    # device-set members pin each job to a card of theirs: the jobs then
    # make their tensors on the bare "cuda" device
    job_dev = torch.device(dev.type) if pool_devices else dev
    pool = make_init_pool(fault_rate, pool_devices=pool_devices,
                          device=dev.type)
    service = ExplorationService(
        pool, cache=os.path.join(out_dir, "cache"),
        journal=os.path.join(out_dir, "queue.jsonl"))
    results: dict = {}
    errors: list = []

    def ga_tenant():
        try:
            results["ga"] = ga.evaluate_population_streaming(
                ga_cfg, ants_eval_fn(ants_cfg, replicates), 0,
                n_total=init_population, chunk=init_chunk, service=service,
                experiment_id="ga-init", device=job_dev)
        except Exception as e:            # surfaced after join
            errors.append(e)

    def surrogate_tenant():
        try:
            results["surrogate"] = run_surrogate(
                sur_cfg, ants_scalar_eval(reduced, replicates),
                rounds=rounds, service=service, experiment_id="surrogate",
                device=job_dev)
        except Exception as e:            # surfaced after join
            errors.append(e)

    t0 = time.time()
    tenants = [threading.Thread(target=ga_tenant, name="tenant-ga"),
               threading.Thread(target=surrogate_tenant,
                                name="tenant-surrogate")]
    try:
        for t in tenants:
            t.start()
        for t in tenants:
            t.join()
    finally:
        for eid in ("ga-init", "surrogate"):
            service.record(eid).save(
                os.path.join(out_dir, f"provenance_{eid}.json"))
        service.shutdown()
        pool.shutdown()
    if errors:
        raise errors[0]
    dt = time.time() - t0
    sres, rres = results["ga"], results["surrogate"]
    n_jobs = sres.chunks_done + rres.rounds_done * q
    printer(f"[explore] service: 2 tenants, {n_jobs} jobs through one pool "
            f"in {dt:.1f}s on {dev}: init {init_population} individuals "
            f"({sres.attempts} attempts), surrogate best "
            f"{rres.best_objective:.1f} at {rres.best_genome} "
            f"({rres.repriorities} queue re-prioritizations)")
    out = {
        "init": {"n_individuals": init_population,
                 "attempts": sres.attempts, "wall_s": sres.wall_s},
        "surrogate": {"best_genome": np.asarray(rres.best_genome).tolist(),
                      "best_objective": rres.best_objective,
                      "repriorities": rres.repriorities,
                      "wall_s": rres.wall_s},
        "queue": service.query(),
        "fault_rate": fault_rate,
        "wall_s": dt,
    }
    with open(os.path.join(out_dir, "service_result.json"), "w") as f:
        json.dump(out, f, indent=2)
    return results, out


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Calibration of the ants model (PyTorch/CUDA port).")
    ap.add_argument("--method",
                    choices=("islands", "surrogate", "surrogate-mo",
                             "service"), default="islands",
                    help="islands: island-model NSGA-II; surrogate: GP + "
                         "q-EI ask/tell through the environment pool; "
                         "surrogate-mo: per-objective GPs + qEHVI batches "
                         "bred from the Pareto archive; service: GA init + "
                         "surrogate calibration concurrently through one "
                         "shared ExplorationService (restart-safe queue)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain versions of "
                         "the kernels")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--islands", type=int, default=8)
    ap.add_argument("--mu", type=int, default=16)
    ap.add_argument("--lam", type=int, default=16)
    ap.add_argument("--steps-per-epoch", type=int, default=4)
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--replicates", type=int, default=5)
    ap.add_argument("--reseed-frac", type=float, default=0.5)
    ap.add_argument("--pipeline", action="store_true",
                    help="pipelined epochs: the reseed feeding epoch k+1 "
                         "reads the archive of epoch k-1, so evolve(k+1) "
                         "does not wait for merge(k) (EGI-style)")
    ap.add_argument("--superstep", type=int, default=0,
                    help="epochs between checkpoints (0 = 1 per "
                         "checkpoint)")
    ap.add_argument("--init-population", type=int, default=0,
                    help="evaluate a large initial population (the paper's "
                         "200000) through the fault-tolerant environment "
                         "pool before the island run, streaming in "
                         "--init-chunk jobs with mid-population "
                         "checkpoint/resume; islands seed from its best "
                         "(--method service: the GA tenant's population, "
                         "2048 when not given)")
    ap.add_argument("--init-chunk", type=int, default=2048,
                    help="individuals per init job (capped at 256 for "
                         "--method service)")
    ap.add_argument("--fault-rate", type=float, default=0.0,
                    help="injected per-attempt job-failure rate of the "
                         "evaluation pool (the init's or the surrogate's; "
                         "results stay bit-exact)")
    ap.add_argument("--out",
                    default=os.path.join(tempfile.gettempdir(), "repro_ants"),
                    help="output and checkpoint directory (default: "
                         "repro_ants under the temporary directory)")
    ap.add_argument("--mesh", default="",
                    help="island mesh over the ranks, e.g. data=4 or "
                         "pod=2,data=2 (data=0: every rank); needs that "
                         "many ranks (torchrun or --distributed)")
    ap.add_argument("--distributed", action="store_true",
                    help="join a process group: through env:// (torchrun) "
                         "or --coordinator/--num-processes/--process-id")
    ap.add_argument("--coordinator", default=None,
                    help="HOST:PORT of rank 0 for the process group")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--pool-devices", type=int, default=0,
                    help="split the local devices into this many disjoint "
                         "DeviceEnvironment pool members (0 = thread-backed "
                         "members on the default device) for the init's "
                         "and the surrogate's jobs")
    ap.add_argument("--rounds", type=int, default=8,
                    help="surrogate ask/tell rounds (of --q proposals each)")
    ap.add_argument("--q", type=int, default=8,
                    help="surrogate proposals per round (q-EI batch size)")
    ap.add_argument("--n-init", type=int, default=16,
                    help="Sobol space-filling evaluations seeding the GP")
    ap.add_argument("--acquisition", choices=("qei", "qucb"), default="qei")
    args = ap.parse_args(argv)
    joined = False
    if args.distributed or args.num_processes or args.coordinator:
        joined = init_distributed(
            coordinator=args.coordinator, num_processes=args.num_processes,
            process_id=args.process_id, force=args.distributed,
            backend=("gloo" if torch.device(args.device).type == "cpu"
                     else None))
    try:
        mesh = None
        if args.mesh:
            spec = dict(kv.split("=") for kv in args.mesh.split(","))
            try:
                mesh = make_island_mesh(pod=int(spec.get("pod", 1)),
                                        data=int(spec.get("data", 0)),
                                        device=args.device)
            except ValueError as e:
                ap.error(f"--mesh {args.mesh}: {e}")
        if args.method == "service":
            calibrate_service(reduced=args.reduced,
                              init_population=args.init_population or 2048,
                              init_chunk=min(args.init_chunk, 256),
                              rounds=args.rounds, q=args.q,
                              n_init=args.n_init, replicates=args.replicates,
                              fault_rate=args.fault_rate,
                              pool_devices=args.pool_devices,
                              out_dir=args.out, device=args.device)
            return
        if args.method == "surrogate-mo":
            calibrate_surrogate_mo(reduced=args.reduced, rounds=args.rounds,
                                   q=args.q, n_init=args.n_init,
                                   replicates=args.replicates,
                                   fault_rate=args.fault_rate,
                                   pool_devices=args.pool_devices,
                                   out_dir=args.out, device=args.device)
            return
        if args.method == "surrogate":
            calibrate_surrogate(reduced=args.reduced, rounds=args.rounds,
                                q=args.q, n_init=args.n_init,
                                replicates=args.replicates,
                                acquisition=args.acquisition,
                                fault_rate=args.fault_rate,
                                pool_devices=args.pool_devices,
                                out_dir=args.out, device=args.device)
            return
        calibrate(reduced=args.reduced, n_islands=args.islands, mu=args.mu,
                  lam=args.lam, steps_per_epoch=args.steps_per_epoch,
                  epochs=args.epochs, replicates=args.replicates,
                  mesh=mesh, pipeline=args.pipeline,
                  reseed_frac=args.reseed_frac,
                  epochs_per_superstep=args.superstep,
                  init_population=args.init_population,
                  init_chunk=args.init_chunk, fault_rate=args.fault_rate,
                  pool_devices=args.pool_devices, out_dir=args.out,
                  device=args.device)
    finally:
        if joined:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
