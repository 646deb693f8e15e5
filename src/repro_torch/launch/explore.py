"""The paper-centric entry point, ported from ``repro.launch.explore``: calibrate
the ants model with island-model NSGA-II on one CUDA device, checkpointed
per epoch (restart-safe).

    PYTHONPATH=src python -m repro_torch.launch.explore --islands 8 \\
        --epochs 5 --out /tmp/ants_calibration              # on the card

    PYTHONPATH=src python -m repro_torch.launch.explore --reduced \\
        --device cpu --out /tmp/ants_cpu                    # plain path

Writes ``pareto_front.json``, ``provenance.json`` and ``populations/`` with
the reference's keys; a rerun with the same ``--out`` resumes from the last
committed epoch, and refuses to when the checkpoint was written by a run of
other settings (model config, GA widths, replicates, device). Methods and flags whose machinery is not ported yet stop
with an error naming them.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time

import torch

from repro_torch import checkpoint
from repro_torch.ants import simulate_batch
from repro_torch.configs.ants_netlogo import BOUNDS, CONFIG, REDUCED
from repro_torch.core import Context, SavePopulationHook
from repro_torch.core.cache import hash_value
from repro_torch.core.scheduler import RunRecord, TaskRecord, _utcnow
from repro_torch.evolution import (NSGA2Config, init_island_state,
                                   pareto_front, run_islands)
from repro_torch.explore import replicated_batch
from repro_torch.runtime.device import make_generator, resolve_device


def ants_eval_fn(ants_cfg, replicates: int):
    """(generator, genomes (L, 2)) -> (L, 3) replicated-median times to
    deplete each food source, the paper's three calibration objectives."""
    return replicated_batch(
        lambda gen, genomes: simulate_batch(ants_cfg, genomes[:, 0],
                                            genomes[:, 1], generator=gen),
        replicates)


def calibrate(*, reduced: bool = True, n_islands: int = 8, mu: int = 16,
              lam: int = 16, steps_per_epoch: int = 4, epochs: int = 5,
              replicates: int = 5, archive_size: int = 256,
              merge_top_k: int = 8, out_dir: str,
              reseed_frac: float = 0.5, device="cuda", printer=print):
    """Island-model NSGA-II calibration of the ants model on ``device``.
    Returns (final IslandState, the pareto_front.json dict)."""
    dev = resolve_device(device)
    ants_cfg = REDUCED if reduced else CONFIG
    ga_cfg = NSGA2Config(mu=mu, genome_dim=2, bounds=BOUNDS, n_objectives=3)
    eval_fn = ants_eval_fn(ants_cfg, replicates)
    generator = make_generator(0, dev)
    os.makedirs(out_dir, exist_ok=True)
    pop_hook = SavePopulationHook(os.path.join(out_dir, "populations"))
    ckpt_dir = os.path.join(out_dir, "checkpoints")

    # what a checkpoint must match to be resumed (epochs may grow)
    settings = {
        "ants": dataclasses.asdict(ants_cfg), "device": dev.type,
        "n_islands": n_islands, "mu": mu, "lam": lam,
        "steps_per_epoch": steps_per_epoch, "replicates": replicates,
        "archive_size": archive_size, "merge_top_k": merge_top_k,
        "reseed_frac": reseed_frac}
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
        if (was := saved["settings"].item()) != settings_json:
            was = json.loads(was)
            differ = sorted(k for k in settings | was
                            if settings.get(k) != was.get(k))
            raise ValueError(
                f"{ckpt_dir} holds a run with other settings "
                f"(differing: {', '.join(differ)}); give another out_dir")
        start = saved["state"]
        generator.set_state(torch.from_numpy(saved["rng"]))
        printer(f"[explore] resumed at epoch {last}")

    # run-record provenance (the reference's schema): one TaskRecord per
    # committed epoch, resumed epochs marked cache hits
    record = RunRecord(workflow="ants-calibration", scheduler="islands",
                       environment=f"torch:{dev}", started_at=_utcnow())
    run_t0 = time.monotonic()
    last_epoch_t = [run_t0]
    if start is not None:
        for e in range(1, int(last) + 1):
            record.tasks.append(TaskRecord(
                task="island_epoch", capsule=e,
                environment=record.environment, inputs_digest=cfg_digest,
                started_s=0.0, wall_s=0.0, retries=0, cache_hit=True,
                mode="cache"))

    def on_epoch(state):
        e = state.epoch
        checkpoint.save(ckpt_dir, e, {"state": state,
                                      "rng": generator.get_state().numpy(),
                                      "settings": settings_json})
        now = time.monotonic()
        record.tasks.append(TaskRecord(
            task="island_epoch", capsule=e, environment=record.environment,
            inputs_digest=cfg_digest, started_s=last_epoch_t[0] - run_t0,
            wall_s=now - last_epoch_t[0], retries=0, cache_hit=False,
            mode="lanes"))
        last_epoch_t[0] = now
        mask = pareto_front(state.archive).cpu().numpy()
        obj = state.archive.objectives.cpu().numpy()
        pop_hook(Context(generation=e,
                         genomes=state.archive.genomes.cpu().numpy(),
                         objectives=obj))
        printer(f"[explore] epoch {e}: evals={state.total_evaluations} "
                f"front={int(mask.sum())} "
                f"best t1={obj[mask, 0].min() if mask.any() else float('nan'):.0f}")

    t0 = time.time()
    state = run_islands(
        ga_cfg, eval_fn, generator, n_islands=n_islands, lam=lam,
        steps_per_epoch=steps_per_epoch, epochs=epochs,
        archive_size=archive_size, checkpoint_fn=on_epoch,
        merge_top_k=min(merge_top_k, mu), reseed_frac=reseed_frac,
        start_state=start, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    evals = state.total_evaluations
    printer(f"[explore] done: {evals} evaluations in {dt:.1f}s "
            f"({evals / max(dt, 1e-9) * 3600:.0f} evals/hour on {dev})")

    mask = pareto_front(state.archive).cpu().numpy()
    front = {
        "genomes": state.archive.genomes.cpu().numpy()[mask].tolist(),
        "objectives": state.archive.objectives.cpu().numpy()[mask].tolist(),
        "evaluations": evals,
        "wall_s": dt,
    }
    with open(os.path.join(out_dir, "pareto_front.json"), "w") as f:
        json.dump(front, f, indent=2)
    record.finalize(dt)
    record.save(os.path.join(out_dir, "provenance.json"))
    return state, front


# flags of the reference CLI whose machinery the port does not have yet
_NOT_PORTED = {"pipeline": "--pipeline", "superstep": "--superstep",
               "mesh": "--mesh", "distributed": "--distributed",
               "coordinator": "--coordinator",
               "num_processes": "--num-processes",
               "process_id": "--process-id",
               "init_population": "--init-population",
               "fault_rate": "--fault-rate", "pool_devices": "--pool-devices"}


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Island-model NSGA-II calibration of the ants model "
                    "(PyTorch/CUDA port).")
    ap.add_argument("--method",
                    choices=("islands", "surrogate", "surrogate-mo",
                             "service"), default="islands",
                    help="only 'islands' is ported yet")
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
    ap.add_argument("--out",
                    default=os.path.join(tempfile.gettempdir(), "repro_ants"),
                    help="output and checkpoint directory (default: "
                         "repro_ants under the temporary directory)")
    # the reference's flags whose machinery is not ported yet: given a
    # non-default value they stop the run (--init-chunk only matters with
    # --init-population)
    ap.add_argument("--pipeline", action="store_true")
    ap.add_argument("--superstep", type=int, default=0)
    ap.add_argument("--mesh", default="")
    ap.add_argument("--distributed", action="store_true")
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--init-population", type=int, default=0)
    ap.add_argument("--init-chunk", type=int, default=2048)
    ap.add_argument("--fault-rate", type=float, default=0.0)
    ap.add_argument("--pool-devices", type=int, default=0)
    args = ap.parse_args(argv)
    if args.method != "islands":
        ap.error(f"--method {args.method} is not ported yet (only islands)")
    for dest, flag in _NOT_PORTED.items():
        if getattr(args, dest) not in (None, False, 0, 0.0, ""):
            ap.error(f"{flag} is not ported yet")
    calibrate(reduced=args.reduced, n_islands=args.islands, mu=args.mu,
              lam=args.lam, steps_per_epoch=args.steps_per_epoch,
              epochs=args.epochs, replicates=args.replicates,
              reseed_frac=args.reseed_frac, out_dir=args.out,
              device=args.device)


if __name__ == "__main__":
    main()
