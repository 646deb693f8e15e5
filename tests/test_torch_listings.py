"""The paper's Listings 2–5 written against the port's DSL, on the CPU.

Listings 2 and 3 run the ants model as a ``TorchTask`` and must give, bit
for bit, what direct ``simulate`` calls with the same seeds give, under both
schedulers and from the task cache. Listing 4's ``run_generational`` is held
against the JAX package's with the reference's own offspring draws replayed
into the port (the test swaps ``nsga2.draw_offspring`` for the replay) and a
deterministic fitness, so the reference's evaluation keys do not matter.
Listing 3 also runs with its model on a pool whose members fail every first
attempt. Listing 5 runs the island model in a capsule placed on an
environment, its population saved by a hook.

The world is REDUCED's with the horizon cut to 60 ticks; at that horizon no
source of REDUCED empties, so the sources shrink to a radius of 1 and the
colony grows to 256 ants, and the first source's emptying tick then depends
on the seed.
"""
import csv
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.evolution import ga as jga  # noqa: E402
from repro.evolution import nsga2 as jnsga2  # noqa: E402
from repro_torch.ants import simulate, simulate_batch  # noqa: E402
from repro_torch.configs.ants_netlogo import BOUNDS, REDUCED  # noqa: E402
from repro_torch.core import (Capsule, EnvironmentPool,  # noqa: E402
                              FaultSpec, LocalEnvironment, PyTask,
                              SavePopulationHook, TaskCache, ToStringHook,
                              TorchTask, Val, aggregate, explore, puzzle)
from repro_torch.evolution import ga, island, nsga2  # noqa: E402
from repro_torch.evolution import run_generational  # noqa: E402
from repro_torch.explore import (SeedSampling, StatisticTask,  # noqa: E402
                                 median, replicated, replicated_batch)
from repro_torch.runtime.device import make_generator  # noqa: E402
from test_torch_selection import _jax_offspring_draws  # noqa: E402

CFG = dataclasses.replace(REDUCED, max_ticks=60, food_radius=1.0,
                          population=256)
SEED, FOODS = Val("seed", int), [Val(f"food{i}", float) for i in (1, 2, 3)]
MEDS = [Val(f"medNumberFood{i}", float) for i in (1, 2, 3)]


def ants_fn(gDiffusionRate, gEvaporationRate, seed):
    # the generator is built here, from the seed, on every call: what makes
    # serial == async and a cache hit == a miss
    obj = simulate(CFG, gDiffusionRate, gEvaporationRate,
                   generator=make_generator(int(seed), "cpu"), device="cpu")
    return {"food1": obj[0], "food2": obj[1], "food3": obj[2]}


def ants_task():
    return TorchTask(
        "ants", ants_fn,
        inputs=(Val("gDiffusionRate", float), Val("gEvaporationRate", float),
                SEED),
        outputs=tuple(FOODS),
        defaults={"seed": 42, "gDiffusionRate": 50.0,
                  "gEvaporationRate": 10.0}, device="cpu")


def direct(seed, diffusion=50.0, evaporation=10.0):
    return simulate(CFG, diffusion, evaporation,
                    generator=make_generator(seed, "cpu"), device="cpu")


def test_listing2_equals_a_direct_simulate():
    hook = ToStringHook(*FOODS, printer=lambda s: None)
    res = puzzle(Capsule(ants_task()).hook(hook)).run()
    (ctx,) = list(res.values())[0]
    expect = direct(42)
    got = torch.stack([ctx[f.name] for f in FOODS])
    assert torch.equal(got, expect)
    assert hook.seen == ["food1={}, food2={}, food3={}".format(
        *(np.float32(v) for v in expect.tolist()))]


def _listing3(environment=None):
    model = Capsule(ants_task())
    if environment is not None:
        model.on(environment)
    stat = Capsule(StatisticTask("statistic", list(zip(FOODS, MEDS,
                                                       [median] * 3))))
    head = Capsule(PyTask("head", lambda ctx: {}))
    p = (puzzle(head) >> explore(SeedSampling(SEED, 5, seed=7)) >> model
         >> aggregate() >> stat)
    return p, model, stat


def _failing_pool():
    # every member fails each lane's first attempt and never its second
    return EnvironmentPool(
        [LocalEnvironment(name=f"worker{i}", capacity=2,
                          faults=FaultSpec(fail_rate=1.0, fail_limit=1,
                                           seed=i)) for i in range(3)],
        retries=2, backoff_s=0.0)


@pytest.mark.parametrize("kind", ["serial", "async", "cache", "pool"])
def test_listing3_equals_direct_runs(kind):
    # "cache" runs twice on one TaskCache (a miss, then every firing a hit);
    # "pool" places the model on a pool that requeues each of the 5
    # one-context lanes once
    seeds = [int(c["seed"]) for c in SeedSampling(SEED, 5, seed=7)
             .contexts({})]
    expect = torch.stack([direct(s) for s in seeds])          # (5, 3)
    assert len(set(expect[:, 0].tolist())) > 1, "the seeds must matter"
    cache, pool = TaskCache(), _failing_pool() if kind == "pool" else None
    runs = {"serial": [("lanes", dict(scheduler="serial"))],
            "async": [("lanes", dict(scheduler="async"))],
            "cache": [("lanes", dict(cache=cache)),
                      ("cache", dict(cache=cache))],
            "pool": [("lanes", dict(scheduler="async"))]}[kind]
    try:
        for mode, kw in runs:
            p, model, stat = _listing3(environment=pool)
            res = p.run(**kw)
            assert [r.mode for r in p.workflow.last_record.tasks
                    if r.task == "ants"] == [mode] * 5
            assert [int(c["seed"]) for c in res[model]] == seeds
            got = torch.stack([torch.stack([c[f.name] for f in FOODS])
                               for c in res[model]])
            assert torch.equal(got, expect), mode
            (out,) = res[stat]
            assert isinstance(out["food1"], torch.Tensor)  # stacked, not a list
            assert torch.equal(torch.stack([out[m.name] for m in MEDS]),
                               median(expect, axis=0))
    finally:
        if pool is not None:
            pool.shutdown()
    if pool is not None:
        assert pool.stats.resubmissions == pool.stats.failed_attempts == 5
        assert pool.stats.completed == 5 and pool.stats.in_flight == 0


def _fitness(d, e, absolute):
    # three conflicting objectives of the genome alone
    return [d, e, absolute(d - 50.0) + absolute(e - 50.0)]


def test_run_generational_matches_reference_with_its_draws(monkeypatch):
    mu, lam, gens = 10, 10, 3
    kw = dict(mu=mu, genome_dim=2, bounds=BOUNDS, n_objectives=3,
              reevaluate=0.2)
    jcfg, tcfg = jnsga2.NSGA2Config(**kw), nsga2.NSGA2Config(**kw)
    key = jax.random.key(3)

    def jeval(keys, g):
        return jnp.stack(_fitness(g[:, 0], g[:, 1], jnp.abs), axis=1)

    def teval(generator, g):
        return torch.stack(_fitness(g[:, 0], g[:, 1], torch.abs), dim=1)

    seen = []
    jga.run_generational(jcfg, jeval, key, lam=lam, generations=gens,
                         hooks=[seen.append])
    start = jga.run_generational(jcfg, jeval, key, lam=lam, generations=0)
    # the reference's key schedule: init splits (pop, rng), the initial
    # evaluation splits rng once, each generation splits it in three
    rng = jax.random.split(jax.random.split(key)[1])[0]
    draws = []
    for _ in range(gens):
        rng, k_off, _ = jax.random.split(rng, 3)
        d = _jax_offspring_draws(k_off, mu, lam, 2, jcfg)
        t = {k: torch.from_numpy(np.array(v))[None] for k, v in d.items()}
        for k in ("cand1", "cand2", "src"):
            t[k] = t[k].to(torch.int64)
        draws.append(nsga2.OffspringDraws(**t))
    assert any(bool(d.reeval.any()) for d in draws)

    init_state = ga.init_state

    def replayed_init(cfg, generator, *, n_islands=1, device="cuda"):
        state = init_state(cfg, generator, n_islands=n_islands, device=device)
        return state._replace(genomes=torch.from_numpy(
            np.array(start.genomes))[None])

    def replayed_draws(cfg, generator, n, lam_, batch=(), device=None):
        assert (n, lam_, batch) == (mu, lam, (1,))
        return draws.pop(0)

    monkeypatch.setattr(ga, "init_state", replayed_init)
    monkeypatch.setattr(nsga2, "draw_offspring", replayed_draws)
    got = []
    final = run_generational(tcfg, teval, torch.Generator(), lam=lam,
                             generations=gens, hooks=[got.append],
                             device="cpu")
    assert not draws and len(got) == len(seen) == gens
    assert final.genomes.shape == (mu, 2) and final.objectives.shape == (mu, 3)
    for t, j in zip(got, seen):
        np.testing.assert_allclose(t.genomes.numpy(), np.asarray(j.genomes),
                                   rtol=1e-6)
        np.testing.assert_allclose(t.objectives.numpy(),
                                   np.asarray(j.objectives), rtol=1e-6,
                                   atol=1e-5)
        np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid))
        assert int(t.generation) == int(j.generation)
        assert int(t.evaluations) == int(j.evaluations)
        np.testing.assert_array_equal(
            nsga2.nondominated_ranks(t.objectives, t.valid).numpy(),
            np.asarray(jnsga2.nondominated_ranks(j.objectives, j.valid)))
    assert int(final.evaluations) == mu + lam * gens


def test_replicated_reduces_each_genomes_runs():
    calls = []

    def one(gen, genome):
        calls.append(genome.clone())
        return genome * torch.rand((), generator=gen)

    g = torch.tensor([[1.0, 2.0], [3.0, 4.0]])
    got = replicated(one, 3, device="cpu")(make_generator(0, "cpu"), g)
    gen = make_generator(0, "cpu")
    u = torch.rand((6,), generator=gen).reshape(2, 3)
    expect = median(g[:, None, :] * u[..., None], axis=1)
    assert torch.equal(got, expect) and got.shape == (2, 2)
    assert [c.tolist() for c in calls] == [[1.0, 2.0]] * 3 + [[3.0, 4.0]] * 3


def test_listing5_island_capsule_saves_its_archive(tmp_path):
    cfg = nsga2.NSGA2Config(mu=4, genome_dim=2, bounds=BOUNDS,
                            n_objectives=3)
    eval_fn = replicated_batch(
        lambda gen, g: simulate_batch(CFG, g[:, 0], g[:, 1], generator=gen),
        2)
    kept = {}

    def island_fn(seed):
        state = island.run_islands(
            cfg, eval_fn, make_generator(seed, "cpu"), n_islands=2, lam=4,
            steps_per_epoch=1, epochs=2, archive_size=16, device="cpu")
        kept["state"] = state
        a = state.archive
        return {"generation": state.epoch, "genomes": a.genomes[a.valid],
                "objectives": a.objectives[a.valid]}

    task = TorchTask("island", island_fn, inputs=(SEED,),
                     outputs=(Val("generation"), Val("genomes"),
                              Val("objectives")),
                     defaults={"seed": 5}, device="cpu")
    out = tmp_path / "evolution"
    puzzle(Capsule(task).on(LocalEnvironment())
           .hook(SavePopulationHook(str(out)))).run()
    a = kept["state"].archive
    latest = json.loads((out / "latest.json").read_text())
    assert latest["generation"] == 2 == kept["state"].epoch
    with open(latest["path"], newline="") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["g0", "g1", "o0", "o1", "o2"]
    saved = np.array(rows[1:], dtype=np.float32)
    expect = torch.cat([a.genomes, a.objectives], 1)[a.valid].numpy()
    np.testing.assert_array_equal(saved, expect)
    assert len(saved) == int(a.valid.sum()) > 0


def test_entry_points_default_to_the_card(monkeypatch):
    # run_generational, a TorchTask and replicated resolve device="cuda"
    # unless told otherwise, so a caller that names no device never runs on
    # the CPU unawares
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = nsga2.NSGA2Config(mu=4, genome_dim=2, bounds=BOUNDS)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_generational(cfg, None, torch.Generator(), lam=2, generations=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchTask("t", lambda x: x, inputs=(Val("x"),), outputs=(Val("y"),))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        replicated(lambda gen, g: g, 2)
