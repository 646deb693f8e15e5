"""The streaming init (chunk layout, chunk evaluation, hierarchical top-k,
the pool and checkpoint paths) and the superstep and pipelined island
schedules of the port, against the JAX package on the CPU where the two can
be compared (layouts, a replayed REDUCED chunk, the rows picked, evaluation
counts, the calibrate outputs), and bit for bit within the port where only
the port's own generators decide (chaos pools, kill and resume, grains,
resumes of either schedule)."""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.ants import model as jmodel  # noqa: E402
from repro.configs.ants_netlogo import REDUCED as J_REDUCED  # noqa: E402
from repro.evolution import ga as jga  # noqa: E402
from repro.evolution import island as jisland  # noqa: E402
from repro.evolution import nsga2 as jnsga2  # noqa: E402
from repro.explore.replication import replicated_batch as j_replicated  # noqa: E402
from repro.launch import explore as jexplore  # noqa: E402
from repro_torch.ants import model  # noqa: E402
from repro_torch.configs.ants_netlogo import REDUCED  # noqa: E402
from repro_torch.core import (EnvironmentPool, FaultSpec,  # noqa: E402
                              LocalEnvironment)
from repro_torch.core.scheduler import RunRecord, _utcnow  # noqa: E402
from repro_torch.evolution import ga, island, nsga2  # noqa: E402
from repro_torch.explore.replication import replicated_batch  # noqa: E402
from repro_torch.launch import explore  # noqa: E402

BOUNDS = ((0.0, 99.0), (0.0, 99.0))


def _quiet(*_):
    pass


def _replayed_gumbel(keys, ticks, population):
    """(ticks, N, P, 8): the Gumbel draws the reference simulator makes from
    lane keys ``keys`` (per tick each key splits into (next, move) and the
    move key draws a (P, 8) Gumbel tensor)."""
    def body(rng, _):
        k = jax.vmap(jax.random.split)(rng)
        g = jax.vmap(lambda kk: jax.random.gumbel(kk, (population, 8)))(
            k[:, 1])
        return k[:, 0], g

    return jax.lax.scan(body, keys, None, length=ticks)[1]


# ---------------------------------------------------------------------------
# chunk layout and one chunk against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_total,chunk", [
    (600, 100), (640, 64), (100, 128), (2048, 2048), (14336, 4096),
    (200000, 4096), (256, 64), (1, 7)])
def test_chunk_sizes_match_reference(n_total, chunk):
    sizes = ga.chunk_sizes(n_total, chunk)
    assert sizes == jga.chunk_sizes(n_total, chunk)
    assert sum(sizes) == n_total


def test_chunk_seeds_differ_for_every_chunk_and_stream():
    for seed in (0, 1, 2 ** 40 + 3):
        seeds = {ga.chunk_seed(seed, i, s) for i in range(4096)
                 for s in (ga.GENOMES, ga.GUMBEL)}
        low = {x & 0xFFFFFFFF for x in seeds}
        assert len(seeds) == len(low) == 8192
        assert all(0 <= x < 2 ** 64 for x in seeds)
    assert ga.chunk_seed(0, 3, 0) != ga.chunk_seed(1, 3, 0)


def test_population_chunk_is_pure_and_within_bounds():
    cfg = nsga2.NSGA2Config(mu=8, genome_dim=2, bounds=BOUNDS)
    a = ga.population_chunk(cfg, 5, 2, 300, device="cpu")
    b = ga.population_chunk(cfg, 5, 2, 300, device="cpu")
    assert torch.equal(a, b) and a.shape == (300, 2)
    assert bool(((a >= 0) & (a < 99)).all())
    assert not torch.equal(a, ga.population_chunk(cfg, 5, 3, 300, "cpu"))
    # a shorter chunk (the remainder) is a prefix of the same draw
    assert torch.equal(ga.population_chunk(cfg, 5, 2, 40, "cpu"), a[:40])


def test_replayed_reduced_chunk_matches_reference():
    """The reference's chunk 3 (its genomes and lane keys) through its
    replicated evaluation; the same genomes with the reference's Gumbel
    stream replayed through the port's: equal objectives (integer ticks)."""
    seed, i, size, reps = 0, 3, 4, 2
    jcfg = jnsga2.NSGA2Config(mu=8, genome_dim=2, bounds=BOUNDS)
    tcfg = nsga2.NSGA2Config(mu=8, genome_dim=2, bounds=BOUNDS)
    keys, genomes = jga.population_chunk(jcfg, seed, i, size)

    def jax_lanes(k, g):
        return jmodel.simulate_batch(J_REDUCED, k, g[:, 0], g[:, 1])

    expect = np.asarray(jax.jit(j_replicated(jax_lanes, reps))(keys,
                                                               genomes))
    flat_keys = jax.vmap(lambda k: jax.random.split(k, reps))(keys).reshape(
        size * reps)
    noise = torch.from_numpy(np.array(jax.jit(
        _replayed_gumbel, static_argnums=(1, 2))(
            flat_keys, J_REDUCED.max_ticks, J_REDUCED.population)))
    got = replicated_batch(
        lambda gen, g: model.simulate_batch(REDUCED, g[:, 0], g[:, 1],
                                            noise=noise),
        reps)(None, torch.from_numpy(np.array(genomes)))
    np.testing.assert_array_equal(got.numpy(), expect)
    # the apply half of the port's chunk on the reference's own uniforms
    kg, _ = jax.random.split(jax.random.fold_in(jax.random.key(seed), i))
    u = np.array(jax.random.uniform(kg, (size, 2), jnp.float32))
    np.testing.assert_array_equal(
        ga.population_chunk_apply(tcfg, torch.from_numpy(u)).numpy(),
        np.asarray(genomes))


# ---------------------------------------------------------------------------
# hierarchical top-k against the reference
# ---------------------------------------------------------------------------
def _tied_population(n, seed=0):
    """Integer objectives in a narrow range (many duplicate rows and equal
    truncation keys); genome 0 carries the row number, so the rows picked
    can be compared exactly."""
    rng = np.random.default_rng(seed)
    obj = rng.integers(0, 12, (n, 3)).astype(np.float32)
    genomes = np.stack([np.arange(n, dtype=np.float32),
                        rng.random(n, dtype=np.float32)], 1)
    return genomes, obj


@pytest.mark.parametrize("n,k,block", [(5000, 64, 2048), (5000, 64, 512),
                                        (1500, 128, 512), (300, 16, 2048)])
def test_select_top_streaming_picks_the_reference_rows(n, k, block):
    genomes, obj = _tied_population(n)
    jcfg = jnsga2.NSGA2Config(mu=16, genome_dim=2, bounds=BOUNDS)
    tcfg = nsga2.NSGA2Config(mu=16, genome_dim=2, bounds=BOUNDS)
    jg, jo = jga.select_top_streaming(jcfg, genomes, obj, k, block=block)
    tg, to = ga.select_top_streaming(tcfg, genomes, obj, k, block=block,
                                     device="cpu")
    assert tg.device.type == "cpu" and tg.shape == (k, 2)
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))


def test_init_state_from_population_counts_every_evaluation():
    genomes, obj = _tied_population(700, seed=3)
    cfg = nsga2.NSGA2Config(mu=16, genome_dim=2, bounds=BOUNDS)
    state = ga.init_state_from_population(cfg, genomes, obj, device="cpu")
    assert state.genomes.shape == (1, 16, 2)
    assert bool(state.valid.all()) and state.evaluations.tolist() == [700]
    rows = state.genomes[0, :, 0].numpy().astype(int)
    np.testing.assert_array_equal(state.objectives[0].numpy(), obj[rows])
    np.testing.assert_array_equal(state.genomes[0].numpy(), genomes[rows])


# ---------------------------------------------------------------------------
# the pool and checkpoint paths, within the port
# ---------------------------------------------------------------------------
def _stream_setup():
    cfg = nsga2.NSGA2Config(mu=8, genome_dim=2, bounds=((0., 100.),
                                                         (0., 100.)))

    def eval_fn(gen, genomes):
        noise = torch.randn((len(genomes), 3), generator=gen,
                            device=genomes.device)
        d, e = genomes[:, 0], genomes[:, 1]
        return torch.stack([(d - 30.) ** 2, (d - e).abs(), d + e], 1) + noise

    return cfg, eval_fn


def _chaos_pool():
    return EnvironmentPool([
        LocalEnvironment(name="fails", capacity=2,
                         faults=FaultSpec(fail_rate=0.4, seed=1)),
        LocalEnvironment(name="corrupts", capacity=2,
                         faults=FaultSpec(corrupt_rate=0.4,
                                          corrupt_limit=None, seed=2)),
        LocalEnvironment(name="stable", capacity=2)], retries=8,
        backoff_s=0.001)


def _stream(cfg, eval_fn, **kw):
    return ga.evaluate_population_streaming(cfg, eval_fn, 0, device="cpu",
                                            **kw)


def test_streaming_bitwise_under_failures_and_corruption():
    cfg, eval_fn = _stream_setup()
    clean = _stream(cfg, eval_fn, n_total=600, chunk=100)
    pool = _chaos_pool()
    try:
        chaos = _stream(cfg, eval_fn, n_total=600, chunk=100,
                        environment=pool)
    finally:
        pool.shutdown()
    assert np.array_equal(clean.objectives, chaos.objectives)
    assert np.array_equal(clean.genomes, chaos.genomes)
    assert clean.objectives.shape == (600, 3) and clean.attempts == 6
    assert chaos.attempts >= chaos.chunks_total == 6
    stats = pool.stats.snapshot()
    assert stats["completed"] == 6 and stats["failed"] == 0
    assert chaos.attempts == 6 + stats["resubmissions"]
    # the genomes are the chunks' own draws
    np.testing.assert_array_equal(
        clean.genomes[200:300],
        ga.population_chunk(cfg, 0, 2, 100, "cpu").numpy())


@pytest.mark.parametrize("through", ["inline", "chaos_pool"])
def test_streaming_resumes_mid_population(tmp_path, through):
    cfg, eval_fn = _stream_setup()
    ckpt = str(tmp_path / "init")
    clean = _stream(cfg, eval_fn, n_total=640, chunk=64)
    pool = _chaos_pool() if through == "chaos_pool" else None
    try:
        part = _stream(cfg, eval_fn, n_total=640, chunk=64,
                       checkpoint_dir=ckpt, stop_after_chunks=5,
                       environment=pool)
        assert part.interrupted and part.objectives is None
        assert part.chunks_done == 5 and part.chunks_total == 10
        rec = RunRecord(workflow="resume", scheduler="stream",
                        environment="inline", started_at=_utcnow())
        seen = []
        full = _stream(cfg, eval_fn, n_total=640, chunk=64,
                       checkpoint_dir=ckpt, record=rec, environment=pool,
                       progress=lambda k, n: seen.append((k, n)))
    finally:
        if pool is not None:
            pool.shutdown()
    assert not full.interrupted and full.resumed_chunks == 5
    assert np.array_equal(clean.objectives, full.objectives)
    assert np.array_equal(clean.genomes, full.genomes)
    modes = [t.mode for t in rec.tasks]
    assert modes.count("cache") == 5 and modes.count("stream") == 5
    assert sorted(t.capsule for t in rec.tasks) == list(range(10))
    assert seen[-1] == (10, 10) and len(seen) == 5
    # the two newest commits stay on disk
    assert sorted(os.listdir(ckpt)) == ["step_00000005", "step_00000010"]


def test_streaming_resume_refuses_other_settings(tmp_path):
    cfg, eval_fn = _stream_setup()
    ckpt = str(tmp_path / "init")
    _stream(cfg, eval_fn, n_total=256, chunk=64, checkpoint_dir=ckpt,
            stop_after_chunks=2, settings=json.dumps({"chunk": 64}))
    with pytest.raises(ValueError, match="other settings"):
        _stream(cfg, eval_fn, n_total=256, chunk=32, checkpoint_dir=ckpt,
                settings=json.dumps({"chunk": 32}))
    # without settings a prefix that does not fit the layout is refused too
    with pytest.raises(ValueError, match="do not fit"):
        _stream(cfg, eval_fn, n_total=256, chunk=32,
                checkpoint_dir=str(tmp_path / "bare"), stop_after_chunks=2)
        _stream(cfg, eval_fn, n_total=256, chunk=64,
                checkpoint_dir=str(tmp_path / "bare"))


def test_streaming_service_is_not_ported():
    """The service tenant is ported now (tests/test_torch_service.py);
    given both an environment and a service, the streaming init raises, as
    the reference's does."""
    cfg, eval_fn = _stream_setup()
    with pytest.raises(ValueError, match="either environment= or service="):
        _stream(cfg, eval_fn, n_total=64, chunk=32, service=object(),
                environment=object())


def test_streaming_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, eval_fn = _stream_setup()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ga.evaluate_population_streaming(cfg, eval_fn, 0, n_total=64,
                                         chunk=32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ga.select_top_streaming(cfg, np.zeros((4, 2)), np.zeros((4, 3)), 2)


# ---------------------------------------------------------------------------
# supersteps and the pipelined schedule
# ---------------------------------------------------------------------------
D = 4
CFG = nsga2.NSGA2Config(mu=8, genome_dim=D, bounds=((0., 1.),) * D,
                        n_objectives=2)
ISLANDS = dict(n_islands=3, lam=8, steps_per_epoch=2, archive_size=32,
               device="cpu")


def _zdt1(gen, genomes):
    """ZDT1 with a little noise from the generator, so that every draw's
    place in the stream shows in the result."""
    x0 = genomes[:, 0]
    g = 1 + 9 * genomes[:, 1:].mean(dim=1)
    f2 = g * (1 - torch.sqrt(torch.clamp(x0 / g, 0, 1)))
    noise = 1e-3 * torch.rand((len(genomes), 2), generator=gen)
    return torch.stack([x0, f2], 1) + noise


def _j_zdt1(keys, genomes):
    x0 = genomes[:, 0]
    g = 1 + 9 * genomes[:, 1:].mean(axis=1)
    f2 = g * (1 - jnp.sqrt(jnp.clip(x0 / g, 0, 1)))
    return jnp.stack([x0, f2], axis=1)


def _gen(seed=2):
    return torch.Generator().manual_seed(seed)


def _assert_states_equal(a, b):
    for x, y in zip(a.islands + a.archive, b.islands + b.archive):
        assert torch.equal(x.cpu(), y.cpu())
    assert (a.epoch, a.total_evaluations) == (b.epoch, b.total_evaluations)


def _run(epochs, snaps=None, gen=None, **kw):
    return island.run_islands(
        CFG, _zdt1, gen or _gen(), epochs=epochs,
        checkpoint_fn=None if snaps is None
        else (lambda s, rng: snaps.append((s, rng))), **ISLANDS, **kw)


def test_superstep_grains_agree_bitwise():
    whole = _run(5)                                  # grain 0: one superstep
    by = {}
    for grain in (1, 2, 0):                          # 0 + checkpoints: 1
        snaps = []
        state = _run(5, snaps, epochs_per_superstep=grain)
        _assert_states_equal(state, whole)
        by[grain] = {s.epoch: (s, rng) for s, rng in snaps}
    assert sorted(by[1]) == sorted(by[0]) == [1, 2, 3, 4, 5]
    assert sorted(by[2]) == [2, 4, 5]
    for e in (2, 4, 5):
        for grain in (1, 0):
            _assert_states_equal(by[2][e][0], by[grain][e][0])
            assert torch.equal(by[2][e][1], by[grain][e][1])
    snap = by[2][5][0]
    assert snap.islands.genomes.device.type == "cpu"
    assert snap.islands.genomes.data_ptr() != whole.islands.genomes.data_ptr()


def test_superstep_resume_from_a_grain_2_checkpoint_is_bitwise():
    snaps = []
    full = _run(6, snaps, epochs_per_superstep=2)
    state, rng = snaps[0]
    assert state.epoch == 2
    gen = torch.Generator().set_state(rng)
    resumed = _run(6, gen=gen, start_state=state, epochs_per_superstep=2)
    _assert_states_equal(resumed, full)


def test_host_snapshot_is_an_independent_copy():
    state = island.init_island_state(CFG, _gen(), n_islands=2,
                                     archive_size=8, device="cpu")
    snap = island.host_snapshot(state)
    state.islands.genomes.add_(1.0)
    state.archive.valid.fill_(True)
    assert not torch.equal(snap.islands.genomes, state.islands.genomes)
    assert not bool(snap.archive.valid.any())


def test_pipelined_resume_is_bitwise():
    """Resuming a pipelined run from its second checkpoint continues the
    schedule bit for bit (the checkpoints hold the reseeded islands and the
    generator's state of the boundary)."""
    snaps = []
    full = _run(4, snaps, pipeline=True)
    assert [s.epoch for s, _ in snaps] == [1, 2, 3, 4]
    state, rng = snaps[1]
    resumed = _run(4, gen=torch.Generator().set_state(rng),
                   start_state=state, pipeline=True)
    _assert_states_equal(resumed, full)
    _assert_states_equal(snaps[-1][0], full)


def test_pipeline_reseeds_from_the_stale_archive():
    """Epoch e's islands are reseeded from the archive of epoch e-1: with a
    stale archive of no valid members, the first reseed changes nothing."""
    snaps = []
    _run(2, snaps, pipeline=True)
    first = snaps[0][0]
    evolve = island.make_evolve(CFG, _zdt1, lam=8, steps_per_epoch=2)
    merge = island.make_merge(CFG)
    reseed = island.make_reseed(CFG)
    gen = _gen()
    start = island.init_island_state(CFG, gen, n_islands=3, archive_size=32,
                                     device="cpu")
    evolved = evolve(start.islands, gen)
    seeded = reseed(evolved, start.archive, gen)
    for a, b in zip(seeded, evolved):
        assert torch.equal(a, b)
    for a, b in zip(first.islands, seeded):
        assert torch.equal(a, b)
    for a, b in zip(first.archive, merge(start.archive, evolved)):
        assert torch.equal(a, b)


def test_stages_compose_to_the_synchronous_epoch():
    state = island.init_island_state(CFG, _gen(7), n_islands=3,
                                     archive_size=32, device="cpu")
    gen = _gen(8)
    fused = island.make_epoch(CFG, _zdt1, lam=8, steps_per_epoch=2)(
        state, gen)
    gen = _gen(8)
    evolved = island.make_evolve(CFG, _zdt1, lam=8, steps_per_epoch=2)(
        state.islands, gen)
    archive = island.make_merge(CFG)(state.archive, evolved)
    islands = island.make_reseed(CFG)(evolved, archive, gen)
    for a, b in zip(fused.islands + fused.archive, islands + archive):
        assert torch.equal(a, b)


@pytest.mark.parametrize("pipeline", [True, False])
def test_evaluation_count_matches_reference(pipeline):
    jcfg = jnsga2.NSGA2Config(mu=8, genome_dim=D, bounds=((0., 1.),) * D,
                              n_objectives=2)
    kw = dict(n_islands=3, lam=8, steps_per_epoch=2, archive_size=32,
              pipeline=pipeline)
    expect = jisland.run_islands(jcfg, _j_zdt1, jax.random.key(2), epochs=3,
                                 **kw)
    got = _run(3, pipeline=pipeline)
    assert got.total_evaluations == int(expect.total_evaluations) \
        == 3 * (8 + 3 * 2 * 8)
    assert got.epoch == int(expect.epoch) == 3


# ---------------------------------------------------------------------------
# calibrate with the streaming init, against the reference's
# ---------------------------------------------------------------------------
FLAGS = dict(reduced=True, n_islands=2, mu=8, lam=8, steps_per_epoch=1,
             epochs=2, replicates=2, init_population=32, init_chunk=16,
             fault_rate=0.3, pipeline=True)


@pytest.fixture(scope="module")
def init_runs(tmp_path_factory):
    jout = tmp_path_factory.mktemp("jax_init")
    _, jfront = jexplore.calibrate(out_dir=str(jout), printer=_quiet, **FLAGS)
    out = tmp_path_factory.mktemp("torch_init")
    lines = []
    state, front = explore.calibrate(out_dir=str(out), device="cpu",
                                     printer=lines.append, **FLAGS)
    return jfront, jout, state, front, out, lines


def test_calibrate_init_matches_reference_accounting(init_runs):
    jfront, jout, state, front, out, lines = init_runs
    assert front["evaluations"] == jfront["evaluations"] \
        == state.total_evaluations == 32 + 2 * 2 * 8
    assert set(front) == set(jfront) and "init" in front
    assert set(front["init"]) == set(jfront["init"])
    assert front["init"]["n_individuals"] == 32
    assert front["init"]["fault_rate"] == 0.3
    assert front["init"]["attempts"] >= 2
    with open(jout / "provenance.json") as f:
        jrec = json.load(f)
    with open(out / "provenance.json") as f:
        rec = json.load(f)
    assert set(rec) == set(jrec) and rec["scheduler"] == jrec["scheduler"]
    assert [(t["task"], t["mode"]) for t in rec["tasks"]] == \
        [(t["task"], t["mode"]) for t in jrec["tasks"]]
    assert sorted(os.listdir(out / "init_checkpoints")) == ["step_00000002"]
    assert any(s.startswith("[explore] init: 32 individuals") for s in lines)


def test_calibrate_init_seeds_the_islands_from_its_best(init_runs):
    *_, out, _ = init_runs
    cfg = nsga2.NSGA2Config(mu=8, genome_dim=2, bounds=BOUNDS)
    res = _stream(cfg, explore.ants_eval_fn(REDUCED, 2), n_total=32,
                  chunk=16)
    top_g, _ = ga.select_top_streaming(cfg, res.genomes, res.objectives, 16,
                                       device="cpu")
    from repro_torch import checkpoint
    saved = checkpoint.restore(str(out / "init_checkpoints"), 2,
                               {"objectives": None, "settings": None})
    np.testing.assert_array_equal(saved["objectives"], res.objectives)
    assert bool(((top_g >= 0) & (top_g < 99)).all())


def test_calibrate_init_rerun_resumes(init_runs):
    *_, state, front, out, _ = init_runs
    lines = []
    again, front2 = explore.calibrate(out_dir=str(out), device="cpu",
                                      printer=lines.append, **FLAGS)
    assert lines[0] == "[explore] resumed at epoch 2"
    assert not any("init:" in s for s in lines)
    _assert_states_equal(again, state)
    assert front2["objectives"] == front["objectives"]
    assert front2["evaluations"] == front["evaluations"]


@pytest.mark.parametrize("change", [{"init_chunk": 32},
                                   {"init_population": 48},
                                   {"pipeline": False}])
def test_calibrate_init_refuses_other_settings(init_runs, change):
    *_, out, _ = init_runs
    with pytest.raises(ValueError, match="other settings"):
        explore.calibrate(out_dir=str(out), device="cpu", printer=_quiet,
                          **dict(FLAGS, **change))


def test_calibrate_init_resumes_its_own_checkpoint(tmp_path):
    """An init interrupted before the islands started: the rerun resumes
    the init's prefix, and refuses one of another chunk."""
    cfg = nsga2.NSGA2Config(mu=8, genome_dim=2, bounds=BOUNDS)
    settings = {"ants": dataclasses.asdict(REDUCED), "device": "cpu",
                "init_chunk": 16, "init_population": 32, "replicates": 2,
                "seed": 0}
    _stream(cfg, explore.ants_eval_fn(REDUCED, 2), n_total=32, chunk=16,
            checkpoint_dir=str(tmp_path / "init_checkpoints"),
            stop_after_chunks=1,
            settings=json.dumps(settings, sort_keys=True))
    with pytest.raises(ValueError, match="other settings"):
        explore.calibrate(out_dir=str(tmp_path), device="cpu",
                          printer=_quiet, **dict(FLAGS, init_chunk=8))
    lines = []
    _, front = explore.calibrate(out_dir=str(tmp_path), device="cpu",
                                 printer=lines.append, **FLAGS)
    assert front["init"]["resumed_chunks"] == 1


def test_calibrate_init_must_cover_the_islands(tmp_path):
    with pytest.raises(ValueError, match="n_islands\\*mu = 16"):
        explore.calibrate(out_dir=str(tmp_path), device="cpu",
                          printer=_quiet, **dict(FLAGS, init_population=15))
