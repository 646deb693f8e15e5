"""The port's workflow engine and DSL on the CPU against the JAX package's:
the same DAGs of host-side float tasks, built in both packages and run under
both schedulers, give equal outputs per capsule role; wiring checks, cycle
detection, samplings, statistics, aggregation, hooks, the task cache, the
provenance record and the pool's lane-based ``map_explore``. Capsule ids are
a process-global counter in both packages, so results are compared by the
role a capsule plays in its DAG, never by id."""
import json
import threading
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
import repro.explore.sampling as jsampling  # noqa: E402
import repro.explore.statistics as jstatistics  # noqa: E402
from repro.core import workflow as jworkflow  # noqa: E402
from repro.explore import replication as jreplication  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.explore as texplore  # noqa: E402
from repro_torch.core import workflow as tworkflow  # noqa: E402
from repro_torch.core.cache import inputs_digest, fingerprint_task  # noqa: E402


def _torch_task(name, fn, inputs=(), outputs=(), defaults=None):
    return tcore.TorchTask(name, fn, inputs, outputs, defaults, device="cpu")


PKGS = {
    "reference": types.SimpleNamespace(
        core=jcore, sampling=jsampling, stats=jstatistics,
        Replicate=jreplication.Replicate, DevTask=jcore.JaxTask),
    "port": types.SimpleNamespace(
        core=tcore, sampling=texplore, stats=texplore,
        Replicate=texplore.Replicate, DevTask=_torch_task),
}


# ---------------------------------------------------------------------------
# DAGs, each built by one function from either package: (runnable, roles)
# where ``runnable.run(initial, environment, **kw)`` runs it and roles maps
# a role name to its capsule
# ---------------------------------------------------------------------------
def _chain(p):
    c, x, y, z = p.core, *_vals(p)
    a = c.Capsule(c.PyTask("a", lambda ctx: {"y": ctx["x"] + 1},
                           inputs=(x,), outputs=(y,)))
    b = c.Capsule(c.PyTask("b", lambda ctx: {"z": ctx["y"] * 10},
                           inputs=(y,), outputs=(z,)))
    return c.puzzle(a) >> b, {"a": a, "b": b}, {"x": 4.0}


def _explore_aggregate(p):
    c, x, y, z = p.core, *_vals(p)
    head = c.Capsule(c.PyTask("head", lambda ctx: {}))
    sq = c.Capsule(c.PyTask("sq", lambda ctx: {"y": ctx["x"] ** 2},
                            inputs=(x,), outputs=(y,)))
    med = c.Capsule(p.stats.StatisticTask("med", [(y, z, p.stats.median)]))
    grid = p.sampling.GridSampling({x: [1.0, 2.0, 3.0, 4.0, 5.0]})
    return (c.puzzle(head) >> c.explore(grid) >> sq >> c.aggregate()
            >> med), {"head": head, "sq": sq, "med": med}, {}


def _condition(p):
    c, x, y, z = p.core, *_vals(p)
    wf = c.Workflow("condition")
    head = c.Capsule(c.PyTask("head", lambda ctx: {}))
    gen = c.Capsule(c.PyTask("gen", lambda ctx: {"y": ctx["x"]},
                             inputs=(x,), outputs=(y,)))
    sink = c.Capsule(c.PyTask("sink", lambda ctx: {"z": ctx["y"]},
                              inputs=(y,), outputs=(z,)))
    wf.connect(head, gen, kind="exploration",
               sampling=p.sampling.GridSampling({x: [1.0, 2.0, 3.0, 4.0]}))
    wf.connect(gen, sink, condition=lambda ctx: ctx["y"] > 2)
    return wf, {"head": head, "gen": gen, "sink": sink}, {}


def _diamond(p, barrier=None, barrier_timeout=5.0):
    c, x, y, z = p.core, *_vals(p)

    def branch(tag):
        def fn(ctx):
            if barrier is not None:
                barrier.wait(timeout=barrier_timeout)
            return {tag: ctx["x"] * (2.0 if tag == "y" else 3.0)}
        return fn

    head = c.Capsule(c.PyTask("head", lambda ctx: {}))
    left = c.Capsule(c.PyTask("left", branch("y"), inputs=(x,), outputs=(y,)))
    right = c.Capsule(c.PyTask("right", branch("z"), inputs=(x,),
                               outputs=(z,)))
    agg = c.Capsule(c.PyTask(
        "agg", lambda ctx: {"w": float(ctx.get("y", 0.0)
                                       + ctx.get("z", 0.0))},
        outputs=(c.Val("w", float),)))
    wf = c.Workflow("diamond")
    wf.connect(head, left)
    wf.connect(head, right)
    wf.connect(left, agg)
    wf.connect(right, agg)
    return wf, {"head": head, "left": left, "right": right, "agg": agg}, \
        {"x": 2.0}


def _puzzle_sum(p):
    # Listing 5's "+": two puzzles unioned into one workflow
    c, x, y, z = p.core, *_vals(p)
    a = c.Capsule(c.PyTask("a", lambda ctx: {"y": ctx["x"] - 1},
                           inputs=(x,), outputs=(y,)))
    b = c.Capsule(c.PyTask("b", lambda ctx: {"z": ctx["y"] / 4},
                           inputs=(y,), outputs=(z,)))
    d = c.Capsule(c.PyTask("d", lambda ctx: {"y": ctx["x"] * 7},
                           inputs=(x,), outputs=(y,)))
    e = c.Capsule(c.PyTask("e", lambda ctx: {"z": ctx["y"] + 0.5},
                           inputs=(y,), outputs=(z,)))
    return (c.puzzle(a) >> b) + (c.puzzle(d) >> e), \
        {"a": a, "b": b, "d": d, "e": e}, {"x": 3.0}


def _replicate(p):
    # Listing 3's Replicate over a host-side stochastic model
    c = p.core
    seed, food1 = c.Val("seed", int), c.Val("food1", float)
    med1 = c.Val("medNumberFood1", float)

    def model_fn(ctx):
        rng = np.random.RandomState(int(ctx["seed"]) % (2 ** 31))
        return {"food1": float(rng.uniform(0.0, 100.0))}

    model = c.Capsule(c.PyTask("ants", model_fn, inputs=(seed,),
                               outputs=(food1,)))
    stat = c.Capsule(p.stats.StatisticTask(
        "stat", [(food1, med1, p.stats.median)]))
    q = p.Replicate(model, p.sampling.SeedSampling(seed, 10, seed=42), stat)
    return q, {"model": model, "stat": stat}, {}


def _cross_lanes(p):
    # a device-task fan-out over a cross product, reduced four ways
    c, x, y, z = p.core, *_vals(p)
    w = c.Val("w", float)
    head = c.Capsule(c.PyTask("head", lambda ctx: {}))
    f = c.Capsule(p.DevTask("f", lambda x, w: x * 10.0 + w, inputs=(x, w),
                            outputs=(y,)))
    s = p.stats
    stat = c.Capsule(s.StatisticTask("stat", [
        (y, z, s.median), (y, c.Val("m", float), s.mean),
        (y, c.Val("s", float), s.std), (y, c.Val("q", float), s.q(0.25))]))
    grid = (p.sampling.GridSampling({x: [1.0, 2.0, 3.0]})
            * p.sampling.GridSampling({w: [0.5, 0.25]}))
    return (c.puzzle(head) >> c.explore(grid) >> f >> c.aggregate()
            >> stat), {"head": head, "f": f, "stat": stat}, {}


def _vals(p):
    v = p.core.Val
    return v("x", float), v("y", float), v("z", float)


DAGS = {"chain": _chain, "explore_aggregate": _explore_aggregate,
        "condition": _condition, "diamond": _diamond,
        "puzzle_sum": _puzzle_sum, "replicate": _replicate,
        "cross_lanes": _cross_lanes}


def _host(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _assert_roles_equal(res_a, roles_a, res_b, roles_b):
    assert sorted(roles_a) == sorted(roles_b)
    for role in roles_a:
        ctxs_a, ctxs_b = res_a[roles_a[role]], res_b[roles_b[role]]
        assert len(ctxs_a) == len(ctxs_b), role
        for ca, cb in zip(ctxs_a, ctxs_b):
            assert set(ca) == set(cb), role
            for k in ca:
                np.testing.assert_array_equal(_host(ca[k]), _host(cb[k]),
                                              err_msg=f"{role}.{k}")


def _run(dag, pkg, scheduler, **kw):
    runnable, roles, initial = dag(PKGS[pkg])
    return runnable.run(initial, scheduler=scheduler, **kw), roles, runnable


@pytest.mark.parametrize("scheduler", ["serial", "async"])
@pytest.mark.parametrize("case", sorted(DAGS))
def test_dags_match_reference_per_role(case, scheduler):
    ref, ref_roles, _ = _run(DAGS[case], "reference", "serial")
    got, roles, _ = _run(DAGS[case], "port", scheduler)
    _assert_roles_equal(ref, ref_roles, got, roles)
    if case == "replicate":
        assert len(got[roles["model"]]) == 10


def test_validate_and_cycles_match_reference():
    def unwired(c):
        wf = c.Workflow()
        a = c.Capsule(c.PyTask("a", lambda ctx: {"y": 1.0},
                               outputs=(c.Val("y", float),)))
        b = c.Capsule(c.PyTask("b", lambda ctx: {"z": ctx["q"]},
                               inputs=(c.Val("q"), c.Val("y", float)),
                               outputs=(c.Val("z", float),),
                               defaults={}))
        wf.connect(a, b)
        return wf

    def cyclic(c):
        wf = c.Workflow("loop")
        t = c.PyTask("a", lambda ctx: {})
        c1, c2 = c.Capsule(t), c.Capsule(t)
        wf.connect(c1, c2)
        wf.connect(c2, c1)
        return wf

    assert unwired(tcore).validate() == unwired(jcore).validate() \
        == ["b: input q has no producer"]
    assert _run(_explore_aggregate, "port", "serial")[2].workflow.validate() \
        == []
    for scheduler in ("serial", "async"):
        with pytest.raises(ValueError, match="cycle") as ours:
            cyclic(tcore).run(scheduler=scheduler)
        with pytest.raises(ValueError, match="cycle") as theirs:
            cyclic(jcore).run(scheduler=scheduler)
        assert str(ours.value) == str(theirs.value)


SAMPLINGS = {
    "grid": lambda s, v: s.GridSampling({v("x", float): [1.0, 2.5],
                                         v("n", int): [3, 4, 5]}),
    "uniform": lambda s, v: s.UniformSampling(
        {v("x", float): (0.0, 1.0), v("y", float): (-5.0, 99.0)}, 17,
        seed=1),
    "lhs": lambda s, v: s.LHSSampling(
        {v("x", float): (0.0, 1.0), v("y", float): (10.0, 20.0)}, 10,
        seed=3),
    "sobol": lambda s, v: s.SobolSampling(
        {v("x", float): (0.0, 1.0), v("y", float): (0.0, 99.0)}, 33,
        seed=2),
    "seed": lambda s, v: s.SeedSampling(v("seed", int), 7, seed=7),
    "cross": lambda s, v: (s.SeedSampling(v("seed", int), 3, seed=1)
                           * s.LHSSampling({v("x", float): (0.0, 1.0)}, 4,
                                           seed=0)),
}


@pytest.mark.parametrize("kind", sorted(SAMPLINGS))
def test_samplings_yield_the_reference_contexts(kind):
    ours = SAMPLINGS[kind](texplore, tcore.Val)
    theirs = SAMPLINGS[kind](jsampling, jcore.Val)
    got = [dict(c) for c in ours.contexts(tcore.Context())]
    expect = [dict(c) for c in theirs.contexts(jcore.Context())]
    assert got == expect and len(got) == len(ours) == len(theirs)
    assert [type(v) for c in got for v in c.values()] == \
        [type(v) for c in expect for v in c.values()]
    assert [v.name for v in ours.provides()] == \
        [v.name for v in theirs.provides()]


# ---------------------------------------------------------------------------
# statistics and aggregation
# ---------------------------------------------------------------------------
REDUCERS = {"median": lambda s: s.median, "mean": lambda s: s.mean,
            "std": lambda s: s.std, "q25": lambda s: s.q(0.25),
            "q90": lambda s: s.q(0.9)}


@pytest.mark.parametrize("name", sorted(REDUCERS))
def test_statistic_task_matches_numpy_on_arrays_and_tensors(name):
    # an even count of replicates (the median averages the middle pair),
    # 1-d (a float out) and 2-d (one statistic per column)
    rng = np.random.default_rng(5)
    one = rng.integers(0, 1001, 6).astype(np.float32)
    two = rng.random((6, 3)).astype(np.float32) * 100
    v = tcore.Val
    stat = texplore.StatisticTask("s", [
        (v("a"), v("ra"), REDUCERS[name](texplore)),
        (v("b"), v("rb"), REDUCERS[name](texplore))])
    jv = jcore.Val
    jstat = jstatistics.StatisticTask("s", [
        (jv("a"), jv("ra"), REDUCERS[name](jstatistics)),
        (jv("b"), jv("rb"), REDUCERS[name](jstatistics))])
    expect = jstat.run(jcore.Context(a=one, b=two))
    host = stat.run(tcore.Context(a=one, b=two))
    assert type(host["ra"]) is float and host["ra"] == expect["ra"]
    np.testing.assert_array_equal(host["rb"], expect["rb"])
    on_tensors = stat.run(tcore.Context(a=torch.from_numpy(one),
                                        b=torch.from_numpy(two)))
    for k in ("ra", "rb"):
        assert isinstance(on_tensors[k], torch.Tensor)
        assert on_tensors[k].dtype == torch.float32
        np.testing.assert_allclose(on_tensors[k].numpy(), expect[k],
                                   rtol=1e-6, atol=1e-5)
    ints = torch.tensor([3, 1, 4, 1, 5, 9])
    np.testing.assert_allclose(
        REDUCERS[name](texplore)(ints).numpy(),
        REDUCERS[name](jstatistics)(ints.numpy()), rtol=1e-12)


def test_aggregate_stacks_tensors_on_their_device_and_host_values_as_numpy():
    rng = np.random.default_rng(0)
    rows = [{"t": rng.random(3).astype(np.float32), "s": float(i),
             "n": i, "ragged": list(range(i + 1))} for i in range(4)]
    expect = jworkflow._aggregate([jcore.Context(r) for r in rows])
    host = tworkflow._aggregate([tcore.Context(r) for r in rows])
    assert set(host) == set(expect)
    for k in ("t", "s", "n"):
        assert host[k].dtype == expect[k].dtype
        np.testing.assert_array_equal(host[k], expect[k])
    assert host["ragged"] == expect["ragged"] == [r["ragged"] for r in rows]
    tens = tworkflow._aggregate([tcore.Context(
        t=torch.from_numpy(r["t"]), s=torch.tensor(r["s"]),
        i=torch.tensor(r["n"], dtype=torch.int32)) for r in rows])
    for k, dtype in (("t", torch.float32), ("s", torch.float32),
                     ("i", torch.int32)):
        assert isinstance(tens[k], torch.Tensor) and tens[k].dtype == dtype
    np.testing.assert_array_equal(tens["t"].numpy(), expect["t"])
    np.testing.assert_array_equal(tens["s"].numpy(), expect["s"])
    mixed = tworkflow._aggregate([tcore.Context(m=torch.tensor(1.0)),
                                  tcore.Context(m=2.0)])
    assert isinstance(mixed["m"], list)
    assert tworkflow._aggregate([]) == {}


# ---------------------------------------------------------------------------
# hooks
# ---------------------------------------------------------------------------
def test_csv_display_and_tostring_hooks_match_reference(tmp_path, capsys):
    rows = [dict(x=1.0, y=np.float32(2.5), v=np.arange(3, dtype=np.float32)),
            dict(x=3.0, y=np.float32(-4.0), v=np.array([0.5], np.float32))]
    tens = [{k: torch.as_tensor(v) if k != "x" else v for k, v in r.items()}
            for r in rows]
    outs = {}
    for name, c, data in (("ref", jcore, rows), ("port", tcore, tens)):
        vals = [c.Val(k) for k in ("x", "y", "v")]
        csv_hook = c.CSVHook(str(tmp_path / name / "out.csv"), vals)
        seen = []
        show = c.ToStringHook(*vals, printer=seen.append)
        for r in data:
            csv_hook(c.Context(r))
            show(c.Context(r))
            c.DisplayHook("Generation ${x}: ${y} ${v}")(c.Context(r))
        outs[name] = ((tmp_path / name / "out.csv").read_text(), seen,
                      capsys.readouterr().out)
    assert outs["port"] == outs["ref"]
    assert outs["port"][0].splitlines()[0] == "x,y,v"


def test_checkpoint_hook_saves_every_nth_call(tmp_path):
    from repro_torch import checkpoint
    v = tcore.Val("state")
    hook = tcore.CheckpointHook(str(tmp_path), v, every=2)
    for i in range(5):
        hook(tcore.Context(state={"w": torch.full((2,), float(i))}))
    assert checkpoint.latest_step(str(tmp_path)) == 4
    back = checkpoint.restore(str(tmp_path), 2, {"w": torch.zeros(2)})
    assert torch.equal(back["w"], torch.full((2,), 2.0))


# ---------------------------------------------------------------------------
# the task cache
# ---------------------------------------------------------------------------
CALLS = []


def test_cache_hits_on_a_second_run_and_hooks_fire_on_hits():
    wf, roles, initial = _diamond(PKGS["port"])
    seen = []
    roles["left"].hook(tcore.ToStringHook(tcore.Val("y"),
                                          printer=seen.append))
    cache = tcore.TaskCache()
    first = wf.run(initial, cache=cache)
    assert wf.last_record.cache_hits == 0
    second = wf.run(initial, cache=cache)
    assert (wf.last_record.cache_hits, wf.last_record.cache_misses) == (5, 0)
    assert seen == ["y=4.0", "y=4.0"]
    _assert_roles_equal(first, roles, second, roles)
    serial = wf.run(initial, scheduler="serial")
    _assert_roles_equal(second, roles, serial, roles)
    wf.run({"x": 3.0}, cache=cache)
    assert wf.last_record.cache_hits == 0          # other inputs, no hit


def test_cache_hit_returns_the_tensor_of_the_miss():
    x = tcore.Val("x", float)
    t = _torch_task("t", lambda x: {"y": torch.arange(4, dtype=torch.float64)
                                    * x}, inputs=(x,),
                    outputs=(tcore.Val("y"),))
    cache = tcore.TaskCache()
    wf = tcore.Workflow("one")
    cap = wf.add(tcore.Capsule(t))
    miss = wf.run({"x": 2.0}, cache=cache)[cap][0]["y"]
    hit = wf.run({"x": 2.0}, cache=cache)[cap][0]["y"]
    assert wf.last_record.tasks[0].mode == "cache"
    assert hit.dtype == miss.dtype == torch.float64
    assert hit.device == miss.device and torch.equal(hit, miss)


def test_disk_cache_survives_a_restart(tmp_path):
    CALLS.clear()
    x, y = tcore.Val("x", float), tcore.Val("y")

    def expensive(x):
        CALLS.append(x)
        return {"y": torch.tensor([x + 1.0, x * 2.0])}

    def build():
        wf = tcore.Workflow("restart")
        return wf, wf.add(tcore.Capsule(_torch_task(
            "exp", expensive, inputs=(x,), outputs=(y,))))

    wf1, a1 = build()
    first = wf1.run({"x": 7.0}, cache=str(tmp_path))[a1][0]["y"]
    assert CALLS == [7.0]
    # a fresh workflow, capsule and cache object: only the directory is
    # left, and the firing is served from it
    wf2, a2 = build()
    again = wf2.run({"x": 7.0}, cache=str(tmp_path))[a2][0]["y"]
    assert CALLS == [7.0] and torch.equal(again, first)
    assert wf2.last_record.cache_hits == 1


def test_digests_separate_seeds_and_fingerprints_track_code():
    seed, x, y = tcore.Val("seed", int), tcore.Val("x", float), \
        tcore.Val("y", float)
    t = tcore.PyTask("m", lambda ctx: {"y": float(ctx["seed"] % 97)},
                     inputs=(seed,), outputs=(y,))
    assert len({inputs_digest(t, tcore.Context(seed=s))
                for s in range(20)}) == 20
    t1 = tcore.PyTask("f", lambda ctx: {"y": ctx["x"] + 1}, inputs=(x,),
                      outputs=(y,))
    t2 = tcore.PyTask("f", lambda ctx: {"y": ctx["x"] + 2}, inputs=(x,),
                      outputs=(y,))
    t3 = tcore.PyTask("f", lambda ctx: {"y": ctx["x"] + 1}, inputs=(x,),
                      outputs=(y,))
    assert fingerprint_task(t1) != fingerprint_task(t2)
    assert fingerprint_task(t1) != fingerprint_task(t1.set(x=3.0))
    assert fingerprint_task(t1) == fingerprint_task(t3)
    assert tcore.TaskCache is not None and len(tcore.DEFAULT_CACHE) >= 0


# ---------------------------------------------------------------------------
# provenance
# ---------------------------------------------------------------------------
def _provenance(pkg, tmp_path):
    p = PKGS[pkg]
    runnable, roles, initial = _cross_lanes(p)
    cache = p.core.TaskCache()
    records = []
    for i in range(2):
        path = tmp_path / f"{pkg}{i}.json"
        runnable.run(initial, cache=cache, provenance_path=str(path))
        records.append(json.loads(path.read_text()))
    return records


def test_provenance_schema_and_modes_equal_the_reference(tmp_path):
    ours, theirs = _provenance("port", tmp_path), \
        _provenance("reference", tmp_path)
    for a, b in zip(ours, theirs):
        assert set(a) == set(b)
        assert a["schema"] == b["schema"] == "repro-run-record/v1"
        assert (a["scheduler"], a["environment"], a["cache"]) == \
            (b["scheduler"], b["environment"], b["cache"])
        assert [set(t) for t in a["tasks"]] == [set(t) for t in b["tasks"]]
        assert sorted((t["task"], t["mode"], t["cache_hit"], t["retries"])
                      for t in a["tasks"]) == \
            sorted((t["task"], t["mode"], t["cache_hit"], t["retries"])
                   for t in b["tasks"])
    modes = [sorted({t["mode"] for t in r["tasks"]}) for r in ours]
    assert modes == [["lanes", "submit"], ["cache"]]
    assert ours[0]["cache"] == {"hits": 0, "misses": 8}


def test_provenance_counts_retries_and_async_errors_propagate():
    CALLS.clear()
    y = tcore.Val("y", float)

    def flaky(ctx):
        CALLS.append(1)
        if len(CALLS) < 3:
            raise IOError("transient")
        return {"y": 1.0}

    wf = tcore.Workflow("flaky")
    wf.add(tcore.Capsule(tcore.PyTask("flaky", flaky, outputs=(y,))))
    wf.run(environment=tcore.LocalEnvironment(retries=3, backoff_s=0.0))
    (rec,) = wf.last_record.tasks
    assert rec.retries == 2 and rec.task == "flaky"
    env = tcore.LocalEnvironment(retries=0, backoff_s=0.0)
    boom = tcore.Workflow("boom")
    boom.add(tcore.Capsule(tcore.PyTask("bad", lambda ctx: 1 / 0,
                                        outputs=(y,))))
    with pytest.raises(RuntimeError, match="failed after"):
        boom.run(environment=env, scheduler="async")
    lanes = tcore.Workflow("lanes")
    head = tcore.Capsule(tcore.PyTask("head", lambda ctx: {}))
    bad = tcore.Capsule(_torch_task("bad", lambda x: {}, inputs=(
        tcore.Val("x", float),), outputs=(y,)))
    lanes.connect(head, bad, kind="exploration", sampling=texplore
                  .GridSampling({tcore.Val("x", float): [1.0, 2.0]}))
    with pytest.raises(tcore.TaskError, match="missing outputs"):
        lanes.run(scheduler="async")


def test_async_overlaps_branches_and_serial_does_not():
    barrier = threading.Barrier(2)
    wf, roles, initial = _diamond(PKGS["port"], barrier=barrier)
    res = wf.run(initial, scheduler="async")
    assert res[roles["left"]][0]["y"] == 4.0 and not barrier.broken
    barrier = threading.Barrier(2)
    wf, roles, initial = _diamond(PKGS["port"], barrier=barrier,
                                  barrier_timeout=0.5)
    with pytest.raises(RuntimeError):
        wf.run(initial, tcore.LocalEnvironment(retries=0, backoff_s=0.0),
               scheduler="serial")
    assert barrier.broken


# ---------------------------------------------------------------------------
# the pool's lane-based map_explore
# ---------------------------------------------------------------------------
X, Y = tcore.Val("x", float), tcore.Val("y", float)
SQ = tcore.PyTask("sq", lambda ctx: {"y": ctx["x"] ** 2}, inputs=(X,),
                  outputs=(Y,))
SQ_T = _torch_task("sqt", lambda x: {"y": torch.tensor(x) ** 2},
                   inputs=(X,), outputs=(Y,))


def _faulty_pool(**kw):
    envs = [tcore.LocalEnvironment(
        name=f"w{i}", capacity=2,
        faults=tcore.FaultSpec(fail_rate=0.3, fail_limit=None, seed=i))
        for i in range(2)] + [tcore.LocalEnvironment(name="stable",
                                                     capacity=2)]
    return tcore.EnvironmentPool(envs, backoff_s=0.0, **kw)


@pytest.mark.parametrize("task", ["py", "torch"])
def test_pool_map_explore_equals_a_serial_map_under_failures(task):
    t = SQ if task == "py" else SQ_T
    ctxs = [tcore.Context(x=float(i)) for i in range(40)]
    expect = [c["y"] for c in tcore.LocalEnvironment().map_explore(t, ctxs)]
    pool = _faulty_pool(retries=8, lane_size=4)
    try:
        got = [c["y"] for c in pool.map_explore(t, ctxs)]
        assert [float(v) for v in got] == [float(v) for v in expect] \
            == [float(i) ** 2 for i in range(40)]
        snap = pool.stats.snapshot()
        assert snap["completed"] == 40 and snap["in_flight"] == 0
        assert snap["resubmissions"] > 0
        for name, s in pool.member_stats().items():
            assert s["submitted"] == (s["completed"] + s["failed"]
                                      + s["hung"] + s["corrupted"]), name
    finally:
        pool.shutdown()


def test_two_concurrent_fanouts_on_one_faulty_pool_stay_apart():
    pool = _faulty_pool(retries=12, speculative=2)
    xs = {"a": [float(i) for i in range(23)],
          "b": [float(100 + i) for i in range(9)]}
    results, errors = {}, []

    def fanout(key):
        try:
            outs = pool.map_explore(SQ, [tcore.Context(x=v) for v in xs[key]])
            results[key] = [o["y"] for o in outs]
        except Exception as e:              # surfaced after the join
            errors.append(e)

    try:
        threads = [threading.Thread(target=fanout, args=(k,)) for k in xs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads), "fan-outs hung"
        assert not errors, errors
        assert results == {k: [v ** 2 for v in xs[k]] for k in xs}
    finally:
        pool.shutdown()


def test_torch_fanout_goes_through_the_pool_as_lanes():
    pool = tcore.EnvironmentPool([tcore.LocalEnvironment(name="a"),
                                  tcore.LocalEnvironment(name="b")],
                                 backoff_s=0.0, lane_size=3)
    try:
        runnable, roles, initial = _cross_lanes(PKGS["port"])
        got = runnable.run(initial, pool)
        ref, ref_roles, _ = _run(_cross_lanes, "reference", "serial")
        _assert_roles_equal(ref, ref_roles, got, roles)
        modes = {r.mode for r in runnable.workflow.last_record.tasks
                 if r.task == "f"}
        assert modes == {"lanes"}
        # the six points of the fan-out, the head and the statistic
        assert pool.stats.snapshot()["completed"] == 8
    finally:
        pool.shutdown()


TASK_CASES = {
    "runs": (lambda: SQ.run(tcore.Context(x=3.0))["y"], 9.0),
    "defaults": (lambda: tcore.PyTask(
        "d", lambda ctx: {"y": ctx["x"] * 2}, inputs=(X,), outputs=(Y,),
        defaults={"x": 21.0}).set(x=1.0).run(tcore.Context())["y"], 2.0),
    "one_output_value": (lambda: float(_torch_task(
        "v", lambda x: x + 1, inputs=(X,), outputs=(Y,)).run(
            tcore.Context(x=1.0))["y"]), 2.0),
    "missing_input": (lambda: SQ.run(tcore.Context()), "missing inputs"),
    "missing_output": (lambda: tcore.PyTask(
        "bad", lambda ctx: {}, outputs=(Y,)).run(tcore.Context()),
        "missing outputs"),
    "value_for_two_outputs": (lambda: _torch_task(
        "two", lambda x: x, inputs=(X,), outputs=(Y, tcore.Val("z"))).run(
            tcore.Context(x=1.0)), "non-dict for 2 outputs"),
}


@pytest.mark.parametrize("case", sorted(TASK_CASES))
def test_task_contract(case):
    fn, expect = TASK_CASES[case]
    if isinstance(expect, str):
        with pytest.raises(tcore.TaskError, match=expect):
            fn()
    else:
        assert fn() == expect
